"""Steihaug-Toint truncated preconditioned CG, batched over a leading node
axis: the plain PyTorch version of kernel K1 (`ops/stpcg_cuda.py`,
`csrc/stpcg.cu`).

`stpcg_loop` is the CG itself on closures, shared with the generic
`solvers/tnt.py::stpcg`. `stpcg_dense_reference` is the dense per-node solve
that K1 computes (and that dpgo_tpu/ops/pallas_stpcg.py::_stpcg_kernel
computed on the TPU), in tall [n d, d] storage:

    hess(v)   = proj(Hred v - S_p v_p)     per pose block p
    precon(v) = proj(P v)
    proj(v)   = v - sym(Q_p V_p^T) Q_p

The exits and the order of the scalar updates follow dpgo_tpu/solvers/tnt.py
stpcg: trust-region boundary, negative curvature, Hessian kernel, and the
forcing target r0 min(kappa, r0^theta). Each lane stops on its own condition
and keeps its state after that, as under the JAX package's vmapped
`lax.while_loop`; an inactive lane returns a zero step with k = 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from dpgo_tpu_torch.utils import HostSyncs, bounded_while


def _bshape(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, ...] broadcastable against ref."""
    return x.reshape(x.shape + (1,) * (ref.dim() - 1))


def ip(a, b) -> torch.Tensor:
    """Per-lane Frobenius inner product: [N, ...] x [N, ...] -> [N]; of a
    tuple of such tensors (the coupled (t, R) tangents), the sum over its
    parts."""
    if isinstance(a, tuple):
        return sum(ip(x, y) for x, y in zip(a, b))
    return (a * b).reshape(a.shape[0], -1).sum(1)


def ips(pairs) -> tuple:
    """Per-lane inner products of several (a, b) pairs: the default of the
    `inner` hook that TNT and `stpcg_loop` take every inner product and
    norm over the variable through. A model whose variable is split over
    processes passes a hook that sums each local product over them, all of
    one call's scalars in one collective."""
    return tuple(ip(a, b) for a, b in pairs)


def sel(pred: torch.Tensor, a, b):
    """Per lane: a where pred [N], else b (tensors or tuples of them)."""
    if isinstance(a, tuple):
        return tuple(sel(pred, x, y) for x, y in zip(a, b))
    return torch.where(_bshape(pred, a), a, b)


def axpy(alpha: torch.Tensor, x, y):
    """y + alpha x with a per-lane alpha [N] (tensors or tuples of them)."""
    if isinstance(x, tuple):
        return tuple(axpy(alpha, u, v) for u, v in zip(x, y))
    return y + _bshape(alpha, x) * x


def _neg(x):
    return tuple(-u for u in x) if isinstance(x, tuple) else -x


def _zeros_like(x):
    if isinstance(x, tuple):
        return tuple(torch.zeros_like(u) for u in x)
    return torch.zeros_like(x)


def stpcg_target(g: torch.Tensor, v0: torch.Tensor, kappa_fgr: float,
                 theta: float, inner: Callable = ips) -> torch.Tensor:
    """Forcing target r0 min(kappa, r0^theta), r0 = sqrt(<g, P g>)."""
    r0_norm = torch.sqrt(inner(((g, v0),))[0])
    return r0_norm * torch.clamp(r0_norm ** theta, max=kappa_fgr)


def stpcg_loop(grad, hess_vp: Callable, precon: Callable,
               v0, Delta: torch.Tensor, target: torch.Tensor,
               active: torch.Tensor | None, max_iters: int,
               syncs: HostSyncs | None = None, inner: Callable = ips):
    """Batched STPCG from r = grad, v = v0 = precon(grad); tangents are
    [N, ...] tensors or tuples of them. `inner` takes every inner product
    (`ips`): per iteration one call after the Hessian product and one
    after the preconditioner.

    Returns (step, H step, step M-norm, iterations) per lane."""
    syncs = syncs or HostSyncs()
    eps = 1e-8
    (r0v0,) = inner(((grad, v0),))
    r0_norm = torch.sqrt(r0v0)
    Delta2 = Delta * Delta

    s = _zeros_like(grad)
    Hs = _zeros_like(grad)
    r, v, p = grad, v0, _neg(v0)
    sk_M_pk = torch.zeros_like(r0v0)
    sk_M_2 = torch.zeros_like(r0v0)
    pk_M_2 = r0v0
    k = torch.zeros_like(r0v0, dtype=torch.int32)
    done = (r0_norm <= target) | (r0_norm == 0.0)
    if active is not None:
        done = done | ~active
    norm_out = torch.zeros_like(r0v0)

    def running_lanes(c):
        return ~c[9] & (c[8] < max_iters)

    def trip(c, running):
        s, Hs, r, v, p, sk_M_pk, sk_M_2, pk_M_2, k, done, norm_out = c
        Hp = hess_vp(p)
        kappa_k, pp, HpHp, pr, rv = inner(((p, Hp), (p, p), (Hp, Hp),
                                           (p, r), (r, v)))
        p_norm = torch.sqrt(pp)
        Hp_norm = torch.sqrt(HpHp)
        in_kernel = Hp_norm < eps * p_norm

        def sigma_of(smp):
            disc = smp * smp + pk_M_2 * (Delta2 - sk_M_2)
            return (-smp + torch.sqrt(torch.clamp(disc, min=0.0))) / pk_M_2

        # Kernel exit: follow p (sign-fixed to descent) to the boundary.
        p_desc = torch.where(pr < 0, -1.0, 1.0).to(r0v0.dtype)
        sig_k = sigma_of(sk_M_pk * p_desc) * p_desc
        s_kernel = axpy(sig_k, p, s)
        Hs_kernel = axpy(sig_k, Hp, Hs)

        alpha = rv / kappa_k
        sk1_M_2 = sk_M_2 + 2 * alpha * sk_M_pk + alpha * alpha * pk_M_2
        bad = (kappa_k <= 0) | (sk1_M_2 > Delta2)
        sig_b = sigma_of(sk_M_pk)
        s_boundary = axpy(sig_b, p, s)
        Hs_boundary = axpy(sig_b, Hp, Hs)

        # Interior CG update.
        s_new = axpy(alpha, p, s)
        Hs_new = axpy(alpha, Hp, Hs)
        r_new = axpy(alpha, Hp, r)
        v_new = precon(r_new)
        (rv_new,) = inner(((r_new, v_new),))
        beta = rv_new / (alpha * kappa_k)
        sk_M_pk_new = beta * (sk_M_pk + alpha * pk_M_2)
        pk_M_2_new = rv_new + beta * beta * pk_M_2
        p_new = axpy(beta, p, _neg(v_new))
        interior_done = torch.sqrt(rv_new) <= target

        exit_b = in_kernel | bad
        s_exit = sel(in_kernel, s_kernel, s_boundary)
        Hs_exit = sel(in_kernel, Hs_kernel, Hs_boundary)

        # A lane that is not running keeps its state (vmapped while_loop).
        go = running & ~exit_b
        return (sel(running, sel(exit_b, s_exit, s_new), s),
                sel(running, sel(exit_b, Hs_exit, Hs_new), Hs),
                sel(go, r_new, r), sel(go, v_new, v), sel(go, p_new, p),
                torch.where(go, sk_M_pk_new, sk_M_pk),
                torch.where(go, sk1_M_2, sk_M_2),
                torch.where(go, pk_M_2_new, pk_M_2),
                k + running.to(torch.int32),
                torch.where(running, exit_b | interior_done, done),
                torch.where(running & exit_b, Delta, norm_out))

    (s, Hs, _, _, _, _, sk_M_2, _, k, _, norm_out) = bounded_while(
        max_iters, running_lanes, trip,
        (s, Hs, r, v, p, sk_M_pk, sk_M_2, pk_M_2, k, done, norm_out),
        syncs=syncs, name="stpcg")
    norm = torch.where(norm_out > 0, norm_out, torch.sqrt(sk_M_2))
    return s, Hs, norm, k


def _proj_tall(Q: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """V - sym(Q_p V_p^T) Q_p per [d, d] block of tall [N, n d, d]."""
    N, nd, d = Q.shape
    Qb = Q.reshape(N, -1, d, d)
    Vb = V.reshape(N, -1, d, d)
    T = Qb @ Vb.transpose(-1, -2)
    T = 0.5 * (T + T.transpose(-1, -2))
    return V - (T @ Qb).reshape(N, nd, d)


def stpcg_dense_reference(H: torch.Tensor, P: torch.Tensor, g: torch.Tensor,
                          v0: torch.Tensor, Q: torch.Tensor, S: torch.Tensor,
                          Delta: torch.Tensor, active: torch.Tensor,
                          target: torch.Tensor, max_iters: int,
                          syncs: HostSyncs | None = None):
    """The dense per-node STPCG of kernel K1, batched over N nodes.

    H, P: [N, nd, nd] reduced Hessian and preconditioner; g, v0, Q, S:
    [N, nd, d] gradient, preconditioned gradient, iterate and curvature
    blocks sym(Q_p nabla_p^T) in tall storage; Delta, active, target: [N].
    Returns (h, H h [N, nd, d], |h|_M [N], k [N] int32)."""
    N, nd, d = g.shape
    Sb = S.reshape(N, -1, d, d)

    def hess(v):
        corr = (Sb @ v.reshape(N, -1, d, d)).reshape(N, nd, d)
        return _proj_tall(Q, H @ v - corr)

    def precon(v):
        return _proj_tall(Q, P @ v)

    return stpcg_loop(g, hess, precon, v0, Delta, target, active, max_iters,
                      syncs)


def stpcg_fused_reference(H, P, g, v0, Q, S, Delta, active, *,
                          max_iters: int, kappa_fgr: float, theta: float,
                          syncs: HostSyncs | None = None):
    """`stpcg_dense_reference` with the forcing target computed from
    (g, v0): the plain version of `stpcg_cuda.stpcg_fused`'s interface."""
    target = stpcg_target(g, v0, kappa_fgr, theta)
    return stpcg_dense_reference(H, P, g, v0, Q, S, Delta, active, target,
                                 max_iters, syncs)
