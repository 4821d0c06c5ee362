"""AMM-PGO*: Nesterov-accelerated MM with master-node aggregation, batched
over the node axis (torch port of dpgo_tpu/solvers/star.py).

Per-node accelerated proximal/TNT steps plus a *master* sequence F that
gates global fallbacks using the TRUE global objective:

  1. all nodes: amm step -> candidates Xkh (proximal) and Xkp (refined)
  2. if F(Xkh) insufficient vs F - psi |Xkh - Xk|^2: redo proximal without
     extrapolation (pm step)
  3. if F(Xkp) insufficient: fall back to MM steps from the Xkh rotations and
     halve the Nesterov parameter
  4. phi-test selects between the refined and proximal translations
  5. F <- (1 - eta0) F + eta0 F(Xkp)

There is no physical master: the global objective is an edge-sum over the
gathered candidate state. The three master decisions are scalars taken by
`utils.device_cond`: read on the host (`HostSyncs`) on the host route, IF
nodes of the captured step on the graph route; a fallback that does not
fire costs nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from dpgo_tpu_torch.losses import Loss
from dpgo_tpu_torch.manifold import proj_tangent
from dpgo_tpu_torch.problem import NodeProblem, NodeState, _nsum
from dpgo_tpu_torch.solvers.mm import (MMOptions, _eval_G_batch, _masked_tnt,
                                       resolve_preconditioner)
from dpgo_tpu_torch.utils import HostSyncs, bump_tensor, device_cond

# The master fallbacks, in the order iterate_star tests them.
FALLBACKS = ("pm", "mm", "phi")


@dataclasses.dataclass
class StarState:
    """Per-node state (leading node axis) + scalar master reference F."""

    Z: NodeState
    Z_prev: NodeState
    g_t: torch.Tensor
    g_R: torch.Tensor
    f: torch.Tensor
    fobj: torch.Tensor
    Df_t: torch.Tensor
    Df_R: torch.Tensor
    g_t_prev: torch.Tensor
    g_R_prev: torch.Tensor
    Df_t_prev: torch.Tensor
    Df_R_prev: torch.Tensor
    gradFnorm: torch.Tensor
    s: torch.Tensor
    s_next: torch.Tensor
    gamma: torch.Tensor
    F: torch.Tensor  # scalar master reference
    # Anchor residual halves at Z, cached by update_star (see mm.MMState).
    z_rt: torch.Tensor
    z_rR: torch.Tensor
    z_us: torch.Tensor
    z_Es: torch.Tensor

    def replace(self, **kw) -> "StarState":
        return dataclasses.replace(self, **kw)


def init_star_state(probs: NodeProblem, Z: NodeState, global_f) -> StarState:
    N, d = Z.t.shape[0], Z.t.shape[-1]
    dt, dev = Z.t.dtype, Z.t.device
    zeros = torch.zeros(N, dtype=dt, device=dev)
    z = torch.zeros_like
    m0, m1 = probs.a_i.shape[1], probs.e_self.shape[1]
    return StarState(
        Z=Z, Z_prev=Z, g_t=z(Z.t), g_R=z(Z.R), f=zeros, fobj=zeros,
        Df_t=z(Z.t), Df_R=z(Z.R), g_t_prev=z(Z.t), g_R_prev=z(Z.R),
        Df_t_prev=z(Z.t), Df_R_prev=z(Z.R), gradFnorm=zeros,
        s=torch.ones(N, dtype=dt, device=dev),
        s_next=torch.ones(N, dtype=dt, device=dev),
        gamma=zeros, F=torch.as_tensor(global_f, dtype=dt, device=dev),
        z_rt=torch.zeros((N, m0, d), dtype=dt, device=dev),
        z_rR=torch.zeros((N, m0, d, d), dtype=dt, device=dev),
        z_us=torch.zeros((N, m1, d), dtype=dt, device=dev),
        z_Es=torch.zeros((N, m1, d, d), dtype=dt, device=dev))


def update_star(probs: NodeProblem, st: StarState, opts: MMOptions,
                first: bool) -> StarState:
    """DPGOStar::update_n: direct (non-telescoped) surrogate anchors +
    Nesterov gamma."""
    g, f, fobj, zres = probs.surrogate_g_f_fobj_res(st.Z)
    Df = probs.euclidean_Df(st.Z, g=g)
    grad_t, grad_R = Df[0], proj_tangent(st.Z.R, Df[1], probs.kernels)
    gradFnorm = torch.sqrt(_nsum(grad_t * grad_t) + _nsum(grad_R * grad_R))

    if opts.accelerated:
        s0 = st.s if first else st.s_next
        s1 = 0.5 + 0.5 * torch.sqrt(4.0 * s0 * s0 + 1.0)
        gamma = (s0 - 1.0) / s1
    else:
        s0, s1, gamma = st.s, st.s_next, st.gamma

    return st.replace(
        g_t=g[0], g_R=g[1], f=f, fobj=fobj, Df_t=Df[0], Df_R=Df[1],
        g_t_prev=st.g_t if not first else g[0],
        g_R_prev=st.g_R if not first else g[1],
        Df_t_prev=st.Df_t if not first else Df[0],
        Df_R_prev=st.Df_R if not first else Df[1],
        gradFnorm=gradFnorm, s=s0, s_next=s1, gamma=gamma,
        z_rt=zres[0][0], z_rR=zres[0][1], z_us=zres[1][0], z_Es=zres[1][1])


def iterate_star(probs: NodeProblem, st: StarState, opts: MMOptions,
                 global_f_fn, k: int, syncs: HostSyncs | None = None,
                 fired: dict | None = None, reduce=None) -> StarState:
    """One master iteration (DPGOStar::iterate).

    global_f_fn(t_own [N, n0, d], R_own [N, n0, d, d]) -> scalar exact global
    objective of the stacked candidate states. `fired` (optional) counts
    the master fallbacks taken, by name (FALLBACKS): Python integers on the
    host route, or 0-d int64 tensors on the device, bumped in the branch
    (any route). `reduce` sums the
    psi-test's squared step over the processes that hold the other nodes
    (identity by default), so that every master decision is taken on
    global values."""
    syncs = syncs or HostSyncs()
    gamma = st.gamma

    def extrap(cur, prev):
        g = gamma.reshape((-1,) + (1,) * (cur.dim() - 1))
        return cur + g * (cur - prev)

    Y = NodeState(t=extrap(st.Z.t, st.Z_prev.t), R=extrap(st.Z.R, st.Z_prev.R),
                  th=extrap(st.Z.th, st.Z_prev.th),
                  Rh=extrap(st.Z.Rh, st.Z_prev.Rh))
    if probs.loss is Loss.TRIVIAL:
        g_t_ex = extrap(st.g_t, st.g_t_prev)
        g_R_ex = extrap(st.g_R, st.g_R_prev)
        Df_t_ex = extrap(st.Df_t, st.Df_t_prev)
        Df_R_ex = extrap(st.Df_R, st.Df_R_prev)
    else:
        g_t_ex, g_R_ex = probs.surrogate_g(Y)
        Df_t_ex, Df_R_ex = probs.euclidean_Df(Y, (g_t_ex, g_R_ex))

    refined = (st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta
    if opts.tnt.max_iterations <= 0 or opts.tnt.max_iterations_accepted <= 0:
        refined = torch.zeros_like(refined)

    zres = ((st.z_rt, st.z_rR), (st.z_us, st.z_Es))
    anchor = (st.Z.t, st.Z.R, st.fobj)
    precon_kind = resolve_preconditioner(probs, opts)

    # amm_pgo_n: proximal candidate Xkh + refined candidate Xkp.
    Xh_t, Xh_R = probs.proximal(Y, (Df_t_ex, Df_R_ex))
    tp = probs.recover_translations(Xh_R, g_t_ex, Y.t, syncs)
    G0 = _eval_G_batch(probs, st, tp, Xh_R, zres)
    Xp_t, Xp_R, _ = _masked_tnt(probs, tp, Xh_R, g_t_ex, g_R_ex, refined,
                                opts.tnt, G0, syncs, t_anchor=Y.t,
                                anchor=anchor, precon=precon_kind)

    def sqdiff(at, aR):
        sq = (torch.sum((at - st.Z.t) ** 2)
              + torch.sum((aR - st.Z.R) ** 2))
        return sq if reduce is None else reduce(sq)

    def hit(name):
        if fired is None:
            return
        if isinstance(fired.get(name), torch.Tensor):
            bump_tensor(fired[name])
        else:
            fired[name] = fired.get(name, 0) + 1

    # Master test 1: proximal candidates (psi-test on the true objective).
    fobjh = global_f_fn(Xh_t, Xh_R)

    def proximal_fallback():
        hit("pm")
        t, R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
        return t, R, global_f_fn(t, R)

    Xh_t, Xh_R, fobjh = device_cond(
        fobjh > st.F - opts.psi * sqdiff(Xh_t, Xh_R), proximal_fallback,
        lambda: (Xh_t, Xh_R, fobjh), syncs=syncs)

    # Master test 2: refined candidates; fall back to MM from the Xkh
    # rotations with Nesterov shrink.
    fobj = global_f_fn(Xp_t, Xp_R)

    def mm_fallback():
        hit("mm")
        t2 = probs.recover_translations(Xh_R, st.g_t, st.Z.t, syncs)
        G2 = _eval_G_batch(probs, st, t2, Xh_R, zres)
        t, R, _ = _masked_tnt(probs, t2, Xh_R, st.g_t, st.g_R, refined,
                              opts.tnt, G2, syncs, t_anchor=st.Z.t,
                              anchor=anchor, precon=precon_kind)
        return t, R, global_f_fn(t, R), torch.clamp(0.5 * st.s_next, min=1.0)

    Xp_t, Xp_R, fobj, s_next = device_cond(
        fobj > st.F - opts.psi * sqdiff(Xp_t, Xp_R), mm_fallback,
        lambda: (Xp_t, Xp_R, fobj, st.s_next), syncs=syncs)

    # phi-test: adopt the proximal rotations + re-solved translations.
    def phi_fallback():
        hit("phi")
        t = probs.recover_translations(Xh_R, st.g_t, st.Z.t, syncs)
        return t, Xh_R, global_f_fn(t, Xh_R)

    Xp_t, Xp_R, fobj = device_cond(
        (st.F - fobj) < opts.phi * (st.F - fobjh), phi_fallback,
        lambda: (Xp_t, Xp_R, fobj), syncs=syncs)

    F_new = st.F * (1 - opts.eta0) + fobj * opts.eta0
    Z_new = NodeState(t=Xp_t, R=Xp_R, th=st.Z.th, Rh=st.Z.Rh)
    return st.replace(Z=Z_new, Z_prev=st.Z, s_next=s_next, F=F_new)
