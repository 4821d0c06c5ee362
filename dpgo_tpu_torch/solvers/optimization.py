"""Generic optimization-library components (torch port of
dpgo_tpu/solvers/optimization.py).

The remaining solvers of the reference's header-only Optimization library
(C++/Optimization/include/Optimization):

- `gradient_descent`   — Riemannian gradient descent with Armijo
                         backtracking (Riemannian/GradientDescent.h)
- `lsqr` / `tnls_step` — LSQR least-squares Krylov solver and the
                         truncated-Newton least-squares step built on it
                         (Riemannian/TNLS.h, LinearAlgebra lsqr)
- `tnls`               — Riemannian truncated-Newton least squares
- `admm`               — scaled-dual ADMM for min f(x) + g(z)
                         s.t. A x + B z = c (Convex/ADMM.h)
- `proximal_gradient`  — (accelerated) proximal gradient / FISTA
                         (Convex/ProximalGradient.h)

Points and tangents are a tensor or a tuple of tensors (the JAX package's
pytrees). The JAX package runs each loop as a masked `lax.while_loop`; here
the loop's exit test is read on the host once per iteration (counted in
`syncs`), and each loop ends on the same tests after the same number of
iterations. The line search of `gradient_descent` tries the step sizes in
order and stops at the first acceptable one, which is the one the JAX
package selects from its batch of all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dpgo_tpu_torch.utils import HostSyncs


def _map(fn, *xs):
    """fn over the leaves of tensors or tuples of tensors."""
    if isinstance(xs[0], (tuple, list)):
        return tuple(fn(*leaves) for leaves in zip(*xs))
    return fn(*xs)


def _leaves(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _ip(a, b):
    return sum((x * y).sum() for x, y in zip(_leaves(a), _leaves(b)))


def _axpy(alpha, x, y):
    return _map(lambda a, b: b + alpha * a, x, y)


def _select(pred, a, b):
    return _map(lambda x, y: torch.where(pred, x, y), a, b)


# ---------------------------------------------------------------------------
# Riemannian gradient descent with backtracking Armijo line search.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GDParams:
    max_iterations: int = 100
    gradient_tolerance: float = 1e-6
    alpha0: float = 1.0
    shrink: float = 0.5
    sigma: float = 1e-4          # Armijo sufficient-decrease constant
    max_ls_iters: int = 20


def gradient_descent(objective: Callable, riemannian_grad: Callable,
                     retract: Callable, x0, params: GDParams = GDParams(),
                     syncs: HostSyncs | None = None):
    """Returns (x, fx, gradnorm, iters). An iteration whose gradient is
    below tolerance, or whose line search finds no step, ends the loop (and
    counts)."""
    syncs = syncs or HostSyncs()
    x, fx, k = x0, objective(x0), 0
    while k < params.max_iterations:
        g = riemannian_grad(x)
        gn2 = _ip(g, g)
        k += 1
        if syncs.flag(torch.sqrt(gn2) < params.gradient_tolerance):
            break
        for i in range(params.max_ls_iters):
            alpha = params.alpha0 * params.shrink ** i
            xc = retract(x, _map(lambda v: -alpha * v, g))
            fc = objective(xc)
            if syncs.flag(fc <= fx - params.sigma * alpha * gn2):
                x, fx = xc, fc
                break
        else:
            break
    g = riemannian_grad(x)
    return x, fx, torch.sqrt(_ip(g, g)), k


# ---------------------------------------------------------------------------
# LSQR (Paige & Saunders) for min |A x - b| with linear operators.
# ---------------------------------------------------------------------------


def lsqr(A: Callable, At: Callable, b, x_shape_like, max_iters: int = 100,
         atol: float = 1e-8, damp: float = 0.0, btol=None, Delta=None,
         return_info: bool = False, syncs: HostSyncs | None = None):
    """Golub-Kahan bidiagonalization least squares for min |A x - b|
    (+ optional Tikhonov damping `damp` and trust-region radius `Delta`).
    A/At are linear operators on tensors or tuples of tensors.

    Stopping mirrors the reference LSQR (IterativeSolvers.h:458-563):
      S1: |rbar| <= btol |b| + atol |A| |x|   (consistent systems)
      S2: |A' rbar| <= atol |A| |rbar|        (inconsistent systems)
    plus the trust region: LSQR's iterate norm increases monotonically, so
    the first step crossing |x| = Delta is truncated to the boundary and
    the solve stops (the Steihaug-Toint rule for least squares).

    Returns x, or (x, xnorm, iters) when return_info=True."""
    syncs = syncs or HostSyncs()
    beta0 = torch.sqrt(_ip(b, b))
    u = _map(lambda t: t / torch.clamp(beta0, min=1e-30), b)
    Atu = At(u)
    alpha = torch.sqrt(_ip(Atu, Atu))
    v = _map(lambda t: t / torch.clamp(alpha, min=1e-30), Atu)
    x = _map(torch.zeros_like, x_shape_like)
    w = v
    btol_v = atol if btol is None else btol
    rhobar, phibar, normA2 = alpha, beta0, alpha * alpha
    xnorm = torch.zeros_like(beta0)
    k = 0
    done = syncs.flag((alpha * beta0) == 0)
    while not done and k < max_iters:
        u = _axpy(-alpha, u, A(v))
        beta = torch.sqrt(_ip(u, u))
        u = _map(lambda t: t / torch.clamp(beta, min=1e-30), u)
        v_next = _axpy(-beta, v, At(u))
        alpha = torch.sqrt(_ip(v_next, v_next))
        v_next = _map(lambda t: t / torch.clamp(alpha, min=1e-30), v_next)
        # Damped rotation (regularization), then the standard Givens update.
        if damp > 0:
            rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
            phibar1 = phibar * (rhobar / rhobar1)
        else:
            rhobar1, phibar1 = rhobar, phibar
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        c = rhobar1 / rho
        s = beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1
        x_new = _axpy(phi / rho, w, x)
        w_new = _axpy(-theta / rho, w, v_next)
        normA2 = normA2 + beta * beta + alpha * alpha + damp * damp
        normA = torch.sqrt(normA2)
        xnorm = torch.sqrt(_ip(x_new, x_new))
        if Delta is not None:
            # Trust region: truncate the step to the |x| = Delta boundary
            # (xnorm is nondecreasing in LSQR, so crossing is final).
            Dt = torch.as_tensor(Delta, dtype=xnorm.dtype,
                                 device=xnorm.device)
            crossed = xnorm > Dt
            # |x_old + sigma dx| = Delta along dx = (phi/rho) w.
            dx = _map(lambda t: (phi / rho) * t, w)
            a2 = _ip(dx, dx)
            ab = _ip(x, dx)
            c2 = _ip(x, x) - Dt * Dt
            disc = torch.sqrt(torch.clamp(ab * ab - a2 * c2, min=0.0))
            sigma = (-ab + disc) / torch.clamp(a2, min=1e-30)
            x_new = _select(crossed, _axpy(sigma, dx, x), x_new)
            xnorm = torch.where(crossed, Dt, xnorm)
        else:
            crossed = torch.zeros((), dtype=torch.bool, device=xnorm.device)
        # |A' rbar| estimate = phibar * alpha * |c| (Paige & Saunders S2).
        s1 = torch.abs(phibar) <= btol_v * beta0 + atol * normA * xnorm
        s2 = phibar * alpha * torch.abs(c) <= atol * normA * \
            torch.clamp(torch.abs(phibar), min=1e-30)
        x, v, w = x_new, v_next, w_new
        k += 1
        done = syncs.flag(s1 | s2 | crossed)
    if return_info:
        return x, xnorm, k
    return x


def tnls_step(jacobian: Callable, jacobian_T: Callable, residual,
              x_like, max_iters: int = 100, damp: float = 0.0,
              syncs: HostSyncs | None = None):
    """One truncated-Newton least-squares step: solve min |J h + r| for the
    update h (the inner solve of tnls below)."""
    neg_r = _map(torch.neg, residual)
    return lsqr(jacobian, jacobian_T, neg_r, x_like, max_iters=max_iters,
                damp=damp, syncs=syncs)


# ---------------------------------------------------------------------------
# Riemannian truncated-Newton least squares (TNLS).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TNLSParams:
    """Mirrors the reference TNLSParams (Riemannian/TNLS.h:105-180):
    trust-region control identical to TNT's, inner solver LSQR with the
    Dembo-Eisenstat-Steihaug forcing sequence
    eta_k = min(|F(x)|^theta, kappa_fgr)."""

    max_iterations: int = 100
    max_lsqr_iterations: int = 100
    root_tolerance: float = 1e-9
    gradient_tolerance: float = 1e-8
    relative_decrease_tolerance: float = 1e-12
    stepsize_tolerance: float = 1e-10
    Delta_tolerance: float = 1e-10
    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    kappa_fgr: float = 0.1
    theta: float = 0.5
    lam: float = 0.0       # Tikhonov damping of the LSQR subproblem
    atol: float = 1e-10    # LSQR relative stopping tolerance


def tnls(F: Callable, jacobian: Callable, jacobian_T: Callable,
         retract: Callable, x0, params: TNLSParams = TNLSParams(),
         syncs: HostSyncs | None = None):
    """Riemannian truncated-Newton least squares: min_x L(x) = |F(x)| over
    a manifold, F mapping into a Euclidean space (the reference's
    Riemannian::TNLS, TNLS.h:244-700: trust-region outer loop, LSQR
    trust-region subproblem min_h |J_x h + F(x)| s.t. |h| <= Delta with
    the eta_k forcing term, gain ratio rho = (|F|^2 - |F(x+)|^2) /
    (|F|^2 - |J h + F|^2), TNT-style radius control).

    F(x) -> residual; jacobian(x, v) -> J_x v; jacobian_T(x, w) -> J_x' w
    (must return a TANGENT at x); retract(x, h) -> new point.

    Returns (x, Fx_norm, grad_norm, iters)."""
    syncs = syncs or HostSyncs()
    x = x0
    Fx = F(x0)
    Fx2 = _ip(Fx, Fx)
    Delta = torch.as_tensor(params.Delta0, dtype=Fx2.dtype,
                            device=Fx2.device)
    sqrt_eps = float(np.sqrt(torch.finfo(Fx2.dtype).eps))

    def grad_of(x, Fx, Fnorm):
        return _map(lambda t: t / torch.clamp(Fnorm, min=1e-30),
                    jacobian_T(x, Fx))

    k = 0
    while k < params.max_iterations:
        Fnorm = torch.sqrt(Fx2)
        gradL = grad_of(x, Fx, Fnorm)
        gn = torch.sqrt(_ip(gradL, gradL))
        k += 1
        if syncs.flag((Fnorm < params.root_tolerance)
                      | (gn < params.gradient_tolerance)):
            break

        # Inner subproblem: min_h |J h + Fx|, |h| <= Delta, forcing
        # btol = eta_k = min(|F|^theta, kappa_fgr) (Dembo et al.).
        etak = torch.clamp(Fnorm ** params.theta, max=params.kappa_fgr)
        xk = x
        h = lsqr(lambda v: jacobian(xk, v), lambda w: jacobian_T(xk, w),
                 _map(torch.neg, Fx), gradL,
                 max_iters=params.max_lsqr_iterations, atol=params.atol,
                 btol=etak, damp=params.lam, Delta=Delta, syncs=syncs)
        h_norm = torch.sqrt(_ip(h, h))

        x_prop = retract(x, h)
        Fp = F(x_prop)
        Fp2 = _ip(Fp, Fp)
        # Linearized residual r = J h + Fx; gain ratio on SQUARED norms.
        r = _axpy(1.0, jacobian(x, h), Fx)
        rho = (Fx2 - Fp2) / (Fx2 - _ip(r, r))
        finite = torch.isfinite(rho)
        accept = finite & (rho > params.eta1)

        rel_dec = (Fnorm - torch.sqrt(Fp2)) / (sqrt_eps + Fnorm)
        done = accept & ((rel_dec < params.relative_decrease_tolerance)
                         | (h_norm < params.stepsize_tolerance))
        Delta = torch.where(
            finite & (rho >= params.eta2),
            torch.maximum(params.alpha2 * h_norm, Delta),
            torch.where(finite & (rho > params.eta1), Delta,
                        params.alpha1 * h_norm))
        done = done | (Delta < params.Delta_tolerance)
        x = _select(accept, x_prop, x)
        Fx = _select(accept, Fp, Fx)
        Fx2 = torch.where(accept, Fp2, Fx2)
        if syncs.flag(done):
            break
    Fnorm = torch.sqrt(Fx2)
    gradL = grad_of(x, Fx, Fnorm)
    return x, Fnorm, torch.sqrt(_ip(gradL, gradL)), k


# ---------------------------------------------------------------------------
# ADMM (scaled dual) for min f(x) + g(z) s.t. A x + B z = c.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ADMMParams:
    rho: float = 1.0
    max_iterations: int = 200
    eps_primal: float = 1e-6
    eps_dual: float = 1e-6


def admm(prox_f: Callable, prox_g: Callable, A: Callable, B: Callable,
         c, x0, z0, params: ADMMParams = ADMMParams(),
         syncs: HostSyncs | None = None):
    """Generic ADMM (Convex/ADMM.h).

    prox_f(v, rho): argmin_x f(x) + rho/2 |A x + v|^2
    prox_g(v, rho): argmin_z g(z) + rho/2 |B z + v|^2
    Returns (x, z, u, iters). u is the scaled dual variable.
    """
    syncs = syncs or HostSyncs()
    rho = params.rho
    x, z, u = x0, z0, _map(torch.zeros_like, c)
    k = 0
    while k < params.max_iterations:
        Bz = B(z)
        x = prox_f(_map(lambda bz, cc, uu: bz - cc + uu, Bz, c, u), rho)
        Ax = A(x)
        z = prox_g(_map(lambda ax, cc, uu: ax - cc + uu, Ax, c, u), rho)
        Bz_new = B(z)
        r = _map(lambda ax, bz, cc: ax + bz - cc, Ax, Bz_new, c)
        u = _map(lambda uu, rr: uu + rr, u, r)
        sdiff = _map(lambda a, b: a - b, Bz_new, Bz)
        k += 1
        if syncs.flag((torch.sqrt(_ip(r, r)) < params.eps_primal)
                      & (rho * torch.sqrt(_ip(sdiff, sdiff))
                         < params.eps_dual)):
            break
    return x, z, u, k


# ---------------------------------------------------------------------------
# (Accelerated) proximal gradient / FISTA.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PGParams:
    step: float = 1.0             # 1/L
    max_iterations: int = 500
    accelerated: bool = True
    tol: float = 1e-10


def proximal_gradient(grad_f: Callable, prox_g: Callable, x0,
                      params: PGParams = PGParams(),
                      syncs: HostSyncs | None = None):
    """min f(x) + g(x): x <- prox_g(x - step grad_f(x), step), with Nesterov
    acceleration (Convex/ProximalGradient.h). Returns (x, iters)."""
    syncs = syncs or HostSyncs()
    step = params.step
    x = y = x0
    lead = _leaves(x0)[0]
    t = torch.ones((), dtype=lead.dtype, device=lead.device)
    k = 0
    while k < params.max_iterations:
        x_new = prox_g(_axpy(-step, grad_f(y), y), step)
        if params.accelerated:
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t ** 2))
            beta = (t - 1.0) / t_new
            y = _map(lambda xn, xo: xn + beta * (xn - xo), x_new, x)
            t = t_new
        else:
            y = x_new
        diff = _map(lambda a, b: a - b, x_new, x)
        x = x_new
        k += 1
        if syncs.flag(torch.sqrt(_ip(diff, diff)) < params.tol):
            break
    return x, k
