"""Riemannian truncated-Newton trust-region (TNT) with Steihaug-Toint
preconditioned truncated CG, batched over a leading node axis (torch port of
dpgo_tpu/solvers/tnt.py).

The JAX package runs one node's TNT as `lax.while_loop`s and vmaps it over the
node axis. Here every quantity carries the node axis N: the variable is a
tuple of [N, ...] tensors, tangent vectors are [N, ...] tensors (or, for the
coupled (t, R) model, tuples of them), and scalars are [N] tensors. Each lane
stops on its own condition and keeps its state after that (the vmapped
while_loop's semantics); the loops run in Python and read their continuation
flag on the host once per trip (`HostSyncs`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from dpgo_tpu_torch.ops.stpcg import ip, sel, stpcg_loop, stpcg_target
from dpgo_tpu_torch.utils import HostSyncs


@dataclasses.dataclass(frozen=True)
class TNTParams:
    """Optimization::Riemannian::TNTParams defaults with the dist_pgo driver
    overrides (the JAX package's TNTParams)."""

    gradient_tolerance: float = 1e-3
    preconditioned_gradient_tolerance: float = 1e-4
    relative_decrease_tolerance: float = 1e-6
    stepsize_tolerance: float = 1e-4
    Delta_tolerance: float = 1e-6
    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_iterations: int = 10
    max_iterations_accepted: int = 1
    max_tCG_iterations: int = 250
    kappa_fgr: float = 0.05
    theta: float = 0.9
    # Noise-floor gate (see step_core): stop refining when the first CG
    # step's preconditioned model-decrease estimate 1/2 g^T P g falls below
    # objective-evaluation noise. None derives it from the model's
    # `precon_spans_full_space`; True / False override.
    noise_floor_gate: bool | None = None


class TNTModel(NamedTuple):
    """Problem closures for TNT (functions of batched tensors).

    objective(x) -> [N] value
    grad_and_nabla(x) -> (riemannian_grad, euclidean_nabla) tangents
    hess_vp(x, nabla, v) -> tangent
    precondition(x, v) -> tangent
    retract(x, v) -> new variable
    fused_stpcg (optional): (x, nabla, grad, pgrad, Delta, active) ->
        (h, Hh, h_M_norm, inner_iterations), a single-launch trust-region
        subproblem solver with the semantics of `stpcg` (kernel K1).
    precon_spans_full_space: False when `precondition` omits part of the
        tangent space; it turns the noise-floor gate off, whose estimate
        1/2 g^T P g is a noise proxy only for a full-span preconditioner.
    """

    objective: Callable
    grad_and_nabla: Callable
    hess_vp: Callable
    precondition: Callable
    retract: Callable
    fused_stpcg: Callable | None = None
    precon_spans_full_space: bool = True


def stpcg(grad, hess_vp, precon, Delta, params: TNTParams, v0,
          active=None, syncs: HostSyncs | None = None):
    """Steihaug-Toint truncated preconditioned CG, batched.

    Returns (step, H @ step, step_M_norm, num_iterations), each with a
    leading node axis. `v0` = precon(grad); `active` [N] bool: False returns
    the zero step without iterating."""
    target = stpcg_target(grad, v0, params.kappa_fgr, params.theta)
    return stpcg_loop(grad, hess_vp, precon, v0, Delta, target, active,
                      params.max_tCG_iterations, syncs)


@dataclasses.dataclass
class TNTState:
    x: tuple
    fx: torch.Tensor
    grad: torch.Tensor
    nabla: torch.Tensor
    pgrad: torch.Tensor
    gradnorm: torch.Tensor
    pgradnorm: torch.Tensor
    Delta: torch.Tensor
    k: torch.Tensor
    accepted: torch.Tensor
    done: torch.Tensor

    def select(self, pred: torch.Tensor, other: "TNTState") -> "TNTState":
        """Per lane: self where pred, else other."""
        return TNTState(
            x=sel(pred, self.x, other.x),
            fx=torch.where(pred, self.fx, other.fx),
            grad=sel(pred, self.grad, other.grad),
            nabla=sel(pred, self.nabla, other.nabla),
            pgrad=sel(pred, self.pgrad, other.pgrad),
            gradnorm=torch.where(pred, self.gradnorm, other.gradnorm),
            pgradnorm=torch.where(pred, self.pgradnorm, other.pgradnorm),
            Delta=torch.where(pred, self.Delta, other.Delta),
            k=torch.where(pred, self.k, other.k),
            accepted=torch.where(pred, self.accepted, other.accepted),
            done=torch.where(pred, self.done, other.done))


def tnt_generic(model: TNTModel, x0: tuple, params: TNTParams,
                syncs: HostSyncs | None = None,
                lanes: torch.Tensor | None = None):
    """Run TNT from the batched variable x0 (TNT.h:422-640).

    `lanes` [N] bool marks the nodes whose result the caller keeps; the
    others are treated as finished from the start (the JAX package computes
    them and discards the result). Returns (x, fx, gradnorm, num_accepted).
    """
    syncs = syncs or HostSyncs()
    dtype = x0[0].dtype
    N = x0[0].shape[0]
    dev = x0[0].device
    sqrt_eps = torch.finfo(dtype).eps ** 0.5
    live = (torch.ones(N, dtype=torch.bool, device=dev) if lanes is None
            else lanes)

    def eval_at(x):
        fx = model.objective(x)
        grad, nabla = model.grad_and_nabla(x)
        gradnorm = torch.sqrt(ip(grad, grad))
        pg = model.precondition(x, grad)
        pgradnorm = torch.sqrt(ip(pg, pg))
        return fx, grad, nabla, pg, gradnorm, pgradnorm

    fx0, grad0, nabla0, pg0, gn0, pgn0 = eval_at(x0)
    init = TNTState(
        x=x0, fx=fx0, grad=grad0, nabla=nabla0, pgrad=pg0, gradnorm=gn0,
        pgradnorm=pgn0,
        Delta=torch.full((N,), params.Delta0, dtype=dtype, device=dev),
        k=torch.zeros(N, dtype=torch.int32, device=dev),
        accepted=torch.zeros(N, dtype=torch.int32, device=dev),
        done=~live)

    def step_core(st: TNTState, running: torch.Tensor) -> TNTState:
        # Noise-floor guard: the first CG step's model decrease is
        # ~ 1/2 g^T P g; below the working precision's objective-evaluation
        # noise, accept/reject gain ratios are coin flips, so stop refining.
        # Inactive in f64, where the floor is ~1e-14 |f|; off for a model
        # whose preconditioner omits part of the tangent space.
        grad_small = ((st.gradnorm < params.gradient_tolerance)
                      | (st.pgradnorm
                         < params.preconditioned_gradient_tolerance))
        gate_on = (model.precon_spans_full_space
                   if params.noise_floor_gate is None
                   else params.noise_floor_gate)
        if gate_on:
            dm_est = 0.5 * ip(st.grad, st.pgrad)
            noise_floor = 16.0 * torch.finfo(dtype).eps \
                * (1.0 + st.fx.abs())
            grad_small = grad_small | (dm_est < noise_floor)

        # Lanes outside `running` are discarded by the caller, so their CG
        # is skipped (zero step).
        active = running & ~grad_small
        if model.fused_stpcg is not None:
            h, Hh, h_M_norm, inner_k = model.fused_stpcg(
                st.x, st.nabla, st.grad, st.pgrad, st.Delta, active)
        else:
            h, Hh, h_M_norm, inner_k = stpcg(
                st.grad,
                lambda v: model.hess_vp(st.x, st.nabla, v),
                lambda v: model.precondition(st.x, v),
                st.Delta, params, v0=st.pgrad, active=active, syncs=syncs)
        h_norm = torch.sqrt(ip(h, h))

        x_prop = model.retract(st.x, h)
        fx_prop = model.objective(x_prop)
        dm = -ip(st.grad, h) - 0.5 * ip(h, Hh)
        df = st.fx - fx_prop
        rel_decrease = df / (sqrt_eps + st.fx.abs())
        rho = df / dm
        step_ok = (~torch.isnan(rho)) & (rho > params.eta1)

        # Derivatives of the accepted point are refreshed at the start of
        # the next iteration (body), never here.
        x_new = sel(step_ok, x_prop, st.x)
        fx_new = torch.where(step_ok, fx_prop, st.fx)

        stop_rel = step_ok & (rel_decrease
                              < params.relative_decrease_tolerance)
        stop_step = step_ok & (h_norm < params.stepsize_tolerance)

        very_ok = (~torch.isnan(rho)) & (rho >= params.eta2)
        Delta_up = torch.maximum(params.alpha2 * h_M_norm, st.Delta)
        Delta_down = params.alpha1 * h_M_norm
        Delta_new = torch.where(very_ok, Delta_up,
                                torch.where(step_ok, st.Delta, Delta_down))
        stop_delta = (~step_ok) & (Delta_new < params.Delta_tolerance)

        keep = ~grad_small
        took = keep & step_ok
        done = grad_small | stop_rel | stop_step | stop_delta
        return TNTState(
            x=sel(keep, x_new, st.x),
            fx=torch.where(keep, fx_new, st.fx),
            grad=st.grad, nabla=st.nabla, pgrad=st.pgrad,
            gradnorm=st.gradnorm, pgradnorm=st.pgradnorm,
            Delta=torch.where(keep, Delta_new, st.Delta),
            k=st.k + 1,
            accepted=st.accepted + took.to(torch.int32),
            done=done)

    def body(st: TNTState, running: torch.Tensor) -> TNTState:
        # Iterations >= 2 refresh the derivatives of the current iterate
        # (stale after an accepted step; a no-op after a rejection).
        grad_r, nabla_r = model.grad_and_nabla(st.x)
        pg_r = model.precondition(st.x, grad_r)
        st = dataclasses.replace(
            st, grad=grad_r, nabla=nabla_r, pgrad=pg_r,
            gradnorm=torch.sqrt(ip(grad_r, grad_r)),
            pgradnorm=torch.sqrt(ip(pg_r, pg_r)))
        return step_core(st, running)

    if params.max_iterations <= 0 or params.max_iterations_accepted <= 0:
        out = init
    else:
        # The first iteration is peeled and reuses the init evaluation.
        out = step_core(init, live)
        out.done = out.done | ~live
        while True:
            running = (~out.done & (out.k < params.max_iterations)
                       & (out.accepted < params.max_iterations_accepted))
            if not syncs.flag(running.any()):
                break
            out = body(out, running).select(running, out)
    return out.x, out.fx, out.gradnorm, out.accepted


def tnt(model: TNTModel, t0, R0, params: TNTParams,
        syncs: HostSyncs | None = None, lanes: torch.Tensor | None = None):
    """DPGO-shaped entry: variable (t, R); returns (t, R, fx, gradnorm,
    num_accepted)."""
    x, fx, gn, acc = tnt_generic(model, (t0, R0), params, syncs=syncs,
                                 lanes=lanes)
    return x[0], x[1], fx, gn, acc
