"""Riemannian truncated-Newton trust-region (TNT) with Steihaug-Toint
preconditioned truncated CG, batched over a leading node axis (torch port of
dpgo_tpu/solvers/tnt.py).

The JAX package runs one node's TNT as `lax.while_loop`s and vmaps it over the
node axis. Here every quantity carries the node axis N: the variable is a
tuple of [N, ...] tensors, tangent vectors are [N, ...] tensors (or, for the
coupled (t, R) model, tuples of them), and scalars are [N] tensors. Each lane
stops on its own condition and keeps its state after that (the vmapped
while_loop's semantics); the outer loop and the STPCG are
`utils.bounded_while`s: on the host route they read their continuation flag
on the host once per trip (`HostSyncs`), on the graph route they are WHILE
nodes of the captured step.

The global polish and the SE-Sync staircase solve one problem (x = (t, R) or
Y without a node axis): `tnt_one` runs such a model as a batch of one.

Instrumentation: `record=True` returns a TNTHistory of per-outer-iteration
(f, |grad|, |Pgrad|, Delta, inner CG iterations, step M-norm, rho, accepted)
ring buffers; `user_fn` is called on the host once per outer iteration and
lane with the same quantities, and its True return ends that lane's solve
(the reference's TNTUserFunction).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from dpgo_tpu_torch.ops.stpcg import ips, sel, stpcg_loop, stpcg_target
from dpgo_tpu_torch.utils import HostSyncs, bounded_while, current_route


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
    inner (optional): ((a, b), ...) -> per-lane inner products of each
        pair of batched tangents, taken together (`ops.stpcg.ips` when
        None). Every inner product and norm TNT and STPCG take over the
        variable goes through it; a variable split over processes sums
        them over the processes here.
    """

    objective: Callable
    grad_and_nabla: Callable
    hess_vp: Callable
    precondition: Callable
    retract: Callable
    fused_stpcg: Callable | None = None
    precon_spans_full_space: bool = True
    inner: Callable | None = None


class TNTHistory(NamedTuple):
    """Per-outer-iteration series, ring buffers [N, max_iterations] whose
    entries [:count] are valid (count [N] int32): the reference's TNTResult
    vectors."""

    fx: torch.Tensor          # objective BEFORE the iteration's step
    gradnorm: torch.Tensor
    pgradnorm: torch.Tensor
    Delta: torch.Tensor
    inner_iterations: torch.Tensor  # STPCG iteration count (int32)
    h_M_norm: torch.Tensor    # step norm in the preconditioner metric
    rho: torch.Tensor         # gain ratio
    accepted: torch.Tensor    # bool
    count: torch.Tensor


def _empty_history(N: int, m: int, dtype, dev) -> TNTHistory:
    def z(dt=dtype):
        return torch.zeros((N, m), dtype=dt, device=dev)

    return TNTHistory(fx=z(), gradnorm=z(), pgradnorm=z(), Delta=z(),
                      inner_iterations=z(torch.int32), h_M_norm=z(), rho=z(),
                      accepted=z(torch.bool),
                      count=torch.zeros(N, dtype=torch.int32, device=dev))


def _leaf(x) -> torch.Tensor:
    """The first tensor of a variable (a tensor or nested tuples of them)."""
    return _leaf(x[0]) if isinstance(x, tuple) else x


def stpcg(grad, hess_vp, precon, Delta, params: TNTParams, v0,
          active=None, syncs: HostSyncs | None = None, inner=ips):
    """Steihaug-Toint truncated preconditioned CG, batched.

    Returns (step, H @ step, step_M_norm, num_iterations), each with a
    leading node axis. `v0` = precon(grad); `active` [N] bool: False returns
    the zero step without iterating. `inner`: TNTModel.inner."""
    target = stpcg_target(grad, v0, params.kappa_fgr, params.theta, inner)
    return stpcg_loop(grad, hess_vp, precon, v0, Delta, target, active,
                      params.max_tCG_iterations, syncs, inner)


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
    hist: TNTHistory | None = None

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
            done=torch.where(pred, self.done, other.done),
            hist=(None if self.hist is None else TNTHistory(
                *(sel(pred, a, b) for a, b in zip(self.hist, other.hist)))))


def tnt_generic(model: TNTModel, x0, params: TNTParams,
                syncs: HostSyncs | None = None,
                lanes: torch.Tensor | None = None, record: bool = False,
                user_fn: Callable | None = None):
    """Run TNT from the batched variable x0, a tensor or a tuple of tensors
    with a leading node axis (TNT.h:422-640).

    `lanes` [N] bool marks the nodes whose result the caller keeps; the
    others are treated as finished from the start (the JAX package computes
    them and discards the result). Returns (x, fx, gradnorm, num_accepted),
    plus a TNTHistory as a fifth element when `record=True`.
    `user_fn(**stats) -> bool` is called on the host once per outer
    iteration of each lane that ran it, with keyword stats (k, fx, gradnorm,
    pgradnorm, Delta, inner_iterations, h_M_norm, rho, accepted, all 0-d
    numpy); True ends that lane's solve after the current iteration.
    """
    syncs = syncs or HostSyncs()
    leaf = _leaf(x0)
    dtype = leaf.dtype
    N = leaf.shape[0]
    dev = leaf.device
    sqrt_eps = torch.finfo(dtype).eps ** 0.5
    live = (torch.ones(N, dtype=torch.bool, device=dev) if lanes is None
            else lanes)
    inner = model.inner or ips

    def eval_at(x):
        fx = model.objective(x)
        grad, nabla = model.grad_and_nabla(x)
        pg = model.precondition(x, grad)
        gg, pp = inner(((grad, grad), (pg, pg)))
        return fx, grad, nabla, pg, torch.sqrt(gg), torch.sqrt(pp)

    fx0, grad0, nabla0, pg0, gn0, pgn0 = eval_at(x0)
    init = TNTState(
        x=x0, fx=fx0, grad=grad0, nabla=nabla0, pgrad=pg0, gradnorm=gn0,
        pgradnorm=pgn0,
        Delta=torch.full((N,), params.Delta0, dtype=dtype, device=dev),
        k=torch.zeros(N, dtype=torch.int32, device=dev),
        accepted=torch.zeros(N, dtype=torch.int32, device=dev),
        done=~live,
        hist=(_empty_history(N, max(params.max_iterations, 1), dtype, dev)
              if record else None))

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
            dm_est = 0.5 * inner(((st.grad, st.pgrad),))[0]
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
                st.Delta, params, v0=st.pgrad, active=active, syncs=syncs,
                inner=inner)
        hh, gh, hHh = inner(((h, h), (st.grad, h), (h, Hh)))
        h_norm = torch.sqrt(hh)

        x_prop = model.retract(st.x, h)
        fx_prop = model.objective(x_prop)
        dm = -gh - 0.5 * hHh
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

        hist = st.hist
        if record:
            # Lanes at k = max_iterations are not running; their write is
            # clamped in range and discarded by the caller's select.
            i = st.k.clamp(max=hist.fx.shape[1] - 1).long()[:, None]

            def upd(a, v):
                old = a.gather(1, i)[:, 0]
                return a.scatter(1, i, torch.where(keep, v.to(a.dtype),
                                                   old)[:, None])

            hist = TNTHistory(
                fx=upd(hist.fx, st.fx),
                gradnorm=upd(hist.gradnorm, st.gradnorm),
                pgradnorm=upd(hist.pgradnorm, st.pgradnorm),
                Delta=upd(hist.Delta, st.Delta),
                inner_iterations=upd(hist.inner_iterations, inner_k),
                h_M_norm=upd(hist.h_M_norm, h_M_norm),
                rho=upd(hist.rho, rho),
                accepted=upd(hist.accepted, took),
                count=hist.count + keep.to(torch.int32))

        if user_fn is not None:
            if current_route() != "host":
                raise ValueError("tnt_generic: user_fn reads every outer "
                                 "iteration on the host; it runs on the "
                                 "host route only")
            live_user = (keep & running).cpu().numpy()
            stats = dict(k=st.k, fx=fx_new, gradnorm=st.gradnorm,
                         pgradnorm=st.pgradnorm, Delta=Delta_new,
                         inner_iterations=inner_k, h_M_norm=h_M_norm,
                         rho=rho, accepted=took)
            stats = {n: v.cpu().numpy() for n, v in stats.items()}
            stop = np.zeros(N, dtype=bool)
            for a in np.flatnonzero(live_user):
                stop[a] = bool(user_fn(**{n: v[a] for n, v in
                                          stats.items()}))
            done = done | torch.as_tensor(stop, device=dev)

        return TNTState(
            x=sel(keep, x_new, st.x),
            fx=torch.where(keep, fx_new, st.fx),
            grad=st.grad, nabla=st.nabla, pgrad=st.pgrad,
            gradnorm=st.gradnorm, pgradnorm=st.pgradnorm,
            Delta=torch.where(keep, Delta_new, st.Delta),
            k=st.k + 1,
            accepted=st.accepted + took.to(torch.int32),
            done=done, hist=hist)

    def body(st: TNTState, running: torch.Tensor) -> TNTState:
        # Iterations >= 2 refresh the derivatives of the current iterate
        # (stale after an accepted step; a no-op after a rejection).
        grad_r, nabla_r = model.grad_and_nabla(st.x)
        pg_r = model.precondition(st.x, grad_r)
        gg, pp = inner(((grad_r, grad_r), (pg_r, pg_r)))
        st = dataclasses.replace(
            st, grad=grad_r, nabla=nabla_r, pgrad=pg_r,
            gradnorm=torch.sqrt(gg), pgradnorm=torch.sqrt(pp))
        return step_core(st, running)

    if params.max_iterations <= 0 or params.max_iterations_accepted <= 0:
        out = init
    else:
        # The first iteration is peeled and reuses the init evaluation.
        out = step_core(init, live)
        out.done = out.done | ~live

        def running_lanes(o: TNTState) -> torch.Tensor:
            return (~o.done & (o.k < params.max_iterations)
                    & (o.accepted < params.max_iterations_accepted))

        out = bounded_while(
            params.max_iterations, running_lanes,
            lambda o, running: body(o, running).select(running, o), out,
            syncs=syncs, name="tnt")
    if record:
        return out.x, out.fx, out.gradnorm, out.accepted, out.hist
    return out.x, out.fx, out.gradnorm, out.accepted


def tnt(model: TNTModel, t0, R0, params: TNTParams,
        syncs: HostSyncs | None = None, lanes: torch.Tensor | None = None):
    """DPGO-shaped entry: variable (t, R); returns (t, R, fx, gradnorm,
    num_accepted)."""
    x, fx, gn, acc = tnt_generic(model, (t0, R0), params, syncs=syncs,
                                 lanes=lanes)
    return x[0], x[1], fx, gn, acc


# ----------------------------------------------------- single problems


def _add_axis(x):
    if isinstance(x, tuple):
        return tuple(_add_axis(u) for u in x)
    return x[None]


def _strip_axis(x):
    if isinstance(x, tuple):
        return tuple(_strip_axis(u) for u in x)
    return x[0]


def _batch_of_one(model: TNTModel) -> TNTModel:
    """A model over one problem (variable and tangents: tensors or tuples of
    tensors without a node axis, objective a 0-d tensor) as a model over a
    batch of one."""
    def objective(x):
        return model.objective(_strip_axis(x)).reshape(1)

    def grad_and_nabla(x):
        return _add_axis(model.grad_and_nabla(_strip_axis(x)))

    def hess_vp(x, nabla, v):
        return _add_axis(model.hess_vp(_strip_axis(x), _strip_axis(nabla),
                                       _strip_axis(v)))

    def precondition(x, v):
        return _add_axis(model.precondition(_strip_axis(x), _strip_axis(v)))

    def retract(x, h):
        return _add_axis(model.retract(_strip_axis(x), _strip_axis(h)))

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract,
                    precon_spans_full_space=model.precon_spans_full_space,
                    inner=model.inner)


def tnt_one(model: TNTModel, x0, params: TNTParams,
            syncs: HostSyncs | None = None, record: bool = False,
            user_fn: Callable | None = None):
    """tnt_generic on one problem (`_batch_of_one`): returns (x, fx,
    gradnorm, num_accepted) without the node axis, plus the TNTHistory
    ([max_iterations] buffers, 0-d count) when `record=True`."""
    out = tnt_generic(_batch_of_one(model), _add_axis(x0), params,
                      syncs=syncs, record=record, user_fn=user_fn)
    out = (_strip_axis(out[0]),) + tuple(v[0] for v in out[1:4]) + (
        (TNTHistory(*(v[0] for v in out[4])),) if record else ())
    return out
