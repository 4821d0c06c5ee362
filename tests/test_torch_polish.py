"""The port's global polish (solvers/polish.py, DPGOSolver.polish), its TNT
recording mode and the refinement probe (refine_stats) against the JAX
package, on the CPU in float64 (graphs of 60 poses, 4 nodes)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

# STPCG cap of the polish cases: the CG of two packages parts by rounding
# that grows with its iterations (the coupled-model finding of the segment
# tests). On the 60-pose graph the two first part at 20 iterations of one
# solve (2f 5e-8 apart after 1e-12 at 18); at 12 they agree to 1e-12.
TCG = 12
OUTER = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(d):
    meas, _, _ = random_pose_graph(np.random.default_rng(5), num_poses=60,
                                   d=d, loop_closures=40, noise=0.05)
    return meas


@functools.lru_cache(maxsize=None)
def _start(d):
    """Global (t, R) after 10 AMM-PGO# steps of the JAX solver (4 nodes)."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    s = DPGOSolver(_graph(d), num_nodes=4, opts=MMOptions(),
                   dtype=jnp.float64)
    st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), 10)
    return tuple(np.asarray(x) for x in s.gather_global(st))


def _solvers(d, num_nodes=4, **kw):
    """(JAX solver, port solver) with the refinement off, as the JAX
    package's polish tests build them."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOpts
    from dpgo_tpu.solvers.tnt import TNTParams as JParams

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    js = JSolver(_graph(d), num_nodes=num_nodes,
                 opts=JOpts(tnt=JParams(max_iterations=0)),
                 dtype=jnp.float64, **kw)
    ts = DPGOSolver(_torch_meas(_graph(d)), num_nodes=num_nodes,
                    opts=MMOptions(tnt=TNTParams(max_iterations=0)),
                    dtype=torch.float64, device="cpu", **kw)
    return js, ts


def _polish_both(d, num_nodes=4, solver_kw=None, **polish_kw):
    js, ts = _solvers(d, num_nodes, **(solver_kw or {}))
    t0, R0 = _start(d)
    jst, jf = js.polish(js.initialize(t0, R0), outer=OUTER, tcg=TCG,
                        **polish_kw)
    tst, tf = ts.polish(ts.initialize(t0, R0), outer=OUTER, tcg=TCG,
                        **polish_kw)
    jt, jR = (np.asarray(x) for x in js.gather_global(jst))
    tt, tR = (x.numpy() for x in ts.gather_global(tst))
    f_start = float(ts._metrics(ts.initialize(t0, R0))[0])
    return (jf, jt, jR), (tf, tt, tR), f_start, ts


def _assert_same_polish(j, t, f_start):
    jf, jt, jR = j
    tf, tt, tR = t
    assert tf < f_start
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    np.testing.assert_allclose(tt, jt, atol=1e-8)
    np.testing.assert_allclose(tR, jR, atol=1e-8)


@pytest.mark.parametrize("d,case", [(3, "node"), (3, "coarse"),
                                    (3, "segments"), (2, "coarse")])
def test_polish_matches_jax(d, case):
    """DPGOSolver.polish from the same state (10 AMM-PGO# steps) in both
    packages: 2f within rtol 1e-9, t and R within atol 1e-8; with the
    node-block preconditioner alone, with the rigid coarse level, and with
    a further contiguous-segment level (8 segments)."""
    kw = {"node": dict(coarse=False), "coarse": dict(coarse=True),
          "segments": dict(coarse_segments=(8,))}[case]
    j, t, f_start, ts = _polish_both(d, **kw)
    _assert_same_polish(j, t, f_start)
    # The polish ran its outer iterations through the host-read STPCG.
    entries, trips = ts.syncs.loops["stpcg"]
    assert entries == OUTER and trips > OUTER


@pytest.mark.parametrize("regime", ["segment", "edgewise"])
def test_polish_forced_regimes_match_jax(regime):
    """The node-block preconditioner's two other branches, forced on 2 nodes
    of 30 poses: the segment path (segment_limit=16, seg_size=16; the
    segment-dense mG11 inverses and the segment-Schwarz CG translation
    solve) and the edge-wise path (dense_limit=0; the block-Jacobi blocks).
    Both polish to JAX's 2f (rtol 1e-9) and state (atol 1e-8)."""
    kw = (dict(segment_limit=16, seg_size=16) if regime == "segment"
          else dict(dense_limit=0))
    j, t, f_start, ts = _polish_both(3, num_nodes=2, solver_kw=kw,
                                     coarse=True)
    assert ts.probs.seg == (regime == "segment") and not ts.probs.dense
    _assert_same_polish(j, t, f_start)
    if regime == "segment":
        assert ts.syncs.loops["seg_cg"][0] > 0


@pytest.mark.parametrize("d", [3, 2])
def test_polish_global_matches_jax(d):
    """polish.polish_global (global_tnt_model with its per-pose Jacobi
    preconditioner) from the same state in both packages: f within rtol
    1e-9, t and R within atol 1e-8."""
    from dpgo_tpu.solvers.polish import polish_global as jpolish
    from dpgo_tpu.solvers.polish import polish_params as jparams

    from dpgo_tpu_torch.solvers.polish import polish_global, polish_params

    js, ts = _solvers(d)
    t0, R0 = _start(d)
    jt, jR, jf = jpolish(js.edges, jnp.asarray(t0), jnp.asarray(R0),
                         params=jparams(outer=OUTER, tcg=TCG))
    tt, tR, tf = polish_global(ts.edges, torch.tensor(t0),
                               torch.tensor(R0),
                               params=polish_params(outer=OUTER, tcg=TCG))
    f_start = float(ts._metrics(ts.initialize(t0, R0))[0]) / 2.0
    _assert_same_polish((float(jf), np.asarray(jt), np.asarray(jR)),
                        (float(tf), tt.numpy(), tR.numpy()), f_start)


def _edges_both(seed, loss):
    """The same random edge set in both packages (6 poses; the last third
    of the edges inter-node)."""
    from dpgo_tpu.objective import EdgeData as JEdges

    from dpgo_tpu_torch.objective import EdgeData

    rng = np.random.default_rng(seed)
    P, m, d = 6, 12, 3
    i = rng.integers(0, P - 1, m)
    j = i + rng.integers(1, P - i, m)
    arrays = dict(i=i, j=j, R=np.linalg.qr(rng.normal(size=(m, d, d)))[0],
                  t=rng.normal(size=(m, d)), kappa=rng.uniform(1, 5, m),
                  tau=rng.uniform(1, 5, m),
                  is_inter=np.arange(m) >= 2 * m // 3)
    je = JEdges(**{k: jnp.asarray(v) for k, v in arrays.items()})
    te = EdgeData(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return je, te, rng, P, d


@pytest.mark.parametrize("loss", ["trivial", "huber"])
def test_global_hessian_vp_matches_jax(loss):
    """global_tnt_model.hess_vp (split_tnt_model's, which every polish
    runs: the analytic directional derivative of the Euclidean gradient,
    robust weight derivatives included) equals the JAX
    package's jax.jvp Hessian to 1e-12 on the same inputs; and, as
    tests/test_polish.py holds for the JAX one, it is self-adjoint on the
    tangent space, tangent, and the gradient matches a finite difference of
    the objective."""
    from dpgo_tpu.losses import Loss as JLoss
    from dpgo_tpu.solvers.polish import global_tnt_model as jmodel

    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.manifold import proj_tangent, project_sod
    from dpgo_tpu_torch.solvers.polish import global_tnt_model

    je, te, rng, P, d = _edges_both(0, loss)
    # Residuals of these random edges are O(1): a loss_reg of 0.5 puts the
    # inter edges on both sides of Huber's kink.
    jm = jmodel(je, JLoss(loss), 0.5, num_poses=P)
    tm = global_tnt_model(te, Loss(loss), 0.5, num_poses=P)
    t = rng.normal(size=(P, d))
    R = project_sod(torch.as_tensor(rng.normal(size=(P, d, d)))).numpy()
    x_t = (torch.as_tensor(t), torch.as_tensor(R))
    x_j = (jnp.asarray(t), jnp.asarray(R))

    def tangent():
        return (rng.normal(size=(P, d)),
                proj_tangent(x_t[1], torch.as_tensor(
                    rng.normal(size=(P, d, d)))).numpy())

    u, v = tangent(), tangent()
    _, nabla_t = tm.grad_and_nabla(x_t)
    _, nabla_j = jm.grad_and_nabla(x_j)
    Hv_t = tm.hess_vp(x_t, nabla_t, tuple(torch.as_tensor(a) for a in v))
    Hv_j = jm.hess_vp(x_j, nabla_j, tuple(jnp.asarray(a) for a in v))
    for a, b in zip(Hv_t, Hv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    Hu_t = tm.hess_vp(x_t, nabla_t, tuple(torch.as_tensor(a) for a in u))

    def ip(a, b):
        return sum(float(np.sum(np.asarray(p) * np.asarray(q)))
                   for p, q in zip(a, b))

    assert abs(ip(u, Hv_t) - ip(v, Hu_t)) < 1e-9
    assert float(torch.max(torch.abs(
        Hv_t[1] - proj_tangent(x_t[1], Hv_t[1])))) < 1e-10
    eps = 1e-7
    f0 = float(tm.objective(x_t))
    x_eps = (x_t[0] + eps * torch.as_tensor(v[0]),
             project_sod(x_t[1] + eps * torch.as_tensor(v[1])))
    grad, _ = tm.grad_and_nabla(x_t)
    fd = (float(tm.objective(x_eps)) - f0) / eps
    assert abs(fd - ip(grad, v)) < 1e-4 * max(1.0, abs(f0))


def test_refine_stats_match_jax():
    """DPGOSolver.refine_stats (mm.refine_probe: the next step's TNT
    refinement re-run with recording) on the JAX solver's state after 5
    steps: the ring buffers, their counts and the gate mask equal JAX's
    (counts, CG iterations and acceptances exactly, values to rtol 1e-9)."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOpts

    from dpgo_tpu_torch.convert import state_from_numpy
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    meas = _graph(3)
    js = JSolver(meas, num_nodes=4, opts=JOpts(), dtype=jnp.float64)
    jst, _ = js.run_steps(js.initialize(), jnp.zeros((), jnp.int32), 5)
    jr = js.refine_stats(jst)
    ts = DPGOSolver(_torch_meas(meas), num_nodes=4, opts=MMOptions(),
                    dtype=torch.float64, device="cpu")
    tst = state_from_numpy({
        name: ({f.name: np.asarray(getattr(v, f.name))
                for f in dataclasses.fields(v)}
               if dataclasses.is_dataclass(v) else np.asarray(v))
        for name, v in jst._asdict().items()}, device="cpu")
    tr = ts.refine_stats(tst)
    assert tr.keys() == jr.keys()
    assert tr["fx"].shape == (4, MMOptions().tnt.max_iterations)
    assert tr["count"].sum() > 0
    for name in ("count", "inner_iterations", "accepted", "refined_mask"):
        np.testing.assert_array_equal(tr[name], jr[name], err_msg=name)
    for name in ("fx", "gradnorm", "pgradnorm", "Delta", "h_M_norm", "rho"):
        np.testing.assert_allclose(tr[name], jr[name], rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_noise_floor_gate_scoping():
    """tests/test_polish.py::test_noise_floor_gate_scoping on the port's
    tnt_generic(record=True) (through the one-problem adaptor): with a
    preconditioner blind to the remaining error, gate=True exits before the
    first iteration while gate=False proceeds and minimizes; the default
    derives the gate from the model's declared preconditioner span."""
    from dpgo_tpu_torch.solvers.tnt import TNTModel, TNTParams, tnt_one

    A = torch.tensor(np.diag([1.0, 1e-6]), dtype=torch.float32)
    scale = torch.tensor([1.0, 1e-8], dtype=torch.float32)
    model = TNTModel(
        objective=lambda x: 0.5 * x @ (A @ x),
        grad_and_nabla=lambda x: (A @ x, A @ x),
        hess_vp=lambda x, nabla, v: A @ v,
        precondition=lambda x, v: v * scale,
        retract=lambda x, v: x + v,
    )
    x0 = torch.tensor([0.0, 300.0], dtype=torch.float32)
    base = TNTParams(max_iterations=8, max_iterations_accepted=8,
                     gradient_tolerance=0.0,
                     preconditioned_gradient_tolerance=0.0,
                     relative_decrease_tolerance=0.0,
                     stepsize_tolerance=0.0, Delta_tolerance=0.0,
                     Delta0=1e4)
    f_x0 = float(model.objective(x0))
    _, _, _, _, h_on = tnt_one(
        model, x0, dataclasses.replace(base, noise_floor_gate=True),
        record=True)
    _, f_off, _, _, h_off = tnt_one(
        model, x0, dataclasses.replace(base, noise_floor_gate=False),
        record=True)
    assert int(h_on.count) == 0
    assert int(h_off.count) > 0
    assert float(f_off) < 0.5 * f_x0
    model_partial = model._replace(precon_spans_full_space=False)
    _, f_auto, _, _, h_auto = tnt_one(model_partial, x0, base, record=True)
    assert int(h_auto.count) > 0
    assert float(f_auto) < 0.5 * f_x0
    _, _, _, _, h_full = tnt_one(model, x0, base, record=True)
    assert int(h_full.count) == 0


def test_tnt_history_and_user_fn_match_jax():
    """tnt_generic's recording and its user hook on one problem, against
    the JAX package's on the same quadratic: equal histories (counts, CG
    iterations, acceptances exactly; values to rtol 1e-12), the user hook
    called once per outer iteration with the same stats, and its True
    return ending the solve after that iteration."""
    from dpgo_tpu.solvers.tnt import TNTModel as JModel
    from dpgo_tpu.solvers.tnt import TNTParams as JParams
    from dpgo_tpu.solvers.tnt import tnt_generic

    from dpgo_tpu_torch.solvers.tnt import TNTModel, TNTParams, tnt_one

    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    A = (Q * np.geomspace(1e-2, 1e2, 8)) @ Q.T
    b = rng.normal(size=8)
    x0 = rng.normal(size=8) * 5
    kw = dict(max_iterations=6, max_iterations_accepted=6, Delta0=0.5,
              max_tCG_iterations=3)

    def make(M, lib, at):
        Am, bm = at(A), at(b)
        return M(objective=lambda x: 0.5 * x @ (Am @ x) - bm @ x,
                 grad_and_nabla=lambda x: (Am @ x - bm, Am @ x - bm),
                 hess_vp=lambda x, nabla, v: Am @ v,
                 precondition=lambda x, v: v,
                 retract=lambda x, v: x + v)

    def hook(calls, stop_at):
        def fn(**stats):
            calls.append({k: float(v) for k, v in stats.items()})
            return len(calls) == stop_at
        return fn

    jcalls, tcalls = [], []
    jout = jax.jit(lambda x: tnt_generic(
        make(JModel, jnp, jnp.asarray), x, JParams(**kw), record=True,
        user_fn=hook(jcalls, 0)))(jnp.asarray(x0))
    tout = tnt_one(make(TNTModel, torch, torch.as_tensor),
                   torch.as_tensor(x0), TNTParams(**kw), record=True,
                   user_fn=hook(tcalls, 0))
    jh, th = jout[4], tout[4]
    assert int(th.count) == int(jh.count) > 2
    for name in ("inner_iterations", "accepted"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    for name in ("fx", "gradnorm", "pgradnorm", "Delta", "h_M_norm", "rho"):
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jh, name)), rtol=1e-12,
                                   err_msg=name)
    assert len(tcalls) == len(jcalls) == int(th.count)
    for tc, jc in zip(tcalls, jcalls):
        assert tc.keys() == jc.keys()
        for k in tc:
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-12, err_msg=k)
    # A True return stops the solve after that iteration.
    stop_calls = []
    *_, h_stop = tnt_one(make(TNTModel, torch, torch.as_tensor),
                         torch.as_tensor(x0), TNTParams(**kw), record=True,
                         user_fn=hook(stop_calls, 2))
    assert len(stop_calls) == 2 and int(h_stop.count) == 2
