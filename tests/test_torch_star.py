"""AMM-PGO* (solvers/star.py, DPGOStarSolver) in the port against the JAX
package, on the CPU (f64): both star solvers driven from the same
measurements through their own entry points."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STEPS = 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(d, seed=42, noise=0.05):
    rng = np.random.default_rng(seed)
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=d, loop_closures=30,
                                   noise=noise)
    return meas


def _pair(meas, num_nodes=2, steps=STEPS, loss="trivial", **opts):
    """Both star solvers from the same measurements: initialize, then
    `steps` steps with history. Returns (JAX (state, f, g), port (solver,
    state, f, g))."""
    from dpgo_tpu.driver import DPGOStarSolver as JStar
    from dpgo_tpu.losses import Loss as JLoss
    from dpgo_tpu.solvers.mm import MMOptions as JOptions

    from dpgo_tpu_torch.driver import DPGOStarSolver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions

    js = JStar(meas, num_nodes=num_nodes, opts=JOptions(**opts),
               loss=JLoss(loss), loss_reg=0.25, dtype=jnp.float64)
    jst, _, (jf, jg) = js.run_steps_history(js.initialize(),
                                            jnp.zeros((), jnp.int32), steps)
    ts = DPGOStarSolver(_torch_meas(meas), num_nodes=num_nodes,
                        opts=MMOptions(**opts), loss=Loss(loss),
                        loss_reg=0.25, device="cpu")
    tst, k, (tf, tg) = ts.run_steps_history(ts.initialize(), 0, steps)
    assert k == steps
    return (jst, np.asarray(jf), np.asarray(jg)), (ts, tst, tf.numpy(),
                                                   tg.numpy())


def _assert_match(j, t):
    jst, jf, jg = j
    _, tst, tf, tg = t
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    np.testing.assert_allclose(tg, jg, rtol=1e-9)
    np.testing.assert_allclose(tst.Z.t.numpy(), np.asarray(jst.Z.t),
                               atol=1e-8)
    np.testing.assert_allclose(tst.Z.R.numpy(), np.asarray(jst.Z.R),
                               atol=1e-8)
    for name in ("F", "s", "gamma"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("d", [3, 2])
def test_star_matches_jax_f64(d):
    """initialize + 20 steps on the 40-pose graph with 2 nodes: per-step 2f
    and 2|grad| within rtol 1e-9, final Z.t and Z.R within atol 1e-8, the
    master reference F and the Nesterov s, gamma within rtol 1e-12; the
    master flags were read on the host (3 per step) and the exact global
    oracle agrees with the node-objective history."""
    j, t = _pair(_graph(d))
    _assert_match(j, t)
    ts, tst, tf, _ = t
    assert ts.syncs.count >= 3 * STEPS
    f_exact, _ = ts._metrics(tst)
    np.testing.assert_allclose(float(f_exact), tf[-1], rtol=1e-9)


def test_star_fallbacks_match_jax_f64():
    """With psi = phi = 1e3 the master tests fail often enough that each
    fallback (proximal pm, MM, phi-test) fires: the fallback passes agree
    with the JAX package's lax.cond branches within the tolerances of
    test_star_matches_jax_f64."""
    j, t = _pair(_graph(3), steps=10, psi=1e3, phi=1e3)
    _assert_match(j, t)
    fired = t[0].fallbacks
    assert all(fired.values()), fired


def test_star_huber_static_matches_jax_f64():
    """Huber (static rescale) re-evaluates the surrogate at the extrapolated
    point Y instead of extrapolating it: 10 steps agree with the JAX
    package within the tolerances of test_star_matches_jax_f64."""
    j, t = _pair(_graph(3), steps=10, loss="huber")
    _assert_match(j, t)


def test_star_solver_matches_hash_on_easy_graph():
    """The port's AMM-PGO* and AMM-PGO# coincide while no restart triggers
    (tests/test_solver.py::test_star_solver_matches_hash_on_easy_graph on a
    synthetic graph: 40 poses, noise 0.2, 4 nodes): 2f every 10 steps
    within rtol 1e-6 over 40 steps, no master fallback, small gradient."""
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    meas = _torch_meas(_graph(3, seed=3, noise=0.2))
    hash_solver = DPGOSolver(meas, num_nodes=4, opts=MMOptions(),
                             device="cpu")
    star_solver = DPGOStarSolver(meas, num_nodes=4, opts=MMOptions(),
                                 device="cpu")
    _, hist_h = hash_solver.run(40, record_every=10)
    _, hist_s = star_solver.run(40, record_every=10)
    assert hist_s.shape == (5, 3)
    np.testing.assert_array_equal(hist_s[:, 0], [0, 10, 20, 30, 40])
    np.testing.assert_allclose(hist_s[:, 1], hist_h[:, 1], rtol=1e-6)
    assert not any(star_solver.fallbacks.values())
    assert hist_s[-1, 2] < 0.5


def test_star_step_on_converted_state_matches_jax():
    """One AMM-PGO* step (iterate_star, communicate, update_star) from the
    JAX solver's state after 5 steps, carried across with convert.py
    (problem_from_numpy, block-Jacobi blocks included, and
    star_state_from_numpy), against the JAX solver's own step: Z within
    atol 1e-10, F and the node objectives within rtol 1e-12."""
    from dpgo_tpu.driver import DPGOStarSolver as JStar
    from dpgo_tpu.solvers.mm import MMOptions as JOptions

    from dpgo_tpu_torch.convert import (problem_from_numpy,
                                        star_state_from_numpy)
    from dpgo_tpu_torch.driver import DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    meas = _graph(3)
    js = JStar(meas, num_nodes=2, opts=JOptions(), dtype=jnp.float64)
    jst, k = js.initialize(), jnp.zeros((), jnp.int32)
    for _ in range(5):  # one compiled single-step program, reused
        jst, k = js.run_steps(jst, k, 1)
    jnext, _ = js.run_steps(jst, k, 1)

    def arrays(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}

    ts = DPGOStarSolver(_torch_meas(meas), num_nodes=2, opts=MMOptions(),
                        device="cpu")
    ts.probs = problem_from_numpy(arrays(js.probs), device="cpu")
    tst = star_state_from_numpy(
        {name: (arrays(v) if dataclasses.is_dataclass(v) else np.asarray(v))
         for name, v in jst._asdict().items()}, device="cpu")
    tnext = ts._step(tst, 5)
    np.testing.assert_allclose(tnext.Z.t.numpy(), np.asarray(jnext.Z.t),
                               atol=1e-10)
    np.testing.assert_allclose(tnext.Z.R.numpy(), np.asarray(jnext.Z.R),
                               atol=1e-10)
    np.testing.assert_allclose(float(tnext.F), float(jnext.F), rtol=1e-12)
    np.testing.assert_allclose(tnext.fobj.numpy(), np.asarray(jnext.fobj),
                               rtol=1e-12)
