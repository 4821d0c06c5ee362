"""The port's main path end to end against the JAX package, on the CPU:
AMM-PGO# with the refined TNT preset on the dense path (d = 3, and d = 2 for
the parity test), each package driven through its own DPGOSolver entry points
from the same measurements."""

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
def _graph(d):
    rng = np.random.default_rng(42)
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=d, loop_closures=30,
                                   noise=0.05)
    return meas


@functools.lru_cache(maxsize=None)
def _jax_run(d):
    """The JAX solver (f64): initialize, then STEPS steps with history."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    s = DPGOSolver(_graph(d), num_nodes=2, opts=MMOptions(accelerated=True),
                   dtype=jnp.float64)
    st0 = s.initialize()
    st, _, (f, g) = s.run_steps_history(st0, jnp.zeros((), jnp.int32), STEPS)
    return s, st0, st, np.asarray(f), np.asarray(g)


@pytest.fixture(scope="module")
def graph():
    return _graph(3)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run(3)


def _port(graph, **kw):
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    return DPGOSolver(_torch_meas(graph), num_nodes=2,
                      opts=MMOptions(accelerated=True), device="cpu", **kw)


@pytest.mark.parametrize("d", [3, 2])
def test_slice_matches_jax_f64(d):
    """Same initialize(), then STEPS steps: per-step 2f / 2|grad| within
    rtol 1e-9, final Z.t / Z.R within atol 1e-8, and the Nesterov / restart
    bookkeeping (s, gamma, hits0, hits1, num_osc) equal; for SE(3) and for
    SE(2) graphs."""
    js, jst0, jst, jf, jg = _jax_run(d)
    ts = _port(_graph(d), dtype=torch.float64)
    tst0 = ts.initialize()
    np.testing.assert_allclose(tst0.fobj.numpy(), np.asarray(jst0.fobj),
                               rtol=1e-12)
    tst, k, (tf, tg) = ts.run_steps_history(tst0, 0, STEPS)
    assert k == STEPS
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-9)
    np.testing.assert_allclose(tst.Z.t.numpy(), np.asarray(jst.Z.t),
                               atol=1e-8)
    np.testing.assert_allclose(tst.Z.R.numpy(), np.asarray(jst.Z.R),
                               atol=1e-8)
    np.testing.assert_allclose(tst.s.numpy(), np.asarray(jst.s), rtol=1e-12)
    np.testing.assert_allclose(tst.gamma.numpy(), np.asarray(jst.gamma),
                               rtol=1e-12)
    for name in ("hits0", "hits1", "num_osc"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    # The refined path ran: TNT and CG flags were read on the host.
    assert ts.syncs.count > 3 * STEPS
    # The exact global oracle agrees with the node-objective history.
    f_exact, _ = ts._metrics(tst)
    np.testing.assert_allclose(float(f_exact), float(tf[-1]), rtol=1e-9)


def test_slice_f32_cpu_runs_and_decreases(graph):
    """The f32 configuration of the slice (local gauge, direct objective)
    runs on the CPU through the plain versions: finite, decreasing, and the
    fused-CG gate is off (it needs a CUDA device)."""
    ts = _port(graph, dtype=torch.float32)
    assert ts.local_gauge and not ts.fused_stpcg_engaged()
    st = ts.initialize()
    f0, _ = ts._metrics(st)
    st, _, (f, g) = ts.run_steps_history(st, 0, STEPS)
    assert torch.isfinite(f).all() and torch.isfinite(g).all()
    assert float(f[-1]) < float(f0)
    f_end, _ = ts._metrics(st)
    np.testing.assert_allclose(float(f_end), float(f[-1]), rtol=1e-4)


def test_masked_tnt_lanes_match_full_batch(graph, jax_run):
    """TNT restricted to the masked lanes gives those lanes exactly the
    result of the full batch (the JAX package computes every lane and
    discards the unmasked ones)."""
    from dpgo_tpu_torch.convert import problem_from_numpy, state_from_numpy
    from dpgo_tpu_torch.solvers import mm
    from dpgo_tpu_torch.utils import HostSyncs

    js, _, jst, _, _ = jax_run
    probs = problem_from_numpy({f.name: getattr(js.probs, f.name)
                                for f in dataclasses.fields(js.probs)},
                               device="cpu")
    st = state_from_numpy({
        name: ({f.name: np.asarray(getattr(v, f.name))
                for f in dataclasses.fields(v)}
               if dataclasses.is_dataclass(v) else np.asarray(v))
        for name, v in jst._asdict().items()}, device="cpu")
    th_t, th_R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
    t_c = probs.recover_translations(th_R, st.g_t, st.Z.t)
    anchor = (st.Z.t, st.Z.R, st.fobj)
    params = mm.MMOptions().tnt
    full = mm._tnt_batch(probs, t_c, th_R, st.g_t, st.g_R, params, st.Z.t,
                         anchor, syncs=HostSyncs())
    lanes = torch.tensor([False, True])
    part = mm._tnt_batch(probs, t_c, th_R, st.g_t, st.g_R, params, st.Z.t,
                         anchor, syncs=HostSyncs(), lanes=lanes)
    for a, b in zip(full, part):
        torch.testing.assert_close(b[1], a[1], rtol=0, atol=0)
