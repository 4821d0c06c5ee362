"""Anderson-accelerated MM (`MMOptions(scheme="aa")`, mm.iterate_aa) in the
port against the JAX package, on the CPU (f64)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STEPS = 20
SEG = dict(segment_limit=16, seg_size=16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(num_poses=40, d=3):
    meas, _, _ = random_pose_graph(np.random.default_rng(42),
                                   num_poses=num_poses, d=d,
                                   loop_closures=num_poses // 4 * 3,
                                   noise=0.05)
    return meas


def _runs(meas, num_nodes, okw, steps=STEPS, **kw):
    """Both packages' DPGOSolver with MMOptions(scheme="aa", **okw) in f64:
    initialize + `steps` steps with history. Returns ((JAX state, 2f),
    (port solver, state, 2f))."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOptions

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    js = JSolver(meas, num_nodes, opts=JOptions(scheme="aa", **okw),
                 dtype=jnp.float64, **kw)
    jst, _, (jf, _) = js.run_steps_history(js.initialize(),
                                           jnp.zeros((), jnp.int32), steps)
    ts = DPGOSolver(_torch_meas(meas), num_nodes,
                    opts=MMOptions(scheme="aa", **okw), device="cpu", **kw)
    tst, k, (tf, _) = ts.run_steps_history(ts.initialize(), 0, steps)
    assert k == steps
    return (jst, np.asarray(jf)), (ts, tst, tf.numpy())


def _check_state(tst, jst, rtol):
    """The port's final own state and Anderson history against the JAX
    package's: each own-state field within rtol of its largest entry; the
    ring buffers (differences of states and of residuals) within rtol of
    the largest entry of the flattened state they are taken from."""
    for name in ("t", "R"):
        want = np.asarray(getattr(jst.Z, name))
        np.testing.assert_allclose(getattr(tst.Z, name).numpy(), want,
                                   rtol=0, atol=rtol * np.abs(want).max(),
                                   err_msg=name)
    scale = np.abs(np.asarray(jst.aa_x_prev)).max()
    for name in ("aa_dX", "aa_dR", "aa_x_prev", "aa_r_prev"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=0,
                                   atol=rtol * scale, err_msg=name)
    np.testing.assert_array_equal(tst.aa_count.numpy(),
                                  np.asarray(jst.aa_count))


@pytest.mark.parametrize("safeguard", ["monotone", "none"])
@pytest.mark.parametrize("resolve_t", [False, True])
def test_aa_matches_jax_f64(resolve_t, safeguard):
    """scheme="aa" on the dense path (40 poses, 2 nodes, d = 3), 20 steps:
    the per-step 2f and the final state (own poses and the Anderson ring
    buffers) within rtol 1e-9 of the JAX package's; the history window is
    full (aa_window 8). Under the monotone safeguard 2f never rises (1e-12
    relative rounding). The step reads nothing back to the host.

    Observed: 2f within 2.2e-12 ("none") and 7e-14 ("monotone")."""
    (jst, jf), (ts, tst, tf) = _runs(
        _graph(), 2, dict(aa_resolve_t=resolve_t, aa_safeguard=safeguard))
    assert tst.aa_dX.shape == (2, 8, tst.Z.t[0].numel() + tst.Z.R[0].numel())
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    _check_state(tst, jst, 1e-9)
    assert int(tst.aa_count.min()) == STEPS
    if safeguard == "monotone":
        assert np.all(np.diff(tf) <= 1e-12 * np.abs(tf[1:]))
    assert ts.syncs.count == 0


def test_aa_matches_jax_f64_d2():
    """scheme="aa" at d = 2 (SO(2) in closed form), 20 steps: 2f and the
    final state within rtol 1e-9."""
    (jst, jf), (_, tst, tf) = _runs(_graph(d=2), 2, {})
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    _check_state(tst, jst, 1e-9)


def test_aa_on_forced_segment_path_matches_jax_f64():
    """scheme="aa" with aa_resolve_t on the forced segment path (120 poses,
    2 nodes, segment_limit 16, seg_size 16): the translation solves run the
    segment-Schwarz CG (host-read loop). 2f and the final state within rtol
    1e-9 of the JAX package's."""
    (jst, jf), (ts, tst, tf) = _runs(_graph(120), 2,
                                     dict(aa_resolve_t=True), **SEG)
    assert ts.probs.seg
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    _check_state(tst, jst, 1e-9)
    assert ts.syncs.loops["seg_cg"][0] >= 2 * STEPS


def test_aa_state_round_trips_through_checkpoint(tmp_path):
    """An Anderson state after 7 steps saved and loaded by checkpoint.py
    (fields by name) continues exactly like the state kept in memory: 2f
    of 5 more steps bitwise equal, Anderson history included; the file
    does not load into a state of another window."""
    from dpgo_tpu_torch.checkpoint import load_state, save_state
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    s = DPGOSolver(_torch_meas(_graph()), 2, opts=MMOptions(scheme="aa"),
                   device="cpu")
    st, k = s.run_steps(s.initialize(), 0, 7)
    path = str(tmp_path / "aa.npz")
    save_state(path, st, k, gauge_c=s._c)
    template = s.initialize()
    st2, k2 = load_state(path, template, solver=s)
    assert k2 == 7 and int(st2.aa_count.min()) == 7
    for name in ("aa_dX", "aa_dR", "aa_x_prev", "aa_r_prev", "aa_count"):
        torch.testing.assert_close(getattr(st2, name), getattr(st, name),
                                   rtol=0, atol=0)
    _, _, (f1, _) = s.run_steps_history(st, k, 5)
    _, _, (f2, _) = s.run_steps_history(st2, k2, 5)
    torch.testing.assert_close(f2, f1, rtol=0, atol=0)
    other = DPGOSolver(_torch_meas(_graph()), 2,
                       opts=MMOptions(scheme="aa", aa_window=4),
                       device="cpu")
    with pytest.raises(ValueError, match="aa_dX"):
        load_state(path, other.initialize())
