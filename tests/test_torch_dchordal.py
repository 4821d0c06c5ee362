"""Distributed chordal initialization (chordal/dchordal.py) in the port
against the JAX package, on the CPU (f64)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _graph(d, num_poses=48):
    rng = np.random.default_rng(42)
    meas, _, _ = random_pose_graph(rng, num_poses=num_poses, d=d,
                                   loop_closures=30, noise=0.05)
    return meas


def _both(meas, num_nodes):
    from dpgo_tpu.chordal import distributed_chordal_init as jax_init

    from dpgo_tpu_torch.chordal import distributed_chordal_init

    jt, jR = jax_init(meas, num_nodes)
    tt, tR = distributed_chordal_init(_torch_meas(meas), num_nodes,
                                      device="cpu")
    assert tt.shape == jt.shape and tR.shape == jR.shape
    np.testing.assert_allclose(tt, jt, atol=1e-8)
    np.testing.assert_allclose(tR, jR, atol=1e-8)
    return tt, tR


def _objective(meas, t, R) -> float:
    from dpgo_tpu_torch.chordal.dchordal import chordal_objective
    return chordal_objective(_torch_meas(meas), t, R)


@pytest.mark.parametrize("d", [3, 2])
def test_dchordal_matches_jax_f64(d):
    """The four stages on a 48-pose graph with 4 nodes: t and R within atol
    1e-8 of the JAX package; the rotations are in SO(d); the objective
    within the bound of tests/test_chordal.py::test_dchordal_3d_synthetic
    (1.5 x centralized chordal + 1)."""
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)

    meas = _graph(d)
    t, R = _both(meas, 4)
    RtR = np.einsum("nki,nkj->nij", R, R)
    np.testing.assert_allclose(RtR, np.tile(np.eye(d), (len(R), 1, 1)),
                               atol=1e-10)
    assert np.all(np.linalg.det(R) > 0)
    Rc = chordal_initialization(_torch_meas(meas))
    tc = recover_translations_global(_torch_meas(meas), Rc)
    assert _objective(meas, t, R) <= 1.5 * _objective(meas, tc, Rc) + 1.0


def test_dchordal_single_node_matches_jax_f64():
    """One node: no inter edges, so stage 2 leaves the stage-0 local solve
    untouched; the result equals the JAX package's (atol 1e-8), is finite,
    and the stage-0 refinement solved the whole problem (2f no larger than
    at the centralized chordal start)."""
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)

    meas = _graph(3, num_poses=30)
    t, R = _both(meas, 1)
    assert np.isfinite(t).all() and np.isfinite(R).all()
    Rc = chordal_initialization(_torch_meas(meas))
    tc = recover_translations_global(_torch_meas(meas), Rc)
    assert _objective(meas, t, R) <= _objective(meas, tc, Rc)


@pytest.mark.parametrize("solver", ["hash", "star"])
def test_dchordal_feeds_solver(solver):
    """initialize(dist_init=True) (the CLI's default) feeds 30 steps that do
    not raise 2f (tests/test_chordal.py::test_dchordal_feeds_solver on a
    synthetic graph), for AMM-PGO# and AMM-PGO*; the start equals
    initialize() from the DChordal estimate."""
    from dpgo_tpu_torch.chordal import distributed_chordal_init
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    meas = _torch_meas(_graph(3))
    cls = DPGOStarSolver if solver == "star" else DPGOSolver
    s = cls(meas, num_nodes=2, opts=MMOptions(), device="cpu")
    st = s.initialize(dist_init=True)
    f0, _ = s._metrics(st)
    t, R = distributed_chordal_init(meas, 2, device="cpu")
    f_ref, _ = s._metrics(s.initialize(t, R))
    np.testing.assert_allclose(float(f0), float(f_ref), rtol=1e-12)
    st, _ = s.run_steps(st, 0, 30)
    f1, g1 = s._metrics(st)
    assert float(f1) <= float(f0)
    assert float(g1) < 1.0
