"""Robust losses and dynamic rescale in the port against the JAX package, on
the CPU (f64): both DPGOSolvers on one graph with corrupted inter-node
edges, and `with_weights` on one converted problem."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STEPS = 10
LOSS_REG = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@pytest.fixture(scope="module")
def graph():
    """36 poses, 2 nodes; the first two inter-node edges corrupted by 5 m
    (as tests/test_robust.py::test_robust_solver_decreases does)."""
    from dpgo_tpu.graph import make_partition

    rng = np.random.default_rng(42)
    meas, _, _ = random_pose_graph(rng, num_poses=36, d=3, loop_closures=20,
                                   noise=0.05)
    part = make_partition(meas.num_poses, 2)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    meas.t[inter[:2]] += 5.0
    return meas


@pytest.mark.parametrize("rescale", ["static", "dynamic"])
@pytest.mark.parametrize("loss", ["huber", "geman_mcclure", "welsch"])
def test_robust_solver_matches_jax_f64(graph, loss, rescale):
    """Same initialize(), then STEPS steps of both DPGOSolvers with the loss
    and rescale mode: per-step 2f / 2|grad| within rtol 1e-9, the persisted
    weights scale_w within rtol 1e-9 and rescale_count equal (dynamic
    rescale fires at the sixth update), and the global robust oracle equal
    to the node-objective history and to the node objectives
    (local_fobj)."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.losses import Loss as JLoss
    from dpgo_tpu.solvers.mm import MMOptions as JOptions

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions

    js = JSolver(graph, num_nodes=2,
                 opts=JOptions(accelerated=True, rescale=rescale),
                 loss=JLoss(loss), loss_reg=LOSS_REG, dtype=jnp.float64)
    jst, _, (jf, jg) = js.run_steps_history(
        js.initialize(), jnp.zeros((), jnp.int32), STEPS)

    ts = DPGOSolver(_torch_meas(graph), num_nodes=2,
                    opts=MMOptions(accelerated=True, rescale=rescale),
                    loss=Loss(loss), loss_reg=LOSS_REG, dtype=torch.float64,
                    device="cpu")
    tst, k, (tf, tg) = ts.run_steps_history(ts.initialize(), 0, STEPS)
    assert k == STEPS
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9)
    np.testing.assert_allclose(tst.scale_w.numpy(), np.asarray(jst.scale_w),
                               rtol=1e-9)
    np.testing.assert_array_equal(tst.rescale_count.numpy(),
                                  np.asarray(jst.rescale_count))
    if rescale == "dynamic":
        # The trigger fired and reweighted the corrupted edges.
        assert float(tst.scale_w.min()) < 1.0
    f_exact, _ = ts._metrics(tst)
    np.testing.assert_allclose(float(f_exact), float(tf[-1]), rtol=1e-9)
    np.testing.assert_allclose(ts.probs.local_fobj(tst.Z).numpy(),
                               tst.fobj.numpy(), rtol=1e-12)


def test_with_weights_matches_jax(graph):
    """with_weights on the converted JAX problem (Huber, 2 nodes) against
    dpgo_tpu.problem.with_weights for random weights in [0.05, 1]: Hred_d,
    mG11_d, mG01_d, mG00_d, wood_C, diagT_inv, nvec and W, and the
    reweighted translation solve of the port's problem and of the converted
    JAX one, within rtol 1e-10 (atol 1e-10 of the largest entry, for the
    entries that cancel to ~0)."""
    from dpgo_tpu.graph import build_multigraph
    from dpgo_tpu.losses import Loss as JLoss
    from dpgo_tpu.problem import build_node_problems
    from dpgo_tpu.problem import with_weights as jax_with_weights

    from dpgo_tpu_torch.convert import problem_from_numpy
    from dpgo_tpu_torch.problem import with_weights

    _, _, mg = build_multigraph(graph, 2)
    jp = build_node_problems(mg, xi=1e-11, loss=JLoss.HUBER,
                             loss_reg=LOSS_REG)
    rng = np.random.default_rng(3)
    w = np.where(mg.e_mask, rng.uniform(0.05, 1.0, size=mg.e_mask.shape),
                 1.0)
    jw = jax.vmap(jax_with_weights)(jp, jnp.asarray(w))
    tp = problem_from_numpy({f.name: getattr(jp, f.name)
                             for f in dataclasses.fields(jp)}, device="cpu")
    tw = with_weights(tp, torch.tensor(w))
    assert tw.dynamic and not tp.dynamic
    for name in ("Hred_d", "mG11_d", "mG01_d", "mG00_d", "wood_C",
                 "diagT_inv", "nvec", "W"):
        ref = np.asarray(getattr(jw, name))
        np.testing.assert_allclose(getattr(tw, name).numpy(), ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)
    rhs = rng.normal(size=(2, mg.n0_max, 3))
    anchor = rng.normal(size=(2, mg.n0_max, 3))
    ref = jax.vmap(lambda p, r, a: p.solve_mG00(r, a))(
        jw, jnp.asarray(rhs), jnp.asarray(anchor))
    # The port's reweighted problem and the converted JAX one solve alike.
    jwt = problem_from_numpy({f.name: getattr(jw, f.name)
                              for f in dataclasses.fields(jw)},
                             device="cpu")
    assert jwt.dynamic
    for p in (tw, jwt):
        out = p.solve_mG00(torch.tensor(rhs), torch.tensor(anchor))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(ref)).max())
