"""Trip counts of the segment path's translation CG under dynamic-rescale
weights, in the port and in the JAX package, on the CPU (f64).

The JAX package runs the CG in a `lax.while_loop` and does not return its
trip count. It is read without touching the package: the problems with the
CG capped at k trips (`seg_cg_iters=k`, the only field that differs) give
the k = 20 result exactly from k = T on, where T is the solve's trip count,
and differ below it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.synthetic import random_pose_graph

SEG = dict(segment_limit=16, seg_size=16)
CAP = 20


def _graph():
    """The forced-segment graph of tests/test_torch_segment.py with its two
    corrupted inter-node edges (120 poses, 2 nodes of 60, 4 segments)."""
    from dpgo_tpu.graph import make_partition

    meas, _, _ = random_pose_graph(np.random.default_rng(0), num_poses=120,
                                   d=3, loop_closures=60, noise=0.05)
    part = make_partition(meas.num_poses, 2)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    meas.t[inter[:2]] += 5.0
    return meas


def test_segment_cg_trips_match_jax_under_rescale_weights(monkeypatch):
    """Huber + dynamic rescale on the forced segment path, 20 steps of the
    port's solver (STPCG capped at 10 as in the segment parity test): every
    translation solve, on the problems reweighted by that step's persisted
    weights, takes as many CG trips in the JAX package as in the port
    (HostSyncs.loops["seg_cg"]), and the same solution (rtol 1e-9 of its
    largest entry); some solves run after a rescale moved weights below 1.

    Observed: 20 solves of 12-16 trips, equal in every solve, 15 of them on
    rescaled weights. Both packages build the Schwarz factors `seg_t_inv` /
    `seg_c_inv` from the base weights and reuse them under rescale."""
    from dpgo_tpu import problem as jprob
    from dpgo_tpu.graph import build_multigraph as jax_build
    from dpgo_tpu.losses import Loss as JLoss

    from dpgo_tpu_torch import problem as tprob
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import Measurements
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    from dpgo_tpu_torch.utils import HostSyncs

    torch.set_num_threads(1)
    meas = _graph()
    calls = []
    solve = tprob.NodeProblem._solve_mG00_seg

    def recording(self, rhs, x0=None, syncs=None):
        syncs = syncs or HostSyncs()
        before = syncs.loops.get("seg_cg", [0, 0])[1]
        out = solve(self, rhs, x0, syncs)
        calls.append((self.scale_w.clone(), rhs.clone(), x0.clone(), out,
                      syncs.loops["seg_cg"][1] - before))
        return out

    monkeypatch.setattr(tprob.NodeProblem, "_solve_mG00_seg", recording)
    ts = DPGOSolver(Measurements(**{f.name: getattr(meas, f.name)
                                    for f in dataclasses.fields(meas)}),
                    2, opts=MMOptions(rescale="dynamic",
                                      tnt=TNTParams(max_tCG_iterations=10)),
                    loss=Loss.HUBER, loss_reg=0.25, device="cpu", **SEG)
    assert ts.probs.seg and ts.probs.seg_cg_iters == CAP
    ts.run_steps(ts.initialize(), 0, 20)
    assert len(calls) >= 20

    _, _, mg = jax_build(meas, 2)
    base = jprob.build_node_problems(mg, xi=1e-11, loss=JLoss.HUBER,
                                     loss_reg=0.25, precon_cond=1e6,
                                     dtype=jnp.float64, seg_cg_iters=CAP,
                                     **SEG)
    reweight = jax.jit(jax.vmap(jprob.with_weights))

    def capped(k):
        return jax.jit(jax.vmap(lambda p, r, x: dataclasses.replace(
            p, seg_cg_iters=k)._solve_mG00_seg(r, x)))

    solvers = {k: capped(k) for k in range(1, CAP + 1)}

    trips_port, trips_jax, rescaled = [], [], 0
    for w, rhs, x0, out, trips in calls:
        p = reweight(base, jnp.asarray(w.numpy()))
        rhs, x0 = jnp.asarray(rhs.numpy()), jnp.asarray(x0.numpy())
        results = [np.asarray(solvers[k](p, rhs, x0))
                   for k in range(1, CAP + 1)]
        final = results[-1]
        trips_jax.append(next(k for k in range(1, CAP + 1)
                              if np.array_equal(results[k - 1], final)))
        trips_port.append(trips)
        rescaled += bool((w < 1).any())
        np.testing.assert_allclose(out.numpy(), final, rtol=0,
                                   atol=1e-9 * np.abs(final).max())
    assert rescaled > 0
    assert trips_port == trips_jax
