"""The step's control flow on its three routes (dpgo_tpu_torch/utils.py):
the "trace" route (every branch and every loop trip run, merged with
torch.where: what the graph route's conditional nodes compute, and the JAX
package's semantics) against the host-read route, on the CPU in f64, no
JAX.

Each case runs 20 steps, past `oscillation_cnt_period` (15), so the
oscillation window's test on the step index runs on both sides of it; the
trace side steps as the captured step does (`_advance` with the step index
a device int32 counter and the reweighted problems carried from one step
to the next). Held: every tensor of the final state and the (2f, 2|grad|)
history equal bit for bit, and the device counters of the loops (entries
and trips of the TNT outer loop, the STPCG and the segment CG) and of the
master fallbacks equal to the host route's `HostSyncs.note` and fallback
counts. TNT is cut to 4 outer iterations and 30 CG iterations, since the
trace route runs every trip up to the caps.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STEPS = 20
TNT = dict(max_iterations=4, max_tCG_iterations=30)
LOOPS = ("tnt", "stpcg", "seg_cg")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _meas(num_poses, d=3, outliers=False):
    from dpgo_tpu_torch.io.g2o import Measurements
    rng = np.random.default_rng(7)
    meas, _, _ = random_pose_graph(rng, num_poses=num_poses, d=d,
                                   loop_closures=num_poses // 2, noise=0.05)
    meas = Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})
    if outliers:
        meas.t[::9] += 3.0
    return meas


CASES = {
    # AMM-PGO# with the TNT refinement on the dense path.
    "amm_dense_refined": dict(poses=40, opts=dict(accelerated=True)),
    # Huber with dynamic rescale: the reweighted problems carried.
    "huber_dynamic": dict(poses=40, outliers=True, loss="huber",
                          opts=dict(accelerated=True, rescale="dynamic")),
    "mm": dict(poses=40, opts=dict(accelerated=False)),
    "aa": dict(poses=40, opts=dict(scheme="aa", aa_resolve_t=True)),
    # AMM-PGO* with psi = phi = 1e3: every master fallback fires.
    "star_forced": dict(poses=40, star=True,
                        opts=dict(accelerated=True, psi=1e3, phi=1e3)),
    # The forced segment and edge-wise regimes (120 poses, 2 nodes).
    "segment": dict(poses=120, kw=dict(segment_limit=16, seg_size=16),
                    opts=dict(accelerated=True)),
    "edgewise": dict(poses=120, kw=dict(dense_limit=0),
                     opts=dict(accelerated=True)),
}


def _solver(case):
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    c = CASES[case]
    cls = DPGOStarSolver if c.get("star") else DPGOSolver
    return cls(_meas(c["poses"], outliers=c.get("outliers", False)),
               num_nodes=2, opts=MMOptions(tnt=TNTParams(**TNT), **c["opts"]),
               loss=Loss(c.get("loss", "trivial")), loss_reg=0.25,
               device="cpu", **c.get("kw", {}))


def _counts(solver) -> dict:
    from dpgo_tpu_torch.utils import DeviceCounters
    out = {n: [DeviceCounters.read(n + ".entries"),
               DeviceCounters.read(n + ".trips")] for n in LOOPS}
    if hasattr(solver, "fallbacks"):
        out["fallbacks"] = solver.fallbacks
    return out


def _host_run(solver, st):
    """The host-read route; returns (state, f, g, counts, syncs.loops)."""
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs
    solver.syncs = HostSyncs()
    DeviceCounters.reset()
    if hasattr(solver, "reset_fallbacks"):
        solver.reset_fallbacks()
    st, k, (f, g) = solver.run_steps_history_eager(st, 0, STEPS)
    assert k == STEPS
    return st, f, g, _counts(solver), dict(solver.syncs.loops)


def _trace_run(solver, st):
    """The trace route, stepped as the captured step steps: `_advance` with
    a device step index and the problems carried. No flag is read."""
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs, route
    solver.syncs = HostSyncs()
    DeviceCounters.reset()
    if hasattr(solver, "reset_fallbacks"):
        solver.reset_fallbacks()
    k = torch.zeros((), dtype=torch.int32)
    probs = solver.problems(st)
    fs, gs = [], []
    with route("trace"):
        for _ in range(STEPS):
            st, probs = solver._advance(probs, st, k)
            k = k + 1
            fs.append(torch.sum(st.fobj))
            gs.append(torch.sum(st.gradFnorm * st.gradFnorm))
    assert solver.syncs.count == 0
    assert int(k) == STEPS
    f = 2.0 * torch.stack(fs)
    g = 2.0 * torch.sqrt(torch.stack(gs))
    return st, f, g, _counts(solver)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_route_equals_host_route(case):
    from dpgo_tpu_torch.utils import flatten
    solver = _solver(case)
    st0 = solver.initialize()
    hs, hf, hg, hc, loops = _host_run(solver, st0)
    ts, tf, tg, tc = _trace_run(solver, st0)
    # Every tensor of the state, bit for bit (1e-12 where a torch.where over
    # a non-finite unused lane would force it: none needed so far).
    for a, b in zip(flatten(hs)[0], flatten(ts)[0]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    torch.testing.assert_close(tf, hf, rtol=0, atol=0)
    torch.testing.assert_close(tg, hg, rtol=0, atol=0)
    assert bool(hf[-1] < hf[0])
    # The device counters of both routes, and the host route's notes.
    assert tc == hc
    for name in LOOPS:
        assert hc[name] == loops.get(name, [0, 0]), name
    if case != "aa":  # Anderson acceleration runs no refinement
        assert hc["tnt"][0] > 0
    if case == "segment":
        assert hc["seg_cg"][1] > 0
    if case in ("edgewise", "segment"):
        assert hc["stpcg"][1] > 0
    if case == "star_forced":
        assert all(v > 0 for v in hc["fallbacks"].values()), hc


def test_warm_route_runs_one_trip_per_loop():
    """The warm-up route (both branches, each loop cut to one trip): runs
    every body once, reads no flag, and leaves the state finite."""
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs, route
    solver = _solver("segment")
    st = solver.initialize()
    solver.syncs = HostSyncs()
    DeviceCounters.reset()
    with route("warm"):
        st2, _ = solver._advance(solver.problems(st), st,
                                 torch.zeros((), dtype=torch.int32))
    assert solver.syncs.count == 0
    for name in LOOPS:
        entries = DeviceCounters.read(name + ".entries")
        assert DeviceCounters.read(name + ".trips") <= entries
    assert bool(torch.isfinite(st2.Z.t).all())


def test_device_cond_and_bounded_while_routes():
    """The primitives alone: a branch and a capped loop on each CPU route,
    the counters masked by the enclosing flags on the trace route."""
    from dpgo_tpu_torch.utils import (DeviceCounters, HostSyncs,
                                      bounded_while, device_cond, route)
    x = torch.tensor([0, 3, 9])

    def count_up(c, running):
        return (torch.where(running, c[0] + 1, c[0]),)

    def lanes(c):
        return c[0] < 5

    out = {}
    for mode in ("host", "trace"):
        DeviceCounters.reset()
        syncs = HostSyncs()
        with route(mode):
            (y,) = bounded_while(4, lanes, count_up, (x,), syncs, name="t")
            z = device_cond(
                (y > 100).any(),
                lambda: bounded_while(3, lanes, count_up, (y,), syncs,
                                      name="t")[0],
                lambda: y * 2, syncs=syncs)
        out[mode] = (y, z, DeviceCounters.read("t.entries"),
                     DeviceCounters.read("t.trips"), syncs.count)
    (hy, hz, he, ht, hs), (ty, tz, te, tt, ts) = out["host"], out["trace"]
    # Lane 0 stops at the cap of 4 trips, lane 1 on its flag.
    assert hy.tolist() == ty.tolist() == [4, 5, 9]
    assert hz.tolist() == tz.tolist() == [8, 10, 18]
    assert (he, ht) == (te, tt) == (1, 4)  # the untaken branch's loop: none
    assert hs == 4 + 1 and ts == 0

