"""The polish's TNT as one captured program (DPGOSolver.polish on a CUDA
card), on the CPU: the graph route's code (`_run_polish_tnt` with `graph`)
with graph_nodes.run_once replaced by the "trace" route (every branch and
loop trip run, merged: what the captured program's conditional nodes
compute) against the host-read route, bit for bit, and against the JAX
package's polish. 60-pose graph, 4 nodes, float64, 3 outer iterations,
STPCG capped at 12 (tests/test_torch_polish.py's cap)."""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

OUTER = 3
TCG = 12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _graph():
    meas, _, _ = random_pose_graph(np.random.default_rng(5), num_poses=60,
                                   d=3, loop_closures=40, noise=0.05)
    return meas


@functools.lru_cache(maxsize=None)
def _start():
    """Global (t, R) after 10 AMM-PGO# steps of the JAX solver (4 nodes)."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    s = DPGOSolver(_graph(), num_nodes=4, opts=MMOptions(),
                   dtype=jnp.float64)
    st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), 10)
    return tuple(np.asarray(x) for x in s.gather_global(st))


CASES = {"coarse": dict(num_nodes=4, solver={}),
         # The segment-Schwarz CG (a bounded loop) inside the node-block
         # preconditioner: 2 nodes of 30 poses, segments of 16.
         "segment": dict(num_nodes=2,
                         solver=dict(segment_limit=16, seg_size=16))}


def _solver(case):
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import Measurements
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    meas = _graph()
    c = CASES[case]
    return DPGOSolver(Measurements(**{f.name: getattr(meas, f.name)
                                      for f in dataclasses.fields(meas)}),
                      num_nodes=c["num_nodes"],
                      opts=MMOptions(tnt=TNTParams(max_iterations=0)),
                      dtype=torch.float64, device="cpu", **c["solver"])


def _trace_run_once(device, fn):
    """graph_nodes.run_once on the trace route: no capture; what the
    captured program computes."""
    from dpgo_tpu_torch.utils import route
    with route("trace"):
        out = fn()
    return out, types.SimpleNamespace(capture_s=0.0, warmup_s=0.0,
                                      pool_bytes=0)


def _polish(solver, graph, monkeypatch):
    """polish(outer=3, tcg=12, coarse=True) from the JAX start on the host
    route, or (`graph`) on the graph route's code with the trace route in
    place of the capture. Returns (2f, state, stats, loop counters, host
    flag reads)."""
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    st0 = solver.initialize(*_start())
    solver.syncs = HostSyncs()
    DeviceCounters.reset()
    with monkeypatch.context() as m:
        if graph:
            m.setattr(graph_nodes, "run_once", _trace_run_once)
            m.setattr(solver, "_graph_route", lambda: True)
        st, f2 = solver.polish(st0, outer=OUTER, tcg=TCG, coarse=True)
    loops = {n: [DeviceCounters.read(n + ".entries"),
                 DeviceCounters.read(n + ".trips")]
             for n in ("tnt", "stpcg", "seg_cg")}
    return f2, st, solver.polish_stats, loops, solver.syncs


@pytest.mark.parametrize("case", list(CASES))
def test_polish_trace_route_equals_host_route(case, monkeypatch):
    """The graph route's polish (the TNT captured whole) computes what the
    host route computes, bit for bit: 2f, the state the solver is
    re-initialized at, the outer and CG iterations, the TNT history, and
    the device counters of the TNT outer loop, the STPCG and the segment
    CG (equal to the host route's notes); the graph route reads no flag on
    the host."""
    from dpgo_tpu_torch.utils import flatten
    solver = _solver(case)
    hf, hst, hstats, hloops, hsyncs = _polish(solver, False, monkeypatch)
    tf, tst, tstats, tloops, tsyncs = _polish(solver, True, monkeypatch)
    assert (hstats["route"], tstats["route"]) == ("host", "graph")
    assert tf == hf
    for a, b in zip(flatten(hst)[0], flatten(tst)[0]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert tstats["outer"] == hstats["outer"] == OUTER
    assert tstats["cg_iterations"] == hstats["cg_iterations"] > OUTER
    for k, v in hstats["history"].items():
        np.testing.assert_array_equal(tstats["history"][k], v, err_msg=k)
    assert tloops == hloops
    for name, note in hsyncs.loops.items():
        assert hloops[name] == note, name
    assert hsyncs.count > 0 and tsyncs.count == 0
    if case == "segment":
        assert hloops["seg_cg"][1] > 0


def test_polish_trace_route_matches_jax(monkeypatch):
    """The graph route's polish (trace route in place of the capture)
    against the JAX package's DPGOSolver.polish from the same state: 2f
    within rtol 1e-9, t and R within atol 1e-8 (test_torch_polish.py)."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOpts
    from dpgo_tpu.solvers.tnt import TNTParams as JParams

    js = JSolver(_graph(), num_nodes=4,
                 opts=JOpts(tnt=JParams(max_iterations=0)),
                 dtype=jnp.float64)
    jst, jf = js.polish(js.initialize(*_start()), outer=OUTER, tcg=TCG,
                        coarse=True)
    solver = _solver("coarse")
    f_start = float(solver._metrics(solver.initialize(*_start()))[0])
    tf, tst, _, _, _ = _polish(solver, True, monkeypatch)
    assert tf < f_start
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
    for a, b in zip(js.gather_global(jst), solver.gather_global(tst)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-8)
