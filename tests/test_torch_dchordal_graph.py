"""DChordal's stages as one captured program (distributed_chordal_init on a
CUDA card), on the CPU: the graph route's code (`dchordal._run` with
`graph`) with graph_nodes.run_once replaced by the "trace" route (every
branch and loop trip run, merged: what the captured program's conditional
nodes compute) against the host-read route, bit for bit, and against the
JAX package.

48-pose graphs (tests/test_torch_dchordal.py's) with 4 nodes at d = 3 and
2, and a 30-pose graph on one node. The float64 4-node cases run the
default DChordalConfig (the JAX comparison reuses them); the float32 and
one-node cases cut stage 0's TNT to 5 outer iterations
(`DChordalConfig(stage0_tnt_iters=5)`), since the trace route runs all 250
CG trips of each of its outer iterations.
"""

import dataclasses
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STAGES = {"dchordal.reduced_R": "iters_reduced_R",
          "dchordal.full_R": "iters_full_R",
          "dchordal.reduced_t": "iters_reduced_t",
          "dchordal.full_t": "iters_full_t"}
INNER = ("tnt", "stpcg", "seg_cg")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _meas(d, num_poses):
    from dpgo_tpu_torch.io.g2o import Measurements
    meas, _, _ = random_pose_graph(np.random.default_rng(42),
                                   num_poses=num_poses, d=d,
                                   loop_closures=30, noise=0.05)
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _trace_run_once(device, fn):
    """graph_nodes.run_once on the trace route: no capture; what the
    captured program computes."""
    from dpgo_tpu_torch.utils import route
    with route("trace"):
        out = fn()
    return out, types.SimpleNamespace(warmup_s=0.0, capture_s=0.0,
                                      pool_bytes=0, replay_s=lambda: 0.0)


def _counters() -> dict:
    from dpgo_tpu_torch.utils import DeviceCounters
    return {n: [DeviceCounters.read(n + ".entries"),
                DeviceCounters.read(n + ".trips")]
            for n in list(STAGES) + list(INNER)}


@functools.lru_cache(maxsize=None)
def _run(d, num_poses, num_nodes, dtype, graph, small):
    """One DChordal run from one set-up on the CPU, on the host route or
    (`graph`) on the graph route's code with the trace route in place of
    the capture. Returns (t, R, stats, device counters)."""
    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import DeviceCounters

    cfg = dchordal.DChordalConfig(stage0_tnt_iters=5 if small else 20)
    s = dchordal._setup(_meas(d, num_poses), num_nodes, cfg,
                        getattr(torch, dtype), torch.device("cpu"))
    DeviceCounters.reset()
    stats = {}
    with mock.patch.object(graph_nodes, "run_once", _trace_run_once):
        t, R = dchordal._run(s, True, graph, stats)
    return t, R, stats, _counters(), cfg


CASES = {"d3_f64": (3, 48, 4, "float64", False),
         "d2_f64": (2, 48, 4, "float64", False),
         "d3_f32": (3, 48, 4, "float32", True),
         "d2_f32": (2, 48, 4, "float32", True),
         "one_node_f64": (3, 30, 1, "float64", True),
         "one_node_f32": (3, 30, 1, "float32", True)}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_route_equals_host_route(case):
    """The graph route's stages compute what the host route computes, bit
    for bit (t and R); the four stage loops each count one entry and
    their `DChordalConfig` trips on both routes; stage 0's TNT and CG
    counters on the trace route equal the host route's notes; the graph
    route reads no flag on the host, the host route's TNT does."""
    d, P, N, dtype, small = CASES[case]
    ht, hR, hst, hc, cfg = _run(d, P, N, dtype, False, small)
    tt, tR, tst, tc, _ = _run(d, P, N, dtype, True, small)
    assert (hst["route"], tst["route"]) == ("host", "graph")
    assert ht.dtype == tt.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(tt, ht)
    np.testing.assert_array_equal(tR, hR)
    for name, field in STAGES.items():
        assert hc[name] == tc[name] == [1, getattr(cfg, field)], name
    for name in INNER:
        assert tc[name] == hc[name] == hst["loops"].get(name, [0, 0]), name
    assert tc["tnt"][0] == 1 and tc["stpcg"][1] > 0
    assert tst["host_syncs"] == 0 and tst["loops"] == {}
    assert hst["host_syncs"] > 0


@pytest.mark.parametrize("d", [3, 2])
def test_trace_route_matches_jax(d):
    """The graph route's stages (trace) at the default DChordalConfig
    within atol 1e-8 of the JAX package's distributed_chordal_init
    (tests/test_torch_dchordal.py's tolerance), float64, 4 nodes."""
    from dpgo_tpu.chordal import distributed_chordal_init as jax_init

    t, R, stats, _, cfg = _run(d, 48, 4, "float64", True, False)
    assert stats["route"] == "graph" and cfg.stage0_tnt_iters == 20
    jt, jR = jax_init(_meas(d, 48), 4)
    np.testing.assert_allclose(t, jt, atol=1e-8)
    np.testing.assert_allclose(R, jR, atol=1e-8)


def _nesterov_numpy(step_fn, X0, num_iters):
    """The recurrence with host numpy scalars of X0's type (the port's
    loop before the stages ran on the device)."""
    c = np.dtype(str(X0.dtype).removeprefix("torch.")).type
    X, X_prev, s = X0, X0, c(1.0)
    for _ in range(num_iters):
        s1 = c(0.5) + c(0.5) * np.sqrt(c(4.0) * s * s + c(1.0))
        gamma = (s - c(1.0)) / s1
        Y = float(c(1.0) + gamma) * X - float(gamma) * X_prev
        X, X_prev, s = step_fn(Y), X, s1
    return X


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nesterov_scan_keeps_the_numpy_scalar_bits(dtype):
    """`_nesterov_scan` with its 0-d tensor carry gives the bits of the
    host numpy scalars over 1,000 trips of a contraction, on the host and
    the trace route, and counts one entry and 1,000 trips."""
    from dpgo_tpu_torch.chordal.dchordal import _nesterov_scan
    from dpgo_tpu_torch.utils import DeviceCounters, route

    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(6, 6)) / 6.0, dtype=dtype)
    b = torch.as_tensor(rng.normal(size=(6, 2)), dtype=dtype)

    def step(Y):
        return 0.5 * (A @ Y) + b

    X0 = torch.as_tensor(rng.normal(size=(6, 2)), dtype=dtype)
    want = _nesterov_numpy(step, X0, 1000)
    for mode in ("host", "trace"):
        DeviceCounters.reset()
        with route(mode):
            got = _nesterov_scan(step, X0, 1000, "dchordal.test")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert [DeviceCounters.read("dchordal.test.entries"),
                DeviceCounters.read("dchordal.test.trips")] == [1, 1000]


def test_fixed_loop_routes():
    """utils.fixed_loop runs every trip on the host and trace routes and
    one on the warm route, reads no flag, and counts its entries and
    trips; without a name it counts nothing."""
    from dpgo_tpu_torch.utils import DeviceCounters, fixed_loop, route

    def body(c):
        return c[0] + 1.0, c[1] * 2.0

    for mode, trips in (("host", 7), ("trace", 7), ("warm", 1)):
        DeviceCounters.reset()
        with route(mode):
            x, y = fixed_loop(7, body, (torch.zeros(3), torch.ones(())),
                              name="fixed_test")
        assert x.tolist() == [float(trips)] * 3 and float(y) == 2.0 ** trips
        assert [DeviceCounters.read("fixed_test.entries"),
                DeviceCounters.read("fixed_test.trips")] == [1, trips]
    DeviceCounters.reset()
    x, _ = fixed_loop(0, body, (torch.zeros(3), torch.ones(())))
    assert x.tolist() == [0.0] * 3
    assert DeviceCounters.read("fixed_test.entries") == 0


def test_route_rule():
    """graph=None takes the graph route on a CUDA device only; graph=True
    on a CPU device raises before any set-up; graph=False is the host
    route."""
    from dpgo_tpu_torch.chordal import distributed_chordal_init
    from dpgo_tpu_torch.chordal.dchordal import graph_route

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert graph_route(None, cuda) and not graph_route(None, cpu)
    assert graph_route(True, cuda) and not graph_route(False, cuda)
    assert not graph_route(False, cpu)
    with pytest.raises(ValueError, match="CUDA card"):
        distributed_chordal_init(_meas(3, 48), 4, device="cpu", graph=True)
    stats = {}
    distributed_chordal_init(_meas(3, 48), 4, device="cpu", stats=stats)
    assert stats["route"] == "host"
    assert set(stats["setup_s"]) == {"problems", "seeds", "rotation_system",
                                     "copies"}


def test_solver_start_on_graph_route_equals_host_route(monkeypatch):
    """DPGOSolver.initialize(dist_init=True) with the solver's route
    forced to graph (the trace route in place of the capture) starts from
    the host route's state bit for bit, and records its route."""
    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.utils import flatten

    s = DPGOSolver(_meas(3, 48), num_nodes=2, opts=MMOptions(),
                   device="cpu")
    host = s.initialize(dist_init=True)
    assert s.dchordal_stats["route"] == "host"
    monkeypatch.setattr(s, "_graph_route", lambda: True)
    monkeypatch.setattr(dchordal, "graph_route",
                        lambda graph, device: bool(graph))
    monkeypatch.setattr(graph_nodes, "run_once", _trace_run_once)
    graph = s.initialize(dist_init=True)
    assert s.dchordal_stats["route"] == "graph"
    assert s.dchordal_stats["host_syncs"] == 0
    for a, b in zip(flatten(host.Z)[0], flatten(graph.Z)[0]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
