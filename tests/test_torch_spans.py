"""The program's spans (`dpgo_tpu_torch.utils.Spans`) on the CPU: nesting,
parents and solve indices, the ring's bound, the refusal inside a captured
body, the set-up's spans on a small graph and their cover of `build` and
`init`, the captured program's seconds read from the spans, and the
benchmark's four span readers (`pgobench/metrics/`) on hand-made rings.
No JAX."""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

BUILD_PARTS = ("build.multigraph", "device.open", "build.assemble",
               "build.linalg", "build.upload")
INIT_PARTS = ("init.chordal", "init.update")


@pytest.fixture(autouse=True)
def _fresh_ring():
    from dpgo_tpu_torch.utils import Spans
    Spans.reset()
    yield
    Spans.reset()


def _meas(num_poses=40):
    from dpgo_tpu_torch.io.g2o import Measurements
    rng = np.random.default_rng(3)
    meas, _, _ = random_pose_graph(rng, num_poses=num_poses, d=3,
                                   loop_closures=num_poses // 2, noise=0.05)
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _solver():
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    return DPGOSolver(_meas(), num_nodes=2, opts=MMOptions(
        accelerated=True, tnt=TNTParams(max_iterations=2,
                                        max_tCG_iterations=10)),
        device="cpu")


def test_nesting_parents_and_solve_indices():
    from dpgo_tpu_torch.utils import Spans, span
    with span("a", setup=True) as a:
        with span("a.b", setup=True) as b:
            pass
        with span("a.c", setup=True) as c:
            with span("a.c.d", setup=True) as d:
                pass
    assert (a.parent, b.parent, c.parent, d.parent) == \
        (None, a.seq, a.seq, c.seq)
    assert [r.name for r in Spans.records()] == ["a", "a.b", "a.c", "a.c.d"]
    assert all(r.solve is None for r in Spans.records())
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= a.end_ns
    assert Spans.next_solve() == 1
    with span("solve") as s1:
        with span("solve.load") as load:
            pass
    with span("gather") as g1:
        pass
    Spans.next_solve()
    with span("solve") as s2, span("kernels.load", setup=True) as k:
        pass
    assert (s1.solve, load.solve, g1.solve, s2.solve) == (1, 1, 1, 2)
    assert load.parent == s1.seq and g1.parent is None
    assert k.solve is None and k.parent == s2.seq
    # CPU spans hold no events.
    assert s1.start_event is None and s1.end_event is None
    assert Spans.host_s("solve") == pytest.approx(s1.host_s + s2.host_s)
    assert Spans.host_s("nothing") is None


def test_graph_route_solves_and_gathers_carry_their_index(monkeypatch):
    """run_steps on the graph route (the captured step replaced by its
    trace-route twin, as the CPU tests of the graph route do): one `solve`
    per call with its `solve.load` and `solve.result`, its steps and its
    index; `gather` carries the index of the solve it follows."""
    from dpgo_tpu_torch import driver
    from dpgo_tpu_torch.utils import Spans, route

    class TraceStepGraph(driver._StepGraph):
        def capture(self, solver):
            self.solver = solver

        def replay(self):
            with route("trace"):
                self.body(self.solver)

    monkeypatch.setattr(driver, "_StepGraph", TraceStepGraph)
    solver = _solver()
    solver._graph_route = lambda: True
    st0 = solver.initialize()
    Spans.reset()
    for n in (2, 3):
        st, _ = solver.run_steps(st0, 0, n)
        solver.gather_global(st)
    recs = Spans.records()
    assert [r.name for r in recs] == ["solve", "solve.load", "solve.result",
                                      "gather"] * 2
    solves = Spans.records("solve")
    assert [r.steps for r in solves] == [2, 3]
    assert [r.solve for r in recs] == [1] * 4 + [2] * 4
    for r in recs:
        if r.name.startswith("solve."):
            assert r.parent == solves[r.solve - 1].seq
        else:
            assert r.parent is None


def test_ring_is_bounded():
    from dpgo_tpu_torch.utils import Spans, span
    n = Spans.RING + 10
    for i in range(n):
        with span(f"s{i}"):
            pass
    recs = Spans.records()
    assert len(recs) == Spans.RING
    assert recs[0].name == f"s{n - Spans.RING}"
    assert recs[-1].name == f"s{n - 1}"


@pytest.mark.parametrize("mode", ["warm", "capture"])
def test_span_refuses_captured_bodies(mode):
    from dpgo_tpu_torch.utils import Spans, route, span
    with route(mode), pytest.raises(RuntimeError, match="captured body"):
        with span("inside"):
            pass
    assert Spans.records() == []
    with route("trace"), span("trace"):
        pass
    assert [r.name for r in Spans.records()] == ["trace"]


def _cover(parent, parts):
    from dpgo_tpu_torch.utils import Spans
    children = [r for r in Spans.records() if r.parent == parent.seq]
    assert {r.name for r in children} == set(parts)
    return sum(r.host_s for r in children)


def test_build_and_init_spans_cover_their_parents():
    """Every part of `build` and `init` after building and starting a small
    graph on the CPU, each a child of its phase, the children covering at
    least 95% of it (self time under 5%)."""
    from dpgo_tpu_torch.utils import Spans
    solver = _solver()
    solver.initialize()
    (build,), (init,) = Spans.records("build"), Spans.records("init")
    assert build.end_ns <= init.start_ns
    for parent, parts in ((build, BUILD_PARTS), (init, INIT_PARTS)):
        covered = _cover(parent, parts)
        assert 0.95 * parent.host_s <= covered <= parent.host_s
    for r in Spans.records():
        assert r.solve is None and r.end_ns is not None
    # The build's upload: in build_node_problems and in the constructor.
    assert len(Spans.records("build.upload")) == 2


def test_captured_seconds_come_from_the_spans(monkeypatch):
    """graph_nodes.warm_and_capture with the card's calls stubbed out on the
    CPU: the warm-up and capture are the spans "graph.warmup" and
    "graph.capture", Captured's seconds are theirs, `fn` runs on the warm
    and capture routes (where a span refuses), and graph_stats() keeps its
    keys."""
    from dpgo_tpu_torch.ops import _build, graph_nodes
    from dpgo_tpu_torch.utils import Spans, current_route, span

    cuda = types.SimpleNamespace(
        synchronize=lambda *a: None, empty_cache=lambda: None,
        memory_reserved=lambda *a: 0, CUDAGraph=lambda: "graph",
        graph_pool_handle=lambda: None, get_sync_debug_mode=lambda: 0,
        set_sync_debug_mode=lambda m: None)
    monkeypatch.setattr(graph_nodes.torch, "cuda", cuda)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(graph_nodes, "warm_streams", lambda dev: None)
    monkeypatch.setattr(graph_nodes, "capture", lambda *a: contextlib.
                        nullcontext("pool"))
    routes = []

    def fn():
        routes.append(current_route())
        with pytest.raises(RuntimeError):
            with span("inside"):
                pass
        return torch.ones(2)

    cap = graph_nodes.warm_and_capture(torch.device("cpu"), fn)
    assert routes == ["warm", "capture"]
    (warm,), (capt,) = (Spans.records("graph.warmup"),
                        Spans.records("graph.capture"))
    assert [r.name for r in Spans.records()] == ["graph.warmup",
                                                 "graph.capture"]
    assert (cap.warmup_s, cap.capture_s) == (warm.host_s, capt.host_s)
    assert warm.solve is None and capt.solve is None
    solver = _solver()
    solver._graph = types.SimpleNamespace(captured=cap)
    assert set(solver.graph_stats()) == {"capture_s", "warmup_s",
                                         "pool_bytes"}
    assert solver.graph_stats()["capture_s"] == capt.host_s


# ------------------------------------------------- the benchmark's readers


class _Event:
    """A stand-in for a timing CUDA event: its card time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _readings(card="NVIDIA H100 80GB HBM3", steps=0, traced_steps=0):
    from pgobench.cell import Readings
    return Readings(card=card, num_nodes=16, num_poses=10195, d=3,
                    spans={}, steps=steps, counters={}, host_syncs=0,
                    traced_steps=traced_steps, traced_counters={},
                    trace=None)


def _push(name, start_ns, end_ns, steps=0, card_ms=None):
    from dpgo_tpu_torch.utils import SpanRecord, Spans
    rec = SpanRecord(seq=len(Spans.records()), name=name, parent=None,
                     solve=None, start_ns=start_ns, end_ns=end_ns,
                     steps=steps)
    if card_ms is not None:
        rec.start_event, rec.end_event = (_Event(card_ms[0]),
                                          _Event(card_ms[1]))
    Spans._ring.append(rec)
    return rec


@pytest.mark.parametrize("metric,name", [
    ("build_assemble_s", "build.assemble"), ("build_linalg_s", "build.linalg"),
    ("init_chordal_s", "init.chordal")])
def test_host_span_readers(metric, name, monkeypatch):
    from dpgo_tpu_torch import utils
    from pgobench import manifest
    reader = manifest.reader(metric)
    r = _readings()
    assert reader.read(r) is None  # no such span in the ring
    _push(name, 0, 1_500_000_000)
    _push("other", 0, 7_000_000_000)
    _push(name, 2_000_000_000, 2_250_000_000)
    assert reader.read(r) == pytest.approx(1.75)
    assert reader.read(_readings(card="cpu")) == pytest.approx(1.75)
    monkeypatch.delattr(utils, "Spans")  # a program without spans
    assert reader.read(r) is None


def _solves(gaps, start_ms=0.0, steps=150, solve_ms=400.0):
    """Solve records back to back, the card's gap before each given."""
    t = start_ms
    out = []
    for gap in gaps:
        t += gap
        out.append(_push("solve", 0, 1, steps=steps,
                         card_ms=(t, t + solve_ms)))
        _push("gather", 0, 1)
        t += solve_ms
    return t


def test_solve_gap_reader_reads_the_window(monkeypatch):
    """The median card gap between the window's consecutive solves: the
    settle's solves before the window and the traced ones after it are
    left out (their gaps differ, so a wrong window reads otherwise)."""
    from dpgo_tpu_torch import utils
    from pgobench import manifest
    reader = manifest.reader("solve_gap_ms")
    t = _solves([50.0, 40.0, 30.0])            # settle
    t = _solves([20.0, 2.0, 3.0, 9.0, 4.0], t)   # window: gaps 2, 3, 9, 4
    _solves([70.0, 80.0], t)                   # traced
    r = _readings(steps=5 * 150, traced_steps=2 * 150)
    assert reader.read(r) == pytest.approx(3.5)
    assert reader.read(_readings(card="cpu", steps=5 * 150,
                                 traced_steps=2 * 150)) is None
    monkeypatch.delattr(utils, "Spans")
    assert reader.read(r) is None


def test_solve_gap_reader_none_where_the_ring_lost_the_window():
    from pgobench import manifest, spans
    reader = manifest.reader("solve_gap_ms")
    t = _solves([1.0, 2.0, 3.0])  # 3 solves left of a 5-solve window
    _solves([5.0, 6.0], t)
    assert reader.read(_readings(steps=5 * 150,
                                 traced_steps=2 * 150)) is None
    solves = [types.SimpleNamespace(steps=s) for s in (10, 10, 10)]
    assert spans.window_solves(solves, 20, 10) == solves[:2]
    assert spans.window_solves(solves, 30, 10) is None
    assert spans.window_solves(solves, 10, 30) is None


def test_card_times_on_the_host_clock():
    """The oldest solve's start event anchors the card's clock to the
    host's: an event's host time is the anchor's recording time plus the
    card's milliseconds since the anchor; card_ms reads between records."""
    from dpgo_tpu_torch.utils import Spans
    first = _push("solve", 0, 1, steps=150, card_ms=(10.0, 410.0))
    first.start_event_ns = 5_000_000
    gather = _push("gather", 0, 1, card_ms=(410.5, 411.0))
    second = _push("solve", 0, 1, steps=150, card_ms=(412.0, 812.0))
    assert Spans.card_ms(first, second) == pytest.approx(2.0)
    assert Spans.card_ms(first, first, "start", "end") == pytest.approx(400.0)
    assert Spans.on_host_clock(first) == 5_000_000
    assert Spans.on_host_clock(gather, "end") == 5_000_000 + 401_000_000
    assert Spans.on_host_clock(second, "start") == 5_000_000 + 402_000_000
