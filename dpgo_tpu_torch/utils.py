"""Small shared utilities, and the step's control flow.

`device_cond`, `bounded_while` and `fixed_loop` are the port's counterparts
of the JAX package's `lax.cond`, bounded `lax.while_loop` and
`lax.fori_loop`. They take one of three routes, set for the process by
`route(...)`:

- "host" (the default; the CPU route and the eager route on the card): the
  flag is read on the host (`HostSyncs.flag`) and Python takes one branch or
  runs one more trip;
- "capture" (the graph route on the card, inside `graph_nodes.capture`): a
  branch becomes an IF node of the CUDA graph and a loop a WHILE node, so
  the flag is read on the card when the graph runs and never by the host;
- "trace": both branches and every trip run, merged with `torch.where`,
  the JAX semantics (a skipped branch equals the taken one with all-false
  flags). The CPU tests use it to show that every body is a function of its
  operands alone; "warm" is the same with each loop cut to one trip, the
  warm-up before a capture (every operation of the step runs once, its
  result is thrown away).

`DeviceCounters` counts on the device (kernel launches, loop entries and
trips, master fallbacks): inside a graph the counts move at every replay,
which a Python integer bumped at capture time cannot. `Spans` records the
program's phases on the host clock, and a solve's on the card's too.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the CUDA card unless the caller
    names another (`device="cpu"` for the CPU). Raises when a CUDA device is
    asked for on a host without one; never picks the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dpgo_tpu_torch runs on a CUDA card by default and "
                           "this host has none; pass device='cpu' to run on "
                           "the CPU")
    return dev


class HostSyncs:
    """Counts the device-to-host reads of control flags.

    The JAX package keeps the whole step on the device (`lax.scan`,
    `lax.cond`, `lax.while_loop`). On the host route this port reads those
    loop and branch flags on the host (`device_cond`, `bounded_while`); each
    read waits for the device. On the graph route nothing is read and
    nothing counts here (the loops count in `DeviceCounters`). The solver
    owns one counter and reports syncs per step.
    PCM reads one consistency mask per node pair through `read`, which
    counts the same way.

    `loops` holds, per host-driven loop that reports to it by name
    ("seg_cg": the segment path's translation CG, "stpcg": the torch STPCG,
    "lobpcg": the certificate's eigensolver), [times entered, trips in all];
    the certificate's host round trips report there too, one trip each
    ("lred_host": the host SuperLU solve inside S above the dense limit,
    "apply_S_host": an ARPACK matvec, "schur_host": the shift-invert
    preconditioner).
    """

    def __init__(self):
        self.count = 0
        self.loops: dict[str, list[int]] = {}

    def flag(self, x: torch.Tensor) -> bool:
        self.count += 1
        return bool(x)

    def read(self, x: torch.Tensor):
        """One read of a whole tensor (a mask) to the host, as numpy."""
        self.count += 1
        return x.cpu().numpy()

    def note(self, loop: str, trips: int) -> None:
        entry = self.loops.setdefault(loop, [0, 0])
        entry[0] += 1
        entry[1] += trips


class Stopwatch:
    """tick()/tock() wall-clock timer (the reference's
    Optimization::Util::Stopwatch); tock returns seconds since tick.
    `tock(sync=x)` first waits for the card that holds tensor `x` (or for
    the CUDA device `x`), since the card runs behind the host."""

    def __init__(self):
        self._t0 = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self, sync=None) -> float:
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) \
                else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if self._t0 is None:
            raise RuntimeError("tock() before tick()")
        return time.perf_counter() - self._t0


# ----------------------------------------------------------- control flow

ROUTES = ("host", "trace", "warm", "capture")


class _Route:
    """The process's control-flow route, and under "trace" / "warm" the
    flag of the branch or trip being run (the conjunction of the enclosing
    ones; None at top level)."""

    mode = "host"
    live = None


@contextlib.contextmanager
def route(mode: str):
    """Run the block's `device_cond` / `bounded_while` on route `mode`."""
    if mode not in ROUTES:
        raise ValueError(f"unknown control-flow route {mode!r}")
    saved = (_Route.mode, _Route.live)
    _Route.mode, _Route.live = mode, None
    try:
        yield
    finally:
        _Route.mode, _Route.live = saved


def current_route() -> str:
    return _Route.mode


@contextlib.contextmanager
def _live(flag: torch.Tensor):
    """Trace: the block runs as if under `flag` (counters move only where
    it and every enclosing flag hold)."""
    saved = _Route.live
    _Route.live = flag if saved is None else saved & flag
    try:
        yield
    finally:
        _Route.live = saved


def flatten(x):
    """(tensor leaves, rebuild) of a tensor or of tuples, lists, named
    tuples and dataclasses of them; other leaves (None, numbers) are kept
    as they are and must not differ between the trees a merge takes."""
    leaves = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            return None
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return (type(v), [walk(u) for u in v])
        if isinstance(v, (tuple, list)):
            return (type(v), [walk(u) for u in v])
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return (v, {f.name: walk(getattr(v, f.name))
                        for f in dataclasses.fields(v) if f.init})
        return ("leaf", v)

    spec = walk(x)

    def rebuild(new):
        it = iter(new)

        def build(sp):
            if sp is None:
                return next(it)
            kind, body = sp
            if isinstance(kind, str):
                return body
            if isinstance(kind, type):
                vals = [build(u) for u in body]
                return kind(*vals) if hasattr(kind, "_fields") else kind(vals)
            return dataclasses.replace(
                kind, **{n: build(u) for n, u in body.items()})

        return build(spec)

    return leaves, rebuild


def _merge(flag: torch.Tensor, a, b):
    """Per the 0-d `flag`: tree a where set, else tree b."""
    la, rebuild = flatten(a)
    lb, _ = flatten(b)
    return rebuild([torch.where(flag, x, y) for x, y in zip(la, lb)])


def _copy_into(bufs: list, new: list) -> None:
    """bufs[i] <- new[i] in place, where a new leaf may be (or share memory
    with) a buffer: those are copied aside first, so no copy reads a
    buffer an earlier copy wrote."""
    held = {b.untyped_storage().data_ptr() for b in bufs}
    src = []
    for b, x in zip(bufs, new):
        if x is b:
            src.append(None)
        elif x.untyped_storage().data_ptr() in held:
            src.append(x.clone())
        else:
            src.append(x)
    for b, x in zip(bufs, src):
        if x is not None:
            b.copy_(x)


def device_cond(pred: torch.Tensor, true_fn, false_fn, operands=(),
                syncs: HostSyncs | None = None):
    """`true_fn(*operands)` where the 0-d bool `pred` holds, else
    `false_fn(*operands)`: the counterpart of `lax.cond`. Both return trees
    of tensors of the same structure, shapes and types. Host route: one
    flag read (counted in `syncs`). Capture: two IF nodes, on `pred` and on
    its negation; the taken branch's result is copied into buffers the
    first branch allocates. Trace: both run, merged."""
    mode = _Route.mode
    if mode == "host":
        take = (syncs or HostSyncs()).flag(pred)
        return (true_fn if take else false_fn)(*operands)
    if mode in ("trace", "warm"):
        with _live(pred):
            a = true_fn(*operands)
        with _live(~pred):
            b = false_fn(*operands)
        return _merge(pred, a, b)
    from dpgo_tpu_torch.ops import graph_nodes
    npred = ~pred
    with graph_nodes.conditional(pred, graph_nodes.IF):
        leaves, rebuild = flatten(true_fn(*operands))
        bufs = [x.clone() for x in leaves]
    with graph_nodes.conditional(npred, graph_nodes.IF):
        other, _ = flatten(false_fn(*operands))
        _copy_into(bufs, other)
    return rebuild(bufs)


def bounded_while(max_trips: int, cond_fn, body_fn, carry,
                  syncs: HostSyncs | None = None, name: str | None = None):
    """At most `max_trips` trips of `carry = body_fn(carry, running)` while
    `running = cond_fn(carry)` (a bool tensor, one flag per lane) has a
    set lane: the counterpart of a `lax.while_loop` with a trip cap. The
    body keeps the lanes outside `running` as they were. `name` counts the
    loop's entries and trips in `DeviceCounters` (`name + ".entries"`,
    `name + ".trips"`) and, on the host route, in `syncs.note`.

    Host route: one flag read per trip (and one to leave). Capture: one
    WHILE node; the carry lives in buffers the body overwrites, its flag
    is recomputed at the body's end. Trace: every trip runs, each merged on
    its own flag."""
    mode = _Route.mode
    syncs = syncs or HostSyncs()
    if mode == "host":
        trips = 0
        while trips < max_trips:
            running = cond_fn(carry)
            if not syncs.flag(running.any()):
                break
            carry = body_fn(carry, running)
            trips += 1
        if name is not None:
            syncs.note(name, trips)
            dev = flatten(carry)[0][0].device
            DeviceCounters.bump(name + ".entries", dev)
            DeviceCounters.bump(name + ".trips", dev, trips)
        return carry
    leaves, rebuild = flatten(carry)
    dev = leaves[0].device
    trips = torch.zeros((), dtype=torch.int64, device=dev)
    if mode in ("trace", "warm"):
        for _ in range(max_trips if mode == "trace" else min(max_trips, 1)):
            running = cond_fn(carry)
            go = running.any()
            with _live(go):
                new = body_fn(carry, running)
            carry = _merge(go, new, carry)
            trips = trips + go.to(torch.int64)
    else:
        from dpgo_tpu_torch.ops import graph_nodes
        bufs = [x.clone() for x in leaves]
        carry = rebuild(bufs)
        running = cond_fn(carry).clone()
        go = running.any() & (max_trips > 0)
        with graph_nodes.conditional(go, graph_nodes.WHILE) as handle:
            new, _ = flatten(body_fn(rebuild(bufs), running))
            _copy_into(bufs, new)
            trips.add_(1)
            running.copy_(cond_fn(rebuild(bufs)))
            graph_nodes.again(handle, running.any() & (trips < max_trips))
        carry = rebuild(bufs)
    if name is not None:
        DeviceCounters.bump(name + ".entries", dev)
        DeviceCounters.bump(name + ".trips", dev, trips)
    return carry


def fixed_loop(num_iters: int, body_fn, carry, name: str | None = None):
    """`carry = body_fn(carry)` exactly `num_iters` times: the counterpart
    of `lax.fori_loop`. `name` counts the loop's entries and trips in
    `DeviceCounters`, as `bounded_while` does.

    Host and trace routes: a Python loop that reads nothing on the host;
    warm: one trip. Capture: one WHILE node whose trip counter lives on the
    device (the body bumps it and runs again while it is below
    `num_iters`), so the graph holds one body whatever the trip count."""
    mode = _Route.mode
    leaves, rebuild = flatten(carry)
    dev = leaves[0].device
    if mode != "capture" or num_iters <= 0:
        trips = max(num_iters, 0)
        if mode == "warm":
            trips = min(trips, 1)
        for _ in range(trips):
            carry = body_fn(carry)
    else:
        from dpgo_tpu_torch.ops import graph_nodes
        bufs = [x.clone() for x in leaves]
        trips = torch.zeros((), dtype=torch.int64, device=dev)
        with graph_nodes.conditional(trips < num_iters,
                                     graph_nodes.WHILE) as handle:
            new, _ = flatten(body_fn(rebuild(bufs)))
            _copy_into(bufs, new)
            trips.add_(1)
            graph_nodes.again(handle, trips < num_iters)
        carry = rebuild(bufs)
    if name is not None:
        DeviceCounters.bump(name + ".entries", dev)
        DeviceCounters.bump(name + ".trips", dev, trips)
    return carry


class DeviceCounters:
    """Named int64 counters on the device, bumped by the step itself: a
    kernel wrapper where it launches its kernel ("polar_so3",
    "polar_so3_f64", "stpcg", "stpcg_d2"; kernel K3 bumps "block_mm"
    inside its own launch), `bounded_while` per loop
    ("seg_cg", "stpcg", "tnt": `.entries`, `.trips`), `fixed_loop` per loop
    (DChordal's "dchordal.reduced_R" and the like), the master tests of
    AMM-PGO* through `bump_tensor`. Under "trace" a bump counts only where
    the enclosing branch and trip flags hold, so the trace route counts
    what the host route takes. A counter is made at its first bump, which
    must come before any capture (the warm-up step reaches every one);
    `reset` zeroes them in place, so a captured graph keeps counting into
    the same tensors."""

    _t: dict = {}

    @classmethod
    def _key(cls, name: str, device) -> tuple:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return name, dev

    @classmethod
    def tensor(cls, name: str, device) -> torch.Tensor:
        """The counter's int64 tensor on `device`, made at its first use
        (for a kernel that bumps it inside its own launch)."""
        key = cls._key(name, device)
        t = cls._t.get(key)
        if t is None:
            if _Route.mode == "capture":
                raise RuntimeError(f"device counter {name!r} is first bumped "
                                   "inside a graph capture")
            t = cls._t[key] = torch.zeros((), dtype=torch.int64,
                                          device=key[1])
        return t

    @classmethod
    def bump(cls, name: str, device, by=1) -> None:
        bump_tensor(cls.tensor(name, device), by)

    @classmethod
    def read(cls, name: str) -> int:
        """The count, summed over devices; waits for the card."""
        return sum(int(t) for (n, _), t in cls._t.items() if n == name)

    @classmethod
    def reset(cls) -> None:
        for t in cls._t.values():
            t.zero_()

    @classmethod
    def snapshot(cls) -> dict:
        return {k: t.clone() for k, t in cls._t.items()}

    @classmethod
    def restore(cls, snap: dict) -> None:
        """Counters back to a snapshot (new ones since to zero)."""
        for k, t in cls._t.items():
            if k in snap:
                t.copy_(snap[k])
            else:
                t.zero_()


def live_flag() -> torch.Tensor | None:
    """The 0-d bool flag of the branch or trip being run on the trace or
    warm route (the conjunction of the enclosing ones), None elsewhere."""
    return _Route.live


def bump_tensor(t: torch.Tensor, by=1) -> None:
    """t += by in place, where the trace route's enclosing flags hold."""
    if _Route.live is not None:
        by = _Route.live.to(torch.int64) * by
    t.add_(by)


def sync(device) -> None:
    """Wait for the card (nothing on another device)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def open_device(device) -> None:
    """Touch the device and wait for it: on a CUDA card the first touch in
    a process makes its context."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros((), device=dev)
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(eq=False, slots=True)
class SpanRecord:
    """One span (`Spans.span`). Host times are `time.perf_counter_ns()`.
    `parent` is the `seq` of the innermost span open at its start, `solve`
    the count of graph-route solves (`DPGOSolver.run_steps`) at its start,
    None for a set-up span, and `steps` the solver steps a solve ran. A
    span on a CUDA device holds two timing events on the stream that was
    current, recorded at its start and end (or where `mark_start` /
    `mark_end` place them), each beside the host time of its recording."""

    seq: int
    name: str
    parent: int | None
    solve: int | None
    start_ns: int
    end_ns: int | None = None
    steps: int = 0
    start_event: object = None
    end_event: object = None
    start_event_ns: int | None = None
    end_event_ns: int | None = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def mark_start(self) -> None:
        """Record the start event here (again, where it was recorded at the
        span's start)."""
        if self.start_event is not None:
            self.start_event.record()
            self.start_event_ns = time.perf_counter_ns()

    def mark_end(self) -> None:
        """Record the end event here; the span's exit then leaves it."""
        if self.end_event is not None:
            self.end_event.record()
            self.end_event_ns = time.perf_counter_ns()


class Spans:
    """The program's spans: set-up phases (`build`, `init` and their parts,
    the kernel library's load, the warm-up and capture of a captured
    program) and a few per solve (`solve`, its `solve.load` and
    `solve.result`, `gather`). Always on; none opens inside a captured
    body (on the "warm" or "capture" route a span raises), so a span costs
    a few host microseconds and never waits for the card.

    The records stay in memory in a ring of RING records (a solve makes 4,
    so a run of a thousand solves and its set-up fit with room to spare);
    older records are dropped. `records`, `host_s` and `card_ms` read them
    back. The first solve's start event, recorded while the stream is idle,
    puts the card's clock on the host's (`on_host_clock`)."""

    RING = 8192

    _ring: collections.deque = collections.deque(maxlen=RING)
    _open: list = []
    _seq = 0
    solves = 0  # graph-route solves so far

    @classmethod
    @contextlib.contextmanager
    def span(cls, name: str, device=None, setup: bool = False):
        """A span named `name` around the block; yields its SpanRecord.
        `device`: with a CUDA device, timing events on the current stream
        at its start and end. `setup`: a one-shot set-up phase, which
        carries no solve index."""
        if _Route.mode in ("warm", "capture"):
            raise RuntimeError(f"span {name!r} opened on the {_Route.mode!r} "
                               "route: no span goes inside a captured body")
        rec = SpanRecord(seq=cls._seq, name=name,
                         parent=cls._open[-1].seq if cls._open else None,
                         solve=None if setup else cls.solves,
                         start_ns=time.perf_counter_ns())
        cls._seq += 1
        if device is not None and torch.device(device).type == "cuda":
            rec.start_event = torch.cuda.Event(enable_timing=True)
            rec.end_event = torch.cuda.Event(enable_timing=True)
            rec.mark_start()
        cls._ring.append(rec)
        cls._open.append(rec)
        try:
            yield rec
        finally:
            cls._open.pop()
            if rec.end_event_ns is None:
                rec.mark_end()
            rec.end_ns = time.perf_counter_ns()

    @classmethod
    def next_solve(cls) -> int:
        """Count one more solve; returns its index (from 1)."""
        cls.solves += 1
        return cls.solves

    @classmethod
    def records(cls, name: str | None = None) -> list:
        """The records in the ring, oldest first (those named `name`)."""
        return [r for r in cls._ring if name is None or r.name == name]

    @classmethod
    def host_s(cls, name: str) -> float | None:
        """Host seconds of the ended records named `name`, summed; None
        where the ring holds none."""
        recs = [r for r in cls.records(name) if r.end_ns is not None]
        return sum(r.host_s for r in recs) if recs else None

    @classmethod
    def card_ms(cls, a: SpanRecord, b: SpanRecord, frm: str = "end",
                to: str = "start") -> float:
        """The card's milliseconds from record a's `frm` event ("start" or
        "end") to record b's `to` event; waits for the later one."""
        ea, eb = getattr(a, frm + "_event"), getattr(b, to + "_event")
        eb.synchronize()
        return ea.elapsed_time(eb)

    @classmethod
    def on_host_clock(cls, rec: SpanRecord, which: str = "start") -> int:
        """The time at which the card reached `rec`'s `which` event, in
        host nanoseconds: the oldest solve in the ring (its start event
        recorded while the stream was idle) anchors the two clocks."""
        anchor = next(r for r in cls._ring
                      if r.name == "solve" and r.start_event is not None)
        return anchor.start_event_ns + round(
            1e6 * cls.card_ms(anchor, rec, "start", which))

    @classmethod
    def reset(cls) -> None:
        """Empty the ring (open spans still close) and the solve count."""
        cls._ring.clear()
        cls.solves = 0


span = Spans.span
