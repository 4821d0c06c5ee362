"""Conditional nodes of a CUDA graph under capture (`csrc/graph_cond.cu`):
the IF and WHILE nodes that `utils.device_cond` and `utils.bounded_while`
record on the graph route.

PyTorch's `torch.cuda.CUDAGraph` captures straight-line streams only on the
card's PyTorch (`begin_capture_to_if_node` arrived in later releases), so the
nodes are made here with the CUDA runtime, through the package's plain-C
library. `conditional(flag, kind)` is a context manager used while a
`torch.cuda.graph` capture is underway: it appends the node after the work
captured so far, makes a child stream PyTorch's current stream, so that the
body's operations (kernel launches, cuBLAS calls, copies) are recorded into
the node's body graph, and ends that capture on exit. A WHILE body calls
`again(handle, flag)` last: the body runs again while `flag` is set.

The bodies' allocations come from a private pool of their own: `capture`
asks the caching allocator to route the allocations of this thread that the
capture's own pool does not take (it matches only the stream the capture
began on) into a second pool, kept beside the graph. Nesting depth d uses child
stream d, so sibling bodies at one depth share a stream and its cached
blocks; bodies run in graph order, so a block freed by one body is safe for
the next.

Over NCCL the groups run with NCCL_GRAPH_MIXING_SUPPORT=0
(parallel/launch.py), which admits collectives inside conditional bodies
above world size 1; NCCL then asks that no collective be launched outside
a graph while a graph launch is outstanding, so every replay goes through
`replay` and the collectives `settle` the card before an uncaptured launch.

Nothing here runs at import time; the library is loaded at the first
warm-up or capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc

import torch

from dpgo_tpu_torch.ops import _build
from dpgo_tpu_torch.utils import DeviceCounters, flatten, route, span

IF, WHILE = 0, 1


class _Capture:
    """The capture underway in this process (one at a time): its device and
    pool, and the child streams by nesting depth."""

    active = None   # (device index, pool handle) while capturing
    depth = 0
    streams: dict = {}   # (device index, depth) -> torch.cuda.Stream
    outstanding = False  # a replay since the last settle


def child_stream(index: int, depth: int) -> torch.cuda.Stream:
    """The child stream of nesting depth `depth` on device `index`, made
    (outside any capture) on first use."""
    key = (index, depth)
    s = _Capture.streams.get(key)
    if s is None:
        s = torch.cuda.Stream(device=index)
        _Capture.streams[key] = s
    return s


def warm_streams(device: torch.device, depth: int = 8) -> None:
    """Make the child streams of depths 1..depth and let each run one cuBLAS
    product, so that the library's per-stream handles and workspaces exist
    before a capture (none is made inside one)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    # The flag kernel's launch counter, made before any capture.
    DeviceCounters.bump("graph_cond", torch.device("cuda", index), 0)
    a = torch.ones(8, 8, device=device)
    cur = torch.cuda.current_stream(device)
    for d in range(1, depth + 1):
        s = child_stream(index, d)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                x = a.to(dt)
                (x @ x).sum()
                torch.bmm(x[None], x[None])
        cur.wait_stream(s)
    torch.cuda.synchronize(device)
    _Capture.outstanding = False


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device, pool):
    """`torch.cuda.graph(graph, pool=pool)` on `device`. The allocations of
    the conditional bodies (on child streams, which the capture's own pool
    routing does not match) go to a second private pool, yielded: keep it
    as long as the graph. The capture mode is thread-local, as the bodies'
    are: other threads of the process (ProcessGroupNCCL's watchdog, which
    queries the events of earlier collectives) may call the runtime while
    the capture is underway."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if _Capture.active is not None:
        raise RuntimeError("a graph capture is already underway")
    _build.load()  # the nodes' library, loaded outside the capture
    body_pool = torch.cuda.MemPool()
    with torch.cuda.device(index), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        torch._C._cuda_beginAllocateCurrentThreadToPool(index, body_pool.id)
        _Capture.active = (index, pool)
        try:
            yield body_pool
        finally:
            _Capture.active = None
            _Capture.depth = 0
            torch._C._cuda_endAllocateToPool(index, body_pool.id)
            torch._C._cuda_releasePool(index, body_pool.id)


@contextlib.contextmanager
def conditional(flag: torch.Tensor, kind: int):
    """Record an IF (`kind=IF`) or WHILE (`kind=WHILE`) node on `flag`, a
    0-d bool tensor on the card, after the work captured so far on the
    current stream; the block's operations form the node's body. Yields the
    node's handle (for `again`)."""
    if _Capture.active is None:
        raise RuntimeError("conditional nodes exist only inside capture()")
    if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
        raise ValueError("a conditional node takes a one-element bool tensor "
                         f"on the card, got {flag.dtype} {tuple(flag.shape)} "
                         f"on {flag.device}")
    flag = flag.reshape(()).contiguous()
    index = _Capture.active[0]
    parent = torch.cuda.current_stream(index)
    _Capture.depth += 1
    child = child_stream(index, _Capture.depth)
    lib = _build.load()
    handle = ctypes.c_ulonglong()
    _build.check(lib.dpgo_cond_begin(parent.cuda_stream, child.cuda_stream,
                                     flag.data_ptr(), kind,
                                     ctypes.byref(handle)),
                 "graph conditional node")
    DeviceCounters.bump("graph_cond", flag.device)
    try:
        with torch.cuda.stream(child):
            yield handle.value
    finally:
        _Capture.depth -= 1
        _build.check(lib.dpgo_cond_end(child.cuda_stream),
                     "graph conditional body")


def again(handle: int, flag: torch.Tensor) -> None:
    """Last operation of a WHILE body: the body runs again while `flag`
    (0-d bool on the card) is set."""
    flag = flag.reshape(()).contiguous()
    stream = torch.cuda.current_stream(flag.device).cuda_stream
    _build.check(_build.load().dpgo_cond_set(handle, flag.data_ptr(), stream),
                 "graph conditional set")
    DeviceCounters.bump("graph_cond", flag.device)


def replay(graph: torch.cuda.CUDAGraph) -> None:
    """Launch a captured graph (marks a launch outstanding: `settle`)."""
    graph.replay()
    _Capture.outstanding = True


def settle(device: torch.device) -> None:
    """Before a collective launched outside a capture: wait for the card
    if a graph was replayed since the last wait (NCCL without graph-mixing
    support asks that no uncaptured collective follow an outstanding graph
    launch). One host wait per run of replays; nothing inside a capture."""
    if _Capture.outstanding and _Capture.active is None:
        torch.cuda.synchronize(device)
        _Capture.outstanding = False


NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "event_wait", "event_record", "ext_semaphore_signal",
              "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def capture_node_types(stream=None, cap: int = 4096) -> list:
    """The types of the nodes recorded so far into the graph `stream` (the
    current stream) is capturing into: a body graph on a conditional
    node's child stream. Child graphs are expanded after their node, their
    nodes' names prefixed by "child:" per level. A diagnostic of what a
    library call records under capture."""
    stream = stream or torch.cuda.current_stream()
    out = (ctypes.c_int * cap)()
    n = ctypes.c_int()
    _build.check(_build.load().dpgo_capture_node_types(
        stream.cuda_stream, out, cap, ctypes.byref(n)), "graph node types")
    names = []
    for code in out[:min(n.value, cap)]:
        depth, kind = divmod(code, 256)
        name = NODE_TYPES[kind] if kind < len(NODE_TYPES) else f"type{kind}"
        names.append("child:" * depth + name)
    return names


@dataclasses.dataclass
class Captured:
    """A program captured by `warm_and_capture`: the graph, what the
    captured call returned (tensors the graph writes at every replay), the
    body pool to keep beside the graph, and the seconds and bytes it
    took."""

    graph: torch.cuda.CUDAGraph
    out: object
    body_pool: object
    warmup_s: float
    capture_s: float
    pool_bytes: int
    replay_events: tuple = ()

    def replay_s(self) -> float:
        """Seconds of the replay `run_once` made, from CUDA events recorded
        around it (waits for the second)."""
        start, end = self.replay_events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def warm_and_capture(device: torch.device, fn) -> Captured:
    """Capture `fn()` as one CUDA graph on `device` (its `device_cond` and
    `bounded_while` become IF and WHILE nodes).

    First one call on the "warm" route (both branches, one trip per loop,
    its result thrown away, the device counters restored), so that no lazy
    set-up (the kernel library, K1's occupancy query, cuBLAS handles, an
    NCCL communicator) happens inside the capture, under
    torch.cuda.set_sync_debug_mode("error"), so that a host read in `fn`
    raises there, before the capture begins: a failed capture never leaves
    one half made. Then the capture, which raises if the runtime refuses
    an operation; there is no fallback to the host-read route. Spans
    "graph.warmup" and "graph.capture" time the two (`Captured.warmup_s`,
    `capture_s`)."""
    with span("graph.warmup", setup=True) as warm:
        _build.load()  # the kernel library, before any route but the host's
        warm_streams(device)
        snap = DeviceCounters.snapshot()
        # Garbage first: freeing a graph synchronizes, which under the
        # sync-debug mode below raises inside a destructor (an abort).
        gc.collect()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with route("warm"):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(device)
        DeviceCounters.restore(snap)

    # (torch.cuda.graph empties the cache on entry too.)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with span("graph.capture", setup=True) as cap:
        with capture(graph, device, torch.cuda.graph_pool_handle()) \
                as body_pool, route("capture"):
            out = fn()
        torch.cuda.synchronize(device)
    return Captured(graph=graph, out=out, body_pool=body_pool,
                    warmup_s=warm.host_s, capture_s=cap.host_s,
                    pool_bytes=torch.cuda.memory_reserved(device) - reserved)


def run_once(device: torch.device, fn):
    """`fn()` captured (`warm_and_capture`) and replayed once: a copy of
    what it returns (a tree of tensors, `utils.flatten`), made after the
    replay on the same stream, and the Captured record (the replay sits
    between two CUDA events: `Captured.replay_s`). Nothing is read on the
    host."""
    cap = warm_and_capture(device, fn)
    cap.replay_events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
    cap.replay_events[0].record()
    replay(cap.graph)
    cap.replay_events[1].record()
    leaves, rebuild = flatten(cap.out)
    return rebuild([x.clone() for x in leaves]), cap
