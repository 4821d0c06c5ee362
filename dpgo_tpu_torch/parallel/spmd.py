"""The node axis split over the ranks of a `torch.distributed` process
group (torch port of dpgo_tpu/parallel/spmd.py).

The JAX package lays the node axis over a device mesh with `shard_map`; here
each rank of a process group holds the nodes [r * npd, (r + 1) * npd),
npd = N / world_size, builds only their problems, and runs the same
per-node code as the single-process solver on them. The halo (separator)
exchange and the global sums are collectives of the group:

- "boundary" (default): each rank gathers its nodes' boundary poses (the
  poses some other node reads) into a [npd, B] buffer, one all_gather makes
  the [N, B] buffer on every rank, and each halo entry is read back by
  (owner, slot);
- "gather": one all_gather of the whole own blocks [N, n0_max];
- "ring": the boundary buffers rotate round the ring, rank r receiving from
  r + 1 and sending to r - 1 (`batch_isend_irecv`), for as many rounds as
  the widest rank distance any halo entry spans (`_ring_rounds`).

Translations and rotations travel in one packed buffer ([..., d + d * d]),
so an exchange is one collective per round. The objective pieces the
metrics and AMM-PGO*'s master need are `all_reduce` sums of per-rank sums.

Every master decision of AMM-PGO* and every loop that runs a collective
reads values that are equal on all ranks, so the ranks call the same
collectives in the same order. The flags the iterates read on the host
(`if syncs.flag(mask.any())`) are rank-local: every such branch is masked
per node and runs no collective.

Under gloo on a CUDA card (several ranks sharing one card) every buffer is
copied to the host before a collective and back after it; the copies are
counted (`Collectives.host_copies`). Over NCCL the captured programs hold
their collectives inside conditional bodies too (AMM-PGO*'s master
branches, the split polish's WHILE loops), which NCCL admits above world
size 1 only without its graph-mixing support (parallel/launch.py).

The polish splits the pose axis the same way (`PoseSplit`): a rank holds
the poses of its nodes and the edges touching them, fills the halo rows
those edges read through the same exchange, and runs the global TNT on its
rows with every inner product, objective share and coarse-level sum
all-reduced, so every rank takes the same trust-region and CG branches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
from dpgo_tpu_torch.graph import MultiGraph
from dpgo_tpu_torch.objective import SplitEdges
from dpgo_tpu_torch.problem import NodeState
from dpgo_tpu_torch.utils import DeviceCounters

HALO_STRATEGIES = ("gather", "boundary", "ring")

# The non-deprecated name where this torch has it.
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass
class HaloSchedule:
    """Compacted separator-exchange schedule (host-built, static).

    bnd[o, s] is the local pose index of owner o's s-th boundary pose (a pose
    some other node reads); halo_slot[a, h] maps node a's h-th halo entry to
    the owner's boundary-buffer slot. (The ring strategy's round count
    depends on the world size: `_ring_rounds`.)
    """

    bnd: np.ndarray        # [N, B] int32
    halo_slot: np.ndarray  # [N, n1_max] int32
    B: int


def build_halo_schedule(mg: MultiGraph) -> HaloSchedule:
    N = mg.num_nodes
    bnd_sets = [set() for _ in range(N)]
    for a in range(N):
        for h in range(mg.halo_owner.shape[1]):
            if mg.halo_mask[a, h]:
                bnd_sets[int(mg.halo_owner[a, h])].add(
                    int(mg.halo_lpose[a, h]))
    bnd_lists = [sorted(s) for s in bnd_sets]
    B = max([len(s) for s in bnd_lists] + [1])
    bnd = np.zeros((N, B), np.int32)
    slot_of = np.zeros((N, mg.n0_max), np.int32)
    for o, lst in enumerate(bnd_lists):
        if lst:
            bnd[o, :len(lst)] = lst
            slot_of[o, lst] = np.arange(len(lst), dtype=np.int32)
    halo_slot = slot_of[mg.halo_owner, mg.halo_lpose].astype(np.int32)
    return HaloSchedule(bnd=bnd, halo_slot=halo_slot, B=B)


def _ring_rounds(mg: MultiGraph, num_devices: int) -> int:
    """Max (owner_rank - reader_rank) mod D over real halo entries."""
    N = mg.num_nodes
    npd = N // num_devices
    rounds = 0
    for a in range(N):
        my_dev = a // npd
        for h in range(mg.halo_owner.shape[1]):
            if mg.halo_mask[a, h]:
                od = int(mg.halo_owner[a, h]) // npd
                rounds = max(rounds, (od - my_dev) % num_devices)
    return rounds


def take_nodes(x, lo: int, hi: int, num_nodes: int):
    """Rows [lo, hi) of every per-node array in `x`: a tensor or array with
    a leading node axis of length `num_nodes`, or a dataclass of them
    (NodeProblem, NodeState, MMState, StarState), whose other fields (the
    scalar master reference F, settings) are kept."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x[lo:hi] if x.ndim >= 1 and x.shape[0] == num_nodes else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: take_nodes(getattr(x, f.name), lo, hi, num_nodes)
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), (torch.Tensor, np.ndarray))
            or dataclasses.is_dataclass(getattr(x, f.name))})
    return x


class Collectives:
    """The collectives of one process group, with their counts.

    `calls` counts collectives (a ring round is one), `bytes` the bytes each
    landed in this rank's output buffer (its own share included), and
    `host_copies` the copies to and from the host that gloo needs for
    tensors on a CUDA card. These Python totals move when the host issues a
    collective: per step on the host-read route, but only at the warm-up
    and the capture on the graph route. The same counts are bumped on the
    device (`utils.DeviceCounters`: COUNTERS), where a captured collective
    counts at every replay, and a collective in a branch the trace route
    merges away counts nowhere, as on the host route."""

    COUNTERS = ("collectives", "collective_bytes", "collective_host_copies")

    def __init__(self, group=None, device=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device("cpu" if device is None else device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.host_copies = 0

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        if self.backend == "nccl" and self.device.type == "cuda":
            from dpgo_tpu_torch.ops import graph_nodes
            graph_nodes.settle(self.device)
        x = x.contiguous()
        if self.staged:
            self._copied()
            return x.cpu()
        return x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        if self.staged:
            self._copied()
            return x.to(self.device)
        return x

    def _copied(self) -> None:
        self.host_copies += 1
        DeviceCounters.bump("collective_host_copies", self.device)

    def _count(self, out: torch.Tensor) -> None:
        nbytes = out.numel() * out.element_size()
        self.calls += 1
        self.bytes += nbytes
        DeviceCounters.bump("collectives", self.device)
        DeviceCounters.bump("collective_bytes", self.device, nbytes)

    def _peer(self, r: int) -> int:
        r %= self.world_size
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenation of every rank's x along the leading axis, in rank
        order."""
        xw = self._wire(x)
        out = xw.new_empty((self.world_size * xw.shape[0],) + xw.shape[1:])
        _all_gather_into(out, xw, group=self.group)
        self._count(out)
        return self._back(out)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        xw = self._wire(x)
        if xw is x:  # reduced in place: not into the caller's tensor
            xw = x.clone()
        dist.all_reduce(xw, op=op, group=self.group)
        self._count(xw)
        return self._back(xw)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer of rank r + 1: x goes to rank r - 1."""
        xw = self._wire(x)
        out = torch.empty_like(xw)
        ops = [dist.P2POp(dist.isend, xw, self._peer(self.rank - 1),
                          self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank + 1),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._count(out)
        return self._back(out)

    def broadcast_flag(self, flag: bool, src: int = 0) -> bool:
        """Rank `src`'s flag on every rank."""
        x = torch.tensor([1.0 if flag else 0.0], device=self.device)
        xw = self._wire(x)
        dist.broadcast(xw, self._peer(src), group=self.group)
        self._count(xw)
        return bool(xw.item())


def _pack(t: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """[..., d] and [..., d, d] -> one [..., d + d * d] buffer."""
    return torch.cat([t, R.flatten(-2)], dim=-1)


def _unpack(x: torch.Tensor, d: int):
    return x[..., :d], x[..., d:].unflatten(-1, (d, d))


def _halo_exchange(comm: Collectives, t_own, R_own, owner_l, slot_l, bnd_l,
                   halo: str, ring_rounds: int, dc_l=None):
    """Halos (th, Rh) of this rank's nodes from every node's own state.

    All arrays carry the LOCAL node axis leading ([npd, ...]); owner_l holds
    GLOBAL owner node ids and slot_l = (boundary slot, owner-local pose).
    `dc_l` [npd, n1_max, d] re-expresses the owner's locally-centered
    translations in the reader's frame (local gauge centering,
    DPGOSolver.set_gauge)."""
    h = _exchange_packed(comm, _pack(t_own, R_own), owner_l, slot_l, bnd_l,
                         halo, ring_rounds)
    th, Rh = _unpack(h, t_own.shape[-1])
    return (th if dc_l is None else th + dc_l), Rh


def _exchange_packed(comm: Collectives, x, owner_l, slot_l, bnd_l,
                     halo: str, ring_rounds: int):
    """The halo rows [npd, n1_max, k] of this rank's nodes from every
    node's own rows x [npd, n0_max, k] (any k values per pose), by the
    strategy `halo`; the arguments as in `_halo_exchange`."""
    if halo == "gather":
        h = comm.all_gather(x)[owner_l, slot_l[1]]
    else:
        slot = slot_l[0]
        b = torch.arange(x.shape[0], device=x.device)[:, None]
        xb = x[b, bnd_l]                                # [npd, B, k]
        if halo == "boundary":
            h = comm.all_gather(xb)[owner_l, slot]
        else:
            D, npd = comm.world_size, x.shape[0]
            owner_dev = owner_l // npd
            owner_loc = owner_l % npd
            h = x.new_zeros(owner_l.shape + x.shape[-1:])
            buf = xb
            for r in range(ring_rounds + 1):
                take = owner_dev == (comm.rank + r) % D
                h = torch.where(take[..., None], buf[owner_loc, slot], h)
                if r < ring_rounds:
                    buf = comm.ring_shift(buf)
    return h


@dataclasses.dataclass
class PoseSplit:
    """This rank's share of the pose axis in the sharded polish.

    The rank owns poses [lo, hi): those of its nodes, which are contiguous.
    Its halo rows are the other ranks' poses its edges read, the off-rank
    entries of its nodes' halo tables (each pose once, by global id), so the
    node halo exchange fills them: the own rows are laid out in node blocks
    (`edges.node_rows`), exchanged, and the entries `halo_pick` of the
    flattened [npd * n1_max] result are kept."""

    lo: int
    hi: int
    halo_pick: torch.Tensor     # [H]
    halo: np.ndarray            # [H] global pose ids
    edges: SplitEdges
    counts: list                # poses per rank

    @staticmethod
    def build(solver: "_Sharded") -> "PoseSplit":
        mg = solver.mg
        a, b = solver.node_lo, solver.node_hi
        start, n0 = np.asarray(mg.start), np.asarray(mg.n0)

        def end(node):
            return int(start[node] + n0[node])

        lo, hi = int(start[a]), end(b - 1)
        npd = solver.nodes_per_rank
        counts = [end((r + 1) * npd - 1) - int(start[r * npd])
                  for r in range(solver.num_ranks)]
        owner = np.asarray(mg.halo_owner)[a:b]
        off = (np.asarray(mg.halo_mask)[a:b] & ((owner < a) | (owner >= b)))
        gid = (start[owner] + np.asarray(mg.halo_lpose)[a:b]).reshape(-1)
        flat = np.flatnonzero(off.reshape(-1))
        halo, first = np.unique(gid[flat], return_index=True)

        def ix(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=solver.device)

        return PoseSplit(
            lo=lo, hi=hi, halo_pick=ix(flat[first]), halo=halo,
            edges=SplitEdges.build(solver.edges, solver.part.node_of, a, b,
                                   halo),
            counts=counts)


class _Sharded:
    """What the sharded solvers add to DPGOSolver / DPGOStarSolver: the node
    range of this rank, its own problems, the halo exchange and the sums
    over ranks.

    `group` is a process group the caller made (None: the default group,
    which must exist; `parallel.launch` makes one); its backend is used as
    it is. `device` is this rank's device (the CUDA card unless named)."""

    def __init__(self, meas, num_nodes: int, *args, group=None,
                 halo: str = "boundary", **kw):
        if not dist.is_initialized():
            raise RuntimeError("the sharded solvers need a torch.distributed "
                               "process group (parallel.launch makes one)")
        world = dist.get_world_size(group)
        if num_nodes % world != 0:
            raise ValueError(
                f"num_nodes ({num_nodes}) must be divisible by the number "
                f"of ranks ({world})")
        if halo not in HALO_STRATEGIES:
            raise ValueError(f"unknown halo strategy {halo!r}")
        self.halo = halo
        self.num_ranks = world
        self.nodes_per_rank = num_nodes // world
        rank = dist.get_rank(group)
        self.node_lo = rank * self.nodes_per_rank
        self.node_hi = self.node_lo + self.nodes_per_rank
        self._group = group
        self._split = None
        super().__init__(meas, num_nodes, *args, **kw)
        sched = build_halo_schedule(self.mg)
        self.halo_sched = sched
        # Read by the ring strategy only.
        self.ring_rounds = _ring_rounds(self.mg, world)

        def ix(x):
            return torch.as_tensor(
                np.asarray(self._mine(x), np.int64), device=self.device)

        # Owner ids stay global; the rows are this rank's nodes (bnd: the
        # boundary poses its nodes own).
        self.halo_owner = ix(self.mg.halo_owner)
        self.halo_lpose = ix(self.mg.halo_lpose)
        self.halo_slot = ix(sched.halo_slot)
        self.bnd = ix(sched.bnd)

    def _mine(self, x):
        return take_nodes(x, self.node_lo, self.node_hi, self.num_nodes)

    # ------------------------------------------------------- build hooks

    def _build_problems(self, **kw):
        """This rank's nodes only, with the widths padded to a maximum over
        nodes (null-space and inter-pose columns, segment pairs) made equal
        on all ranks: every rank then holds exactly its rows of the whole
        build."""
        self.comm = Collectives(self._group, self.device)
        probs = super()._build_problems(nodes=(self.node_lo, self.node_hi),
                                        **kw)
        names = [f.name for f in dataclasses.fields(probs)
                 if isinstance(getattr(probs, f.name), torch.Tensor)]
        shapes = [list(getattr(probs, n).shape) for n in names]
        flat = torch.tensor([s for shape in shapes for s in shape],
                            dtype=torch.int64, device=self.device)
        widest = self.comm.all_reduce(flat, op=dist.ReduceOp.MAX).tolist()
        pad, i = {}, 0
        for n, shape in zip(names, shapes):
            want = widest[i:i + len(shape)]
            i += len(shape)
            if want != shape:
                x = getattr(probs, n)
                out = x.new_zeros(want)
                out[tuple(slice(0, s) for s in shape)] = x
                pad[n] = out
        return dataclasses.replace(probs, **pad) if pad else probs

    def set_gauge(self, c: np.ndarray) -> None:
        super().set_gauge(c)
        self.halo_dc = self._mine(self.halo_dc)

    def pack_global(self, t: np.ndarray, R: np.ndarray) -> NodeState:
        return self._mine(super().pack_global(t, R))

    # ------------------------------------------------------- stepping

    def _graph_route(self) -> bool:
        """The graph route over NCCL on a CUDA card, at every world size
        (the halo exchange, and AMM-PGO*'s master all_reduces inside its
        IF bodies, recorded into the captured step); gloo keeps the
        host-read route: its collectives run on the host (staged through it
        on a card), which a CUDA graph cannot record."""
        return self.comm.backend == "nccl" and super()._graph_route()

    def _graph_key(self, st) -> tuple:
        # The captured exchange follows the strategy it was recorded with.
        same, equal = super()._graph_key(st)
        return same, equal + (self.halo, self.ring_rounds)

    # ------------------------------------------------- collective hooks

    def _exchange_halos(self, Z: NodeState) -> NodeState:
        th, Rh = _halo_exchange(self.comm, Z.t, Z.R, self.halo_owner,
                                (self.halo_slot, self.halo_lpose), self.bnd,
                                self.halo, self.ring_rounds, self.halo_dc)
        return NodeState(t=Z.t, R=Z.R, th=th, Rh=Rh)

    def _sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(x)

    def _agree(self, flag: bool) -> bool:
        return self.comm.broadcast_flag(flag)

    def pose_split(self) -> PoseSplit:
        """This rank's share of the pose axis (built at the first polish)."""
        if self._split is None:
            self._split = PoseSplit.build(self)
        return self._split

    def exchange_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The halo rows [H, k] of this rank's pose share from every rank's
        own rows [P_r, k] (k values per pose: a point or directions, packed
        by polish.with_halo), by the solver's halo strategy. No gauge
        offset is added: the polish works in the global frame, and a
        direction has no gauge. Counted on the device ("row_exchanges",
        utils.DeviceCounters), so that a captured exchange counts at every
        replay."""
        sp = self.pose_split()
        DeviceCounters.bump("row_exchanges", self.device)
        h = _exchange_packed(self.comm, rows[sp.edges.node_rows],
                             self.halo_owner,
                             (self.halo_slot, self.halo_lpose), self.bnd,
                             self.halo, self.ring_rounds)
        return h.reshape(-1, h.shape[-1])[sp.halo_pick]

    def own_rows(self, st):
        """This rank's own poses (t [P_r, d], R [P_r, d, d]) of `st` in the
        global frame, in pose order: its rows of gather_global, with no
        collective."""
        sp = self.pose_split()
        rows = (sp.edges.row_node, sp.edges.row_pose)
        t = st.Z.t[rows]
        if self._c is not None:
            c = torch.as_tensor(self._c[self.part.node_of[sp.lo:sp.hi]],
                                dtype=self.dtype, device=self.device)
            t = t + c
        return t, st.Z.R[rows]

    POLISH_COUNTERS = ("row_exchanges",) + Collectives.COUNTERS

    def _polish_tnt(self, st, params, node_precon: bool, coarse: bool,
                    coarse_segments: tuple, graph: bool):
        """The polish's TNT with the pose axis split over the ranks: each
        rank starts from its own rows (in the global frame) and runs the
        split model (solvers/polish.py, split_tnt_model) with the
        node-block preconditioner of its own problems and the coarse levels'
        sums over the ranks; one all_gather of the rows at the end. Every
        branch of TNT and STPCG reads all-reduced values, so the ranks run
        the same collectives.

        With `graph` (polish() asks for it where `_graph_route` holds: NCCL
        on a CUDA card), the TNT is one captured program replayed once, its
        halo exchanges and all_reduces recorded inside the WHILE bodies of
        TNT and STPCG; the model's and the coarse levels' set-up (their
        collectives too) runs before the capture, the final all_gather
        after it. Otherwise the host-read route. The stats add this rank's
        exchanges, collectives, bytes and host copies up to that
        all_gather, read from the device counters on both routes (the host
        flag reads stay in `syncs`: rank-local, since the segment CG's trips
        differ between ranks)."""
        sp = self.pose_split()
        comm = self.comm
        own = self.own_rows(st)
        before = {n: DeviceCounters.read(n) for n in self.POLISH_COUNTERS}
        t2, R2, fx, stats = self._run_polish_tnt(
            sp.edges, own, params, node_precon, coarse, coarse_segments,
            exchange=self.exchange_rows, reduce=comm.all_reduce,
            graph=graph)
        after = {n: DeviceCounters.read(n) - before[n]
                 for n in self.POLISH_COUNTERS}
        stats.update(exchanges=after["row_exchanges"],
                     collectives=after["collectives"],
                     bytes=after["collective_bytes"],
                     host_copies=after["collective_host_copies"])
        # Every rank's rows, padded to the widest rank, in rank order.
        d = self.mg.d
        buf = t2.new_zeros(max(sp.counts), d + d * d)
        buf[:sp.hi - sp.lo] = _pack(t2, R2)
        rows = comm.all_gather(buf)
        keep = np.concatenate([r * buf.shape[0] + np.arange(n)
                               for r, n in enumerate(sp.counts)])
        t_all, R_all = _unpack(rows[torch.as_tensor(keep,
                                                    device=rows.device)], d)
        return t_all, R_all, fx, stats

    def gather_global(self, st):
        """The global (t, R) on every rank: one all_gather of the own
        blocks, then the single solver's assembly."""
        d = self.mg.d
        t, R = _unpack(self.comm.all_gather(_pack(st.Z.t, st.Z.R)), d)
        t = t[self.node_of, self.local_of]
        if self._c is not None:
            c = torch.as_tensor(self._c, dtype=self.dtype, device=self.device)
            t = t + c[self.node_of]
        return t, R[self.node_of, self.local_of]


class ShardedDPGOSolver(_Sharded, DPGOSolver):
    """DPGOSolver (AMM-PGO#, MM-PGO, `scheme="aa"`) with the node axis split
    over the ranks of a process group: each rank steps its own nodes, the
    halos travel by `halo` ("boundary", "gather" or "ring"), and the
    histories and metrics are the same on every rank.

        ShardedDPGOSolver(meas, num_nodes, group=None, opts=None,
                          loss=Loss.TRIVIAL, loss_reg=1.0, halo="boundary",
                          dtype=torch.float64, device=None, ...)

    `run`'s callback decides on rank 0 (its stop flag is broadcast).

    `polish` splits the pose axis too: each rank holds its own poses, the
    edges that touch them and its nodes' problems, and runs the global TNT
    on its rows (`_polish_tnt`). Per CG iteration a rank makes one halo
    exchange of the search direction (the halo rows its edges read) and
    all_reduces of scalars: the five inner products after the Hessian
    product in one, the preconditioned residual's in another, and with
    the coarse levels their restrictions in a third. The result is
    gathered once and the solver re-initialized at it, the same
    (state, 2f) on every rank; `polish_stats` counts the polish's
    exchanges, collectives, bytes and host copies beside its CG
    iterations. Over NCCL on a card the polish's TNT is one captured
    program, collectives inside, replayed once (the graph route, as for the
    steps), at every world size; `polish(eager=True)` and gloo take the
    host-read route."""


class ShardedDPGOStarSolver(_Sharded, DPGOStarSolver):
    """AMM-PGO* with the node axis split over the ranks: the master's exact
    global objective is the all_reduce of per-node objective shares over
    exchanged halos (no physical master; reference DPGOStar.cpp:126-213),
    and the psi-test's squared step is summed over all ranks, so every rank
    takes the same fallbacks (`fallbacks` is equal on all ranks). Its
    master's all_reduces sit inside the step's IF bodies."""

    def _global_f(self, t_own, R_own):
        Z = self._exchange_halos(NodeState(t=t_own, R=R_own, th=None,
                                           Rh=None))
        return self._sum_over_ranks(torch.sum(self.probs.local_fobj(Z)))


__all__ = ["HaloSchedule", "build_halo_schedule", "_ring_rounds",
           "_halo_exchange", "take_nodes", "Collectives", "PoseSplit",
           "ShardedDPGOSolver", "ShardedDPGOStarSolver"]
