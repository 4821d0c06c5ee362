"""Graph partitioning and per-node communication schedules.

Reproduces the reference's data distribution semantics
(C++/DPGO/src/DPGO_utils.cpp:140-438):

- Poses are split into `num_nodes` contiguous blocks; if num_poses is not
  divisible, the first (num_poses mod num_nodes) blocks get one extra pose
  (partition lambda at DPGO_utils.cpp:151-158).
- Each node holds all edges touching it; inter-node edges are duplicated into
  both endpoints' edge lists.
- Per node, own poses get local indices 0..n0-1 (sorted by pose id); halo
  (separator) poses of neighbors get slots 0..n1-1 sorted by (node, pose)
  (generate_data_info, DPGO_utils.cpp:400-418).

Everything is padded to per-axis maxima across nodes so the node axis can be
vmapped / sharded as one rectangular batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dpgo_tpu_torch.io.g2o import Measurements


@dataclasses.dataclass
class Partition:
    num_nodes: int
    num_poses: int
    node_of: np.ndarray   # [P] owning node of each global pose
    local_of: np.ndarray  # [P] local index within the owning node
    n0: np.ndarray        # [N] number of poses per node
    start: np.ndarray     # [N] global index of each node's first pose


def make_partition(num_poses: int, num_nodes: int) -> Partition:
    base = num_poses // num_nodes
    extra = num_poses - num_nodes * base
    n0 = np.full(num_nodes, base, dtype=np.int64)
    n0[:extra] += 1
    start = np.concatenate([[0], np.cumsum(n0)[:-1]])
    node_of = np.repeat(np.arange(num_nodes), n0)
    local_of = np.arange(num_poses) - start[node_of]
    return Partition(num_nodes=num_nodes, num_poses=num_poses,
                     node_of=node_of, local_of=local_of, n0=n0, start=start)


@dataclasses.dataclass
class NodeGraph:
    """Unpadded per-node problem graph (host-side, numpy)."""

    node: int
    d: int
    n0: int                 # own poses
    n1: int                 # halo (neighbor separator) poses
    # Halo slot s holds pose `halo_lpose[s]` of node `halo_owner[s]`.
    halo_owner: np.ndarray  # [n1]
    halo_lpose: np.ndarray  # [n1]
    # Intra edges (both endpoints local); order = order of appearance.
    intra: Measurements     # i/j fields hold *local* own indices
    # Inter edges. self_l = local own index; other_slot = halo slot;
    # self_is_i = True when the own pose is the i (tail) endpoint.
    inter: Measurements     # i/j hold local own index / halo slot (see flags)
    self_l: np.ndarray      # [m1]
    other_slot: np.ndarray  # [m1]
    self_is_i: np.ndarray   # [m1] bool
    # Message schedules (for the explicit p2p transport API):
    # sent[b] = sorted own pose local indices sent to node b.
    sent: dict[int, np.ndarray]
    # recv[b] = (owner local pose ids sorted, halo slots they land in).
    recv: dict[int, tuple[np.ndarray, np.ndarray]]


def partition_measurements(
    meas: Measurements, num_nodes: int
) -> tuple[Partition, list[NodeGraph]]:
    """Split a global measurement batch into per-node graphs + schedules."""
    part = make_partition(meas.num_poses, num_nodes)
    ni, nj = part.node_of[meas.i], part.node_of[meas.j]
    li, lj = part.local_of[meas.i], part.local_of[meas.j]

    nodes = []
    for a in range(num_nodes):
        touches = (ni == a) | (nj == a)
        idx = np.nonzero(touches)[0]
        e_ni, e_nj = ni[idx], nj[idx]
        e_li, e_lj = li[idx], lj[idx]
        is_intra = e_ni == e_nj

        n0 = int(part.n0[a])
        own_seen = np.zeros(n0, dtype=bool)
        own_seen[e_li[e_ni == a]] = True
        own_seen[e_lj[e_nj == a]] = True
        if not own_seen.all():
            # The reference compacts indices of unseen poses
            # (generate_data_info); benchmark graphs never hit this.
            raise ValueError(
                f"node {a}: poses {np.nonzero(~own_seen)[0]} appear in no "
                "measurement; compaction not supported")

        # Halo poses: neighbor endpoints of inter edges, sorted by
        # (node, pose) as in the reference (DPGO_utils.cpp:400-418).
        inter_idx = idx[~is_intra]
        self_is_i = ni[inter_idx] == a
        o_node = np.where(self_is_i, nj[inter_idx], ni[inter_idx])
        o_lpose = np.where(self_is_i, lj[inter_idx], li[inter_idx])
        halo_keys = np.unique(np.stack([o_node, o_lpose], axis=1), axis=0)
        n1 = halo_keys.shape[0]
        slot_of = {(int(n), int(p)): s for s, (n, p) in enumerate(halo_keys)}
        other_slot = np.array(
            [slot_of[(int(n), int(p))] for n, p in zip(o_node, o_lpose)],
            dtype=np.int64,
        ).reshape(-1)

        intra_sel = meas.select(idx[is_intra])
        intra_sel.i = li[idx[is_intra]]
        intra_sel.j = lj[idx[is_intra]]
        inter_sel = meas.select(inter_idx)
        self_l = np.where(self_is_i, li[inter_idx], lj[inter_idx])

        sent: dict[int, set] = {}
        for k in range(inter_idx.shape[0]):
            sent.setdefault(int(o_node[k]), set()).add(int(self_l[k]))
        sent_arr = {b: np.array(sorted(v), dtype=np.int64)
                    for b, v in sorted(sent.items())}
        recv_arr: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for b in sent_arr:
            sel = halo_keys[:, 0] == b
            recv_arr[b] = (halo_keys[sel, 1].astype(np.int64),
                           np.nonzero(sel)[0].astype(np.int64))

        nodes.append(NodeGraph(
            node=a, d=meas.d, n0=n0, n1=n1,
            halo_owner=halo_keys[:, 0].astype(np.int64),
            halo_lpose=halo_keys[:, 1].astype(np.int64),
            intra=intra_sel, inter=inter_sel,
            self_l=self_l.astype(np.int64),
            other_slot=other_slot,
            self_is_i=self_is_i,
            sent=sent_arr, recv=recv_arr,
        ))
    return part, nodes


@dataclasses.dataclass
class MultiGraph:
    """Padded, rectangular multi-node graph: the device-side problem data.

    All arrays have the node axis first and are padded to per-axis maxima.
    Padded edges have kappa = tau = 0 and indices 0; padded halo slots point
    at (node 0, pose 0); padded poses are masked out in pose_mask.
    """

    num_nodes: int
    num_poses: int
    d: int
    n0_max: int
    n1_max: int
    m0_max: int
    m1_max: int
    n0: np.ndarray          # [N]
    n1: np.ndarray          # [N]
    start: np.ndarray       # [N] global pose offset per node
    pose_mask: np.ndarray   # [N, n0_max] bool
    halo_owner: np.ndarray  # [N, n1_max]
    halo_lpose: np.ndarray  # [N, n1_max]
    halo_mask: np.ndarray   # [N, n1_max] bool
    # Intra edges.
    a_i: np.ndarray         # [N, m0_max] local own i
    a_j: np.ndarray         # [N, m0_max] local own j
    a_R: np.ndarray         # [N, m0_max, d, d]
    a_t: np.ndarray         # [N, m0_max, d]
    a_kap: np.ndarray       # [N, m0_max]
    a_tau: np.ndarray       # [N, m0_max]
    a_mask: np.ndarray      # [N, m0_max] bool
    # Inter edges.
    e_self: np.ndarray      # [N, m1_max] local own index
    e_slot: np.ndarray      # [N, m1_max] halo slot
    e_self_is_i: np.ndarray # [N, m1_max] bool
    e_R: np.ndarray
    e_t: np.ndarray
    e_kap: np.ndarray
    e_tau: np.ndarray
    e_mask: np.ndarray


def build_multigraph(meas: Measurements, num_nodes: int
                     ) -> tuple[Partition, list[NodeGraph], MultiGraph]:
    part, nodes = partition_measurements(meas, num_nodes)
    d = meas.d
    N = num_nodes
    n0_max = max(g.n0 for g in nodes)
    n1_max = max((g.n1 for g in nodes), default=0)
    n1_max = max(n1_max, 1)
    m0_max = max(len(g.intra) for g in nodes)
    m0_max = max(m0_max, 1)
    m1_max = max((len(g.inter) for g in nodes), default=0)
    m1_max = max(m1_max, 1)

    def zeros(shape, dt=np.float64):
        return np.zeros(shape, dtype=dt)

    mg = MultiGraph(
        num_nodes=N, num_poses=meas.num_poses, d=d,
        n0_max=n0_max, n1_max=n1_max, m0_max=m0_max, m1_max=m1_max,
        n0=part.n0.copy(), n1=np.array([g.n1 for g in nodes]),
        start=part.start.copy(),
        pose_mask=zeros((N, n0_max), bool),
        halo_owner=zeros((N, n1_max), np.int32),
        halo_lpose=zeros((N, n1_max), np.int32),
        halo_mask=zeros((N, n1_max), bool),
        a_i=zeros((N, m0_max), np.int32), a_j=zeros((N, m0_max), np.int32),
        a_R=np.tile(np.eye(d), (N, m0_max, 1, 1)),
        a_t=zeros((N, m0_max, d)),
        a_kap=zeros((N, m0_max)), a_tau=zeros((N, m0_max)),
        a_mask=zeros((N, m0_max), bool),
        e_self=zeros((N, m1_max), np.int32),
        e_slot=zeros((N, m1_max), np.int32),
        e_self_is_i=zeros((N, m1_max), bool),
        e_R=np.tile(np.eye(d), (N, m1_max, 1, 1)),
        e_t=zeros((N, m1_max, d)),
        e_kap=zeros((N, m1_max)), e_tau=zeros((N, m1_max)),
        e_mask=zeros((N, m1_max), bool),
    )
    for a, g in enumerate(nodes):
        mg.pose_mask[a, :g.n0] = True
        mg.halo_owner[a, :g.n1] = g.halo_owner
        mg.halo_lpose[a, :g.n1] = g.halo_lpose
        mg.halo_mask[a, :g.n1] = True
        m0, m1 = len(g.intra), len(g.inter)
        mg.a_i[a, :m0] = g.intra.i
        mg.a_j[a, :m0] = g.intra.j
        mg.a_R[a, :m0] = g.intra.R
        mg.a_t[a, :m0] = g.intra.t
        mg.a_kap[a, :m0] = g.intra.kappa
        mg.a_tau[a, :m0] = g.intra.tau
        mg.a_mask[a, :m0] = True
        mg.e_self[a, :m1] = g.self_l
        mg.e_slot[a, :m1] = g.other_slot
        mg.e_self_is_i[a, :m1] = g.self_is_i
        mg.e_R[a, :m1] = g.inter.R
        mg.e_t[a, :m1] = g.inter.t
        mg.e_kap[a, :m1] = g.inter.kappa
        mg.e_tau[a, :m1] = g.inter.tau
        mg.e_mask[a, :m1] = True
    return part, nodes, mg


def node_range(mg: MultiGraph, lo: int, hi: int) -> MultiGraph:
    """Nodes [lo, hi) of a MultiGraph with the global padding kept (n0_max,
    n1_max, m0_max, m1_max) and the global node ids in `halo_owner`: the
    graph one rank of a sharded solver builds its problems from."""
    per_node = {f.name: getattr(mg, f.name)[lo:hi]
                for f in dataclasses.fields(mg)
                if isinstance(getattr(mg, f.name), np.ndarray)}
    return dataclasses.replace(mg, num_nodes=hi - lo, **per_node)
