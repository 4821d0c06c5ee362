"""Explicit per-node message transport (deployment API; a copy of
dpgo_tpu/transport.py on the port's graph).

The reference ships two communication modes: the in-process shared-memory
copy `communicate()` and the message-based `DPGOHash::receive(map<int,
Matrix>)` (DPGOHash.cpp:45-82) that a real robot network would drive. This
module is the explicit message twin of `driver.communicate`, for deployments
where nodes are separate processes or robots exchanging buffers (host numpy
in, host numpy out):

  extract_messages(g, ...)  -> {b: (t [k, d], R [k, d, d])} for each
                               neighbor b, in the node pair's agreed order
                               (the `sent` schedule)
  apply_messages(g, ...)    -> new halo (th, Rh) updated from received
                               buffers (the `recv` schedule)
"""

from __future__ import annotations

import numpy as np

from dpgo_tpu_torch.graph import NodeGraph


def extract_messages(g: NodeGraph, t_own: np.ndarray, R_own: np.ndarray):
    """Messages node g.node sends: {dest_node: (t, R)} over its sent
    schedule (sorted own pose ids, the order receivers expect)."""
    out = {}
    for b, poses in g.sent.items():
        out[b] = (np.asarray(t_own)[poses], np.asarray(R_own)[poses])
    return out


def apply_messages(g: NodeGraph, th: np.ndarray, Rh: np.ndarray,
                   msgs: dict):
    """Apply received messages {src_node: (t, R)} to the halo buffers.

    Each message must contain the poses of src's `sent[g.node]` schedule in
    order; they land in the halo slots of g.recv[src]."""
    th = np.array(th)
    Rh = np.array(Rh)
    for b, (t_msg, R_msg) in msgs.items():
        lposes, slots = g.recv[b]
        if len(lposes) != len(t_msg):
            raise ValueError(
                f"message from {b} has {len(t_msg)} poses, schedule expects "
                f"{len(lposes)}")
        th[slots] = t_msg
        Rh[slots] = R_msg
    return th, Rh
