"""Global matrix-free PGO objective / gradient oracle (torch port of
dpgo_tpu/objective.py).

The exact global objective and Riemannian gradient on the full (gathered)
pose state: the metrics harness of the driver (2 fobj and 2 |grad|). Every
sparse matvec becomes gather -> batched product -> `index_add_`.

`SplitEdges` and the `split_*` functions are the same oracles on one
process's share when the pose axis is split over processes (the sharded
polish): each sees its own poses and the halo poses its edges read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpgo_tpu_torch.io.g2o import Measurements
from dpgo_tpu_torch.losses import Loss, loss_value, loss_weight
from dpgo_tpu_torch.manifold import proj_tangent
from dpgo_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class EdgeData:
    """Device-side flat edge arrays over the global pose index space."""

    i: torch.Tensor      # [m] int64
    j: torch.Tensor      # [m] int64
    R: torch.Tensor      # [m, d, d]
    t: torch.Tensor      # [m, d]
    kappa: torch.Tensor  # [m]
    tau: torch.Tensor    # [m]
    is_inter: torch.Tensor  # [m] bool: robust loss applies only to these

    @staticmethod
    def from_measurements(meas: Measurements,
                          node_of: np.ndarray | None = None,
                          dtype=torch.float64, device=None) -> "EdgeData":
        """The edge arrays on the CUDA card unless `device` names another
        (`device="cpu"`)."""
        device = resolve_device(device)
        if node_of is None:
            is_inter = np.zeros(len(meas), dtype=bool)
        else:
            is_inter = node_of[meas.i] != node_of[meas.j]

        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        def ix(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        return EdgeData(i=ix(meas.i), j=ix(meas.j), R=f(meas.R), t=f(meas.t),
                        kappa=f(meas.kappa), tau=f(meas.tau),
                        is_inter=torch.as_tensor(is_inter, device=device))


def edge_residuals(edges: EdgeData, t: torch.Tensor, R: torch.Tensor):
    """Per-edge residuals: r_t [m, d] and r_R [m, d, d] (sqrt-weighted)."""
    Ri = R[edges.i]
    rt = t[edges.i] + (Ri @ edges.t[:, :, None])[..., 0] - t[edges.j]
    rR = Ri @ edges.R - R[edges.j]
    sqrt_tau = torch.sqrt(edges.tau)[:, None]
    sqrt_kap = torch.sqrt(edges.kappa)[:, None, None]
    return sqrt_tau * rt, sqrt_kap * rR


def edge_sqnorms(edges: EdgeData, t: torch.Tensor, R: torch.Tensor):
    rt, rR = edge_residuals(edges, t, R)
    return torch.sum(rt * rt, dim=-1) + torch.sum(rR * rR, dim=(-1, -2))


def evaluate_f(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
               loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0
               ) -> torch.Tensor:
    """Global objective F = 1/2 sum_intra |r|^2 + 1/2 sum_inter rho(|r|^2)."""
    s = edge_sqnorms(edges, t, R)
    if loss == Loss.TRIVIAL:
        return 0.5 * torch.sum(s)
    vals = torch.where(edges.is_inter, loss_value(loss, s, loss_reg), s)
    return 0.5 * torch.sum(vals)


def evaluate_euclidean_grad(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
                            loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """Euclidean gradient (Df_t [P, d], Df_R [P, d, d]) of evaluate_f."""
    rt, rR = edge_residuals(edges, t, R)
    if loss == Loss.TRIVIAL:
        w = torch.ones_like(edges.tau)
    else:
        s = torch.sum(rt * rt, dim=-1) + torch.sum(rR * rR, dim=(-1, -2))
        w = torch.where(edges.is_inter, loss_weight(loss, s, loss_reg),
                        torch.ones_like(s))
    # u = w sqrt(tau) r_t ; E = w sqrt(kappa) r_R (un-sqrt once more)
    u = (w * torch.sqrt(edges.tau))[:, None] * rt
    E = (w * torch.sqrt(edges.kappa))[:, None, None] * rR
    # d/dt_i += u ; d/dt_j -= u
    Df_t = torch.zeros_like(t).index_add_(0, edges.i, u)
    Df_t.index_add_(0, edges.j, -u)
    # d/dR_i += u t~^T + E R~^T ; d/dR_j -= E
    Gi = u[:, :, None] * edges.t[:, None, :] + E @ edges.R.transpose(-1, -2)
    Df_R = torch.zeros_like(R).index_add_(0, edges.i, Gi)
    Df_R.index_add_(0, edges.j, -E)
    return Df_t, Df_R


def evaluate_riemannian_grad(edges: EdgeData, t: torch.Tensor,
                             R: torch.Tensor, loss: Loss = Loss.TRIVIAL,
                             loss_reg: float = 1.0, kernel: bool = True):
    """Riemannian gradient: translation part unchanged, rotation part
    projected onto the tangent space of SO(d)^n (its block products
    through kernel K3 where `kernel` holds, manifold.block_mm)."""
    Df_t, Df_R = evaluate_euclidean_grad(edges, t, R, loss, loss_reg)
    return Df_t, proj_tangent(R, Df_R, kernel)


def grad_norm(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
              loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
              kernel: bool = True) -> torch.Tensor:
    g_t, g_R = evaluate_riemannian_grad(edges, t, R, loss, loss_reg, kernel)
    return torch.sqrt(torch.sum(g_t * g_t) + torch.sum(g_R * g_R))


@dataclasses.dataclass
class SplitEdges:
    """One process's share of the edges when the pose axis is split over
    processes, each owning the contiguous poses of a range of nodes: every
    edge with an endpoint among the own poses, in the global order, with
    `edges.i` / `.j` indexing the process's extended rows [own poses; halo
    poses].

    Sums over the pose axis go node by node in a fixed order, so that they
    do not depend on the split: a node's partial sum is taken over its
    own-pose rows (`node_rows`, `node_mask`; n0_max wide) or over the edges
    it counts (those whose i endpoint it owns: `node_edges`, `edge_mask`;
    as wide as the most any node counts), placed at the node's slot of an
    [N] vector (zeros elsewhere) and summed over the N slots. Summed over
    the processes first, the [N] vector is exact (each slot is nonzero on
    one process only), so one process and a split give equal bits."""

    edges: EdgeData
    num_own: int
    num_halo: int
    node_lo: int
    num_nodes: int
    node_rows: torch.Tensor  # [n, n0_max] own row of each node pose
    node_mask: torch.Tensor  # [n, n0_max] bool
    row_node: torch.Tensor   # [P_r] node of each own row, from node_lo
    row_pose: torch.Tensor   # [P_r] its pose within the node
    node_edges: torch.Tensor  # [n, m_max] share edge counted by each node
    edge_mask: torch.Tensor  # [n, m_max] bool

    @staticmethod
    def build(edges: EdgeData, node_of: np.ndarray, node_lo: int,
              node_hi: int, halo: np.ndarray = ()) -> "SplitEdges":
        """The share of the process owning nodes [node_lo, node_hi) of the
        contiguous partition `node_of` [P], whose halo rows hold the global
        poses `halo` [H], in that order."""
        node_of = np.asarray(node_of, np.int64)
        halo = np.asarray(halo, np.int64)
        N = int(node_of.max()) + 1
        n0 = np.bincount(node_of, minlength=N)
        start = np.concatenate([[0], np.cumsum(n0)[:-1]])
        lo, hi = int(start[node_lo]), int(start[node_hi - 1]
                                          + n0[node_hi - 1])
        i = edges.i.cpu().numpy()
        j = edges.j.cpu().numpy()
        row = np.full(len(node_of), -1, np.int64)
        row[lo:hi] = np.arange(hi - lo)
        row[halo] = hi - lo + np.arange(len(halo))
        mine = np.flatnonzero(((i >= lo) & (i < hi)) | ((j >= lo) & (j < hi)))
        ie, je = row[i[mine]], row[j[mine]]
        if (ie < 0).any() or (je < 0).any():
            raise ValueError("an edge reads a pose that is neither own nor "
                             "in the halo")
        # Each edge is counted by the node of its i endpoint.
        m_max = int(np.bincount(node_of[i], minlength=N).max())
        counter = np.where(ie < hi - lo, node_of[i[mine]] - node_lo, -1)
        n = node_hi - node_lo
        node_edges = np.zeros((n, m_max), np.int64)
        edge_mask = np.zeros((n, m_max), bool)
        for a in range(n):
            e = np.flatnonzero(counter == a)
            node_edges[a, :len(e)] = e
            edge_mask[a, :len(e)] = True
        n0_max = int(n0.max())
        cols = np.arange(n0_max)[None, :]
        node_rows = np.minimum(start[node_lo:node_hi, None] - lo + cols,
                               hi - lo - 1)
        dev = edges.i.device

        def ix(x):
            return torch.as_tensor(x, device=dev)

        sel = ix(mine)
        local = EdgeData(i=ix(ie), j=ix(je), R=edges.R[sel], t=edges.t[sel],
                         kappa=edges.kappa[sel], tau=edges.tau[sel],
                         is_inter=edges.is_inter[sel])
        return SplitEdges(edges=local, num_own=hi - lo, num_halo=len(halo),
                          node_lo=node_lo, num_nodes=N,
                          node_rows=ix(node_rows),
                          node_mask=ix(cols < n0[node_lo:node_hi, None]),
                          row_node=ix(node_of[lo:hi] - node_lo),
                          row_pose=ix(np.arange(lo, hi)
                                      - start[node_of[lo:hi]]),
                          node_edges=ix(node_edges), edge_mask=ix(edge_mask))

    def _place(self, part: torch.Tensor) -> torch.Tensor:
        """[..., n] node partials -> [..., N] with zeros at other nodes."""
        out = part.new_zeros(part.shape[:-1] + (self.num_nodes,))
        out[..., self.node_lo:self.node_lo + part.shape[-1]] = part
        return out

    def pose_partials(self, q: torch.Tensor) -> torch.Tensor:
        """Per-node sums [..., N] of per-own-pose values q [..., P_r]."""
        v = q[..., self.node_rows]
        return self._place(torch.where(self.node_mask, v,
                                       torch.zeros_like(v)).sum(-1))

    def edge_partials(self, q: torch.Tensor) -> torch.Tensor:
        """Per-node sums [N] of per-share-edge values q [m] over the edges
        each node counts."""
        v = q[self.node_edges]
        return self._place(torch.where(self.edge_mask, v,
                                       torch.zeros_like(v)).sum(-1))


def split_f(se: SplitEdges, t: torch.Tensor, R: torch.Tensor,
            loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0
            ) -> torch.Tensor:
    """This process's node partials [N] of evaluate_f at the extended rows
    (t, R); summed over the processes and then over N, the global
    objective."""
    s = edge_sqnorms(se.edges, t, R)
    if loss != Loss.TRIVIAL:
        s = torch.where(se.edges.is_inter, loss_value(loss, s, loss_reg), s)
    return 0.5 * se.edge_partials(s)


def split_euclidean_grad(se: SplitEdges, t: torch.Tensor, R: torch.Tensor,
                         loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """The own rows of evaluate_euclidean_grad at the extended rows (t, R):
    every edge of the share adds to its own endpoints."""
    Df_t, Df_R = evaluate_euclidean_grad(se.edges, t, R, loss, loss_reg)
    return Df_t[:se.num_own], Df_R[:se.num_own]
