"""Global matrix-free PGO objective / gradient oracle (torch port of
dpgo_tpu/objective.py).

The exact global objective and Riemannian gradient on the full (gathered)
pose state: the metrics harness of the driver (2 fobj and 2 |grad|). Every
sparse matvec becomes gather -> batched product -> `index_add_`.
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
                             loss_reg: float = 1.0):
    """Riemannian gradient: translation part unchanged, rotation part
    projected onto the tangent space of SO(d)^n."""
    Df_t, Df_R = evaluate_euclidean_grad(edges, t, R, loss, loss_reg)
    return Df_t, proj_tangent(R, Df_R)


def grad_norm(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
              loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0
              ) -> torch.Tensor:
    g_t, g_R = evaluate_riemannian_grad(edges, t, R, loss, loss_reg)
    return torch.sqrt(torch.sum(g_t * g_t) + torch.sum(g_R * g_R))
