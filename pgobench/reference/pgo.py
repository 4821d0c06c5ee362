"""Plain float64 pose-graph objective and Riemannian gradient, worked out
from the measurements alone.

For edges (i, j) with relative pose (R~, t~) and precisions (kappa, tau):

    f(t, R) = 1/2 sum_e tau |t_i + R_i t~ - t_j|^2
                      + kappa |R_i R~ - R_j|_F^2

The Riemannian gradient keeps the translation part of the Euclidean one
and projects the rotation part onto the tangent space of SO(d) at R:
R skew(R^T G), skew(A) = (A - A^T) / 2.
"""

from __future__ import annotations

import numpy as np


def _scatter(idx: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Sum the rows vals [m, ...] into n rows by idx [m] (np.bincount per
    component)."""
    flat = vals.reshape(len(idx), -1)
    out = np.stack([np.bincount(idx, weights=flat[:, k], minlength=n)
                    for k in range(flat.shape[1])], axis=1)
    return out.reshape((n,) + vals.shape[1:])


def residuals(g: dict, t: np.ndarray, R: np.ndarray):
    """Unweighted residuals r_t [m, d] = t_i + R_i t~ - t_j and
    r_R [m, d, d] = R_i R~ - R_j."""
    i, j = g["i"], g["j"]
    Ri = R[i]
    rt = t[i] + np.einsum("mab,mb->ma", Ri, g["t"]) - t[j]
    rR = Ri @ g["R"] - R[j]
    return rt, rR


def objective(g: dict, t: np.ndarray, R: np.ndarray) -> float:
    """f(t, R) in float64."""
    t = np.asarray(t, np.float64)
    R = np.asarray(R, np.float64)
    rt, rR = residuals(g, t, R)
    return 0.5 * float(np.sum(g["tau"] * np.sum(rt * rt, axis=1))
                       + np.sum(g["kappa"] * np.sum(rR * rR, axis=(1, 2))))


def riemannian_grad(g: dict, t: np.ndarray, R: np.ndarray):
    """(grad_t [P, d], grad_R [P, d, d]) of f at (t, R), float64."""
    t = np.asarray(t, np.float64)
    R = np.asarray(R, np.float64)
    n = g["num_poses"]
    i, j = g["i"], g["j"]
    rt, rR = residuals(g, t, R)
    u = g["tau"][:, None] * rt
    E = g["kappa"][:, None, None] * rR
    Gt = _scatter(i, u, n) - _scatter(j, u, n)
    Gi = u[:, :, None] * g["t"][:, None, :] + E @ np.swapaxes(g["R"], 1, 2)
    GR = _scatter(i, Gi, n) - _scatter(j, E, n)
    A = np.swapaxes(R, 1, 2) @ GR
    return Gt, R @ (0.5 * (A - np.swapaxes(A, 1, 2)))


def grad_norm(g: dict, t: np.ndarray, R: np.ndarray) -> float:
    """|grad f| at (t, R): the Frobenius norm over all poses."""
    Gt, GR = riemannian_grad(g, t, R)
    return float(np.sqrt(np.sum(Gt * Gt) + np.sum(GR * GR)))
