"""Solution quality metrics: gauge alignment + absolute trajectory error
(numpy; a copy of dpgo_tpu/metrics.py).

PGO solutions are defined up to a global SE(d) gauge transform; comparisons
against a reference (e.g. a certified SE-Sync solution) first align with the
closed-form Umeyama/Kabsch solution, then report translation RMSE (ATE) and
rotation error statistics.
"""

from __future__ import annotations

import numpy as np


def align_se(t_est: np.ndarray, t_ref: np.ndarray):
    """Best SE(d) alignment of t_est onto t_ref (no scale): returns (R, s)
    with t_aligned = t_est @ R.T + s."""
    mu_e = t_est.mean(axis=0)
    mu_r = t_ref.mean(axis=0)
    H = (t_est - mu_e).T @ (t_ref - mu_r)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(H.shape[0])
    if np.linalg.det(U @ Vt) < 0:
        S[-1, -1] = -1
    R = (U @ S @ Vt).T
    s = mu_r - R @ mu_e
    return R, s


def ate(t_est: np.ndarray, t_ref: np.ndarray) -> float:
    """Absolute trajectory error (RMSE) after SE(d) alignment."""
    R, s = align_se(t_est, t_ref)
    aligned = t_est @ R.T + s
    return float(np.sqrt(np.mean(np.sum((aligned - t_ref) ** 2, axis=1))))


def rotation_errors(R_est: np.ndarray, R_ref: np.ndarray,
                    t_est: np.ndarray, t_ref: np.ndarray) -> np.ndarray:
    """Per-pose geodesic rotation errors (radians) after gauge alignment."""
    Rg, _ = align_se(t_est, t_ref)
    Ra = np.einsum("ab,nbc->nac", Rg, R_est)
    rel = np.einsum("nba,nbc->nac", Ra, R_ref)
    d = R_est.shape[-1]
    tr = np.trace(rel, axis1=1, axis2=2)
    if d == 2:
        cos = np.clip(tr / 2.0, -1.0, 1.0)
    else:
        cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(cos)
