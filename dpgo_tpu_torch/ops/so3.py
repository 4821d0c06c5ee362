"""Batched projection onto SO(3): branch-free Newton polar iteration (torch
port of dpgo_tpu/ops/so3.py).

This is the plain PyTorch version of kernel K2 (`ops/polar_so3_cuda.py`,
`csrc/polar_so3.cu`): the CPU path of `manifold.project_sod` and the oracle
the kernel is tested against.

Method: scaled Higham-Newton iteration X <- (zeta X + (zeta X)^-T)/2 converges
quadratically to the orthogonal polar factor Q with det(Q) = sign(det(A)).
For det(A) < 0 the Frobenius-closest SO(3) matrix is Q (I - 2 v3 v3^T), where
v3 is the eigenvector of the SPD factor H = Q^T A for its smallest eigenvalue,
computed in closed form (trigonometric eigenvalue formula + cross-product
null vector), every branch a `torch.where` select.
"""

from __future__ import annotations

import math

import torch

_NEWTON_ITERS = 9


def _adjugate_T(X):
    """Transpose of the adjugate of [..., 3, 3]: adj(X)^T[i, j] = cofactor."""
    a, b, c = X[..., 0, 0], X[..., 0, 1], X[..., 0, 2]
    d, e, f = X[..., 1, 0], X[..., 1, 1], X[..., 1, 2]
    g, h, i = X[..., 2, 0], X[..., 2, 1], X[..., 2, 2]
    rows = [[e * i - f * h, f * g - d * i, d * h - e * g],
            [c * h - b * i, a * i - c * g, b * g - a * h],
            [b * f - c * e, c * d - a * f, a * e - b * d]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _det3(X):
    return (X[..., 0, 0] * (X[..., 1, 1] * X[..., 2, 2]
                            - X[..., 1, 2] * X[..., 2, 1])
            - X[..., 0, 1] * (X[..., 1, 0] * X[..., 2, 2]
                              - X[..., 1, 2] * X[..., 2, 0])
            + X[..., 0, 2] * (X[..., 1, 0] * X[..., 2, 1]
                              - X[..., 1, 1] * X[..., 2, 0]))


def _inv_T(X, eps):
    """X^-T via adjugate, det clamped away from zero."""
    det = _det3(X)
    clamp = torch.where(det >= 0, eps, -eps)
    safe = torch.where(det.abs() > eps, det, clamp)
    return _adjugate_T(X) / safe[..., None, None]


def polar_so3(A: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto SO(3) (Frobenius-closest, det fix included)."""
    dtype = A.dtype
    # A fill on the device, not a copy from the host (capturable).
    eps = torch.full((), 1e-30 if dtype == torch.float64 else 1e-18,
                     dtype=dtype, device=A.device)
    eye = torch.eye(3, dtype=dtype, device=A.device)

    # Normalize scale; degenerate (zero) input maps to identity.
    nrm = torch.sqrt(torch.sum(A * A, dim=(-1, -2), keepdim=True))
    ok = nrm[..., 0, 0] > eps
    X = torch.where(ok[..., None, None], A / torch.maximum(nrm, eps), eye)

    for _ in range(_NEWTON_ITERS):
        Xinv_T = _inv_T(X, eps)
        # Higham 1,inf-norm scaling accelerates early iterations.
        nx = torch.sum(X * X, dim=(-1, -2))
        ni = torch.sum(Xinv_T * Xinv_T, dim=(-1, -2))
        zeta = (ni / torch.maximum(nx, eps)) ** 0.25
        zeta = zeta[..., None, None]
        X = 0.5 * (zeta * X + Xinv_T / zeta)

    Q = X  # orthogonal, det = sign(det A)

    # det < 0 correction: Q (I - 2 v3 v3^T) with v3 the smallest-eigenvalue
    # eigenvector of H = Q^T A (SPD up to sign).
    H = Q.transpose(-1, -2) @ A
    H = 0.5 * (H + H.transpose(-1, -2))
    q = H.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    Hq = H - q[..., None, None] * eye
    p = torch.sqrt(torch.maximum(torch.sum(Hq * Hq, dim=(-1, -2)) / 6.0,
                                 eps))
    B = Hq / p[..., None, None]
    r = torch.clamp(0.5 * _det3(B), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # Smallest eigenvalue of H.
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = H - lam3[..., None, None] * eye
    # Null vector of M: the largest cross product of two rows (first one on
    # ties, as argmax picks).
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r1, r2),
                         torch.linalg.cross(r2, r0)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    v = v / torch.maximum(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)),
                          eps)
    refl = eye - 2.0 * v[..., :, None] * v[..., None, :]
    Q_fixed = Q @ refl

    neg = _det3(A) < 0
    R = torch.where(neg[..., None, None], Q_fixed, Q)
    return torch.where(ok[..., None, None], R, eye)
