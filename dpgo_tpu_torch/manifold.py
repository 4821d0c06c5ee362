"""Batched SO(d)^n manifold operations on [..., d, d] tensors (torch port of
dpgo_tpu/manifold.py).

Rotations are stored as true rotation matrices R[i]; all functions are
shape-polymorphic over leading batch axes.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.ops import block_mm_cuda
from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda
from dpgo_tpu_torch.ops.so3 import polar_so3


def project_so2(A: torch.Tensor) -> torch.Tensor:
    """Closed-form projection of [..., 2, 2] onto SO(2).

    argmax_{R in SO(2)} <R, A> = [[a, -b], [b, a]] / sqrt(a^2+b^2) with
    a = A00 + A11, b = A10 - A01.
    """
    a = A[..., 0, 0] + A[..., 1, 1]
    b = A[..., 1, 0] - A[..., 0, 1]
    nrm = torch.sqrt(a * a + b * b)
    # Degenerate A -> identity.
    safe = nrm > 0
    inv = torch.where(safe, 1.0 / torch.where(safe, nrm, 1.0), 1.0)
    c = torch.where(safe, a * inv, 1.0)
    s = torch.where(safe, b * inv, 0.0)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _project_svd(A: torch.Tensor) -> torch.Tensor:
    """SVD-based projection of [..., d, d] onto SO(d) with det fix."""
    U, _, Vt = torch.linalg.svd(A)
    detUVt = torch.linalg.det(U) * torch.linalg.det(Vt)
    flip = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    flip[..., -1] = detUVt
    return U @ (flip[..., :, None] * Vt)


def project_sod(A: torch.Tensor, kernel: bool = True) -> torch.Tensor:
    """Project [..., d, d] matrices onto SO(d) (closest in Frobenius norm).

    d = 2: closed form. d = 3: kernel K2 (`ops/polar_so3_cuda.py`), which
    runs the CUDA kernel on a CUDA tensor and the plain torch version on a
    CPU tensor; `kernel=False` calls the plain version on any device (the
    kernel-vs-plain comparison on the card). Other d: SVD.
    """
    d = A.shape[-1]
    if d == 2:
        return project_so2(A)
    if d == 3:
        lead = A.shape[:-2]
        flat = A.reshape(-1, 3, 3)
        if kernel:
            R = polar_so3_cuda(flat.contiguous())
        else:
            R = polar_so3(flat)
        return R.reshape(*lead, 3, 3)
    return _project_svd(A)


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def block_mm(A: torch.Tensor, B: torch.Tensor, kernel: bool = True
             ) -> torch.Tensor:
    """Per-block A_i B_i of two [..., d, d] stacks. `kernel`: kernel K3
    (`ops/block_mm_cuda.py`: the CUDA kernel on a CUDA tensor, the plain
    product on a CPU one); False: the plain product on any device (the
    kernel-vs-plain comparison on the card)."""
    return block_mm_cuda.block_mm(A, B) if kernel else A @ B


def block_mv(A: torch.Tensor, v: torch.Tensor, kernel: bool = True
             ) -> torch.Tensor:
    """Per-block A_i v_i: [..., d, d] x [..., d] -> [..., d]; `kernel` as
    in block_mm."""
    if kernel:
        return block_mm_cuda.block_mv(A, v)
    return (A @ v[..., None])[..., 0]


def sym_block_diag_product(A: torch.Tensor, B: torch.Tensor,
                           C: torch.Tensor, kernel: bool = True
                           ) -> torch.Tensor:
    """Per-block A_i @ sym(B_i^T C_i) (SOdProduct::SymBlockDiagProduct in
    true-rotation storage); `kernel` as in block_mm."""
    S = sym(block_mm(B.transpose(-1, -2), C, kernel))
    return block_mm(A, S, kernel)


def proj_tangent(R: torch.Tensor, V: torch.Tensor, kernel: bool = True
                 ) -> torch.Tensor:
    """Project ambient V onto the tangent space of SO(d)^n at R:
    P = V - R sym(R^T V); `kernel` as in block_mm."""
    return V - sym_block_diag_product(R, R, V, kernel)


def retract(R: torch.Tensor, V: torch.Tensor, kernel: bool = True
            ) -> torch.Tensor:
    """Add-then-project retraction (SOdProduct::retract)."""
    return project_sod(R + V, kernel)


def random_rotations(generator: torch.Generator, n: int, d: int,
                     dtype=torch.float64, device=None) -> torch.Tensor:
    """n rotations of SO(d): standard normal matrices drawn from
    `generator` (on its device unless `device` names one), projected."""
    device = generator.device if device is None else device
    A = torch.randn((n, d, d), generator=generator, dtype=dtype,
                    device=device)
    return project_sod(A)
