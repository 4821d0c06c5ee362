"""Kernel K1 wrapper: the whole Steihaug-Toint truncated preconditioned CG of
every node's TNT trust-region subproblem in one launch (`csrc/stpcg.cu`).

Replaces dpgo_tpu/ops/pallas_stpcg.py::stpcg_fused. A CPU tensor goes to the
plain version `ops/stpcg.py::stpcg_fused_reference`; a CUDA tensor goes to
the kernel, or the call raises. There is no fallback from one to the other.

The Hopper gate replacing the TPU's `fits_vmem`: nothing has to fit in
shared memory (the kernel streams the operators from global memory on every
matvec), so the kernel takes any dense-path node block with d = 2 or 3,
float32, on a CUDA device (`supported`). The kernel is instantiated for both
d, as the Pallas kernel is generic in d.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.ops import _build
from dpgo_tpu_torch.ops.stpcg import stpcg_fused_reference, stpcg_target
from dpgo_tpu_torch.utils import HostSyncs

DIMS = (2, 3)  # the kernel's instantiations (pose block d x d)
SCRATCH_VECTORS = 4  # r, v, p, H p per node


class Launches:
    """Kernel launch counters (plain integers, bumped once per launch):
    `count` over all launches, `by_d` per instantiation."""

    count = 0
    by_d = {d: 0 for d in DIMS}

    @classmethod
    def reset(cls):
        cls.count = 0
        cls.by_d = {d: 0 for d in DIMS}


def supported(d: int, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether K1 takes a dense-path problem of this shape and placement."""
    return d in DIMS and dtype == torch.float32 and device.type == "cuda"


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, device):
    if x.device != device:
        raise ValueError(f"stpcg_fused: {name} on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"stpcg_fused: {name} is {x.dtype}, kernel takes "
                        f"{dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"stpcg_fused: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"stpcg_fused: {name} must be contiguous")


def stpcg_fused(H, P, g, v0, Q, S, Delta, active, *, max_iters: int,
                kappa_fgr: float, theta: float,
                syncs: HostSyncs | None = None):
    """Batched fused STPCG for N nodes.

    H, P: [N, nd, nd] reduced Hessian Hred and dense preconditioner;
    g, v0, Q, S: [N, nd, d] gradient, preconditioned gradient, iterate and
    curvature blocks sym(Q_p nabla_p^T), tall storage; Delta [N]; active [N]
    bool. Returns (h, H h [N, nd, d], |h|_M [N], k [N] int32)."""
    if g.device.type == "cpu":
        return stpcg_fused_reference(H, P, g, v0, Q, S, Delta, active,
                                     max_iters=max_iters,
                                     kappa_fgr=kappa_fgr, theta=theta,
                                     syncs=syncs)
    if g.device.type != "cuda":
        raise ValueError(f"stpcg_fused: unsupported device {g.device}")
    N, nd, d = g.shape
    dev, f32 = g.device, torch.float32
    if d not in DIMS:
        raise ValueError(f"stpcg_fused: kernel takes d in {DIMS}, got {d}")
    for name, x, shape in (("H", H, (N, nd, nd)), ("P", P, (N, nd, nd)),
                           ("g", g, (N, nd, d)), ("v0", v0, (N, nd, d)),
                           ("Q", Q, (N, nd, d)), ("S", S, (N, nd, d)),
                           ("Delta", Delta, (N,))):
        _check(name, x, shape, f32, dev)
    _check("active", active, (N,), torch.bool, dev)
    if nd % d:
        raise ValueError(f"stpcg_fused: nd = {nd} is not a multiple of {d}")
    target = stpcg_target(g, v0, kappa_fgr, theta).contiguous()
    act = active.to(f32).contiguous()

    lib = _build.load()
    h = torch.empty_like(g)
    Hh = torch.empty_like(g)
    norm = torch.empty(N, dtype=f32, device=dev)
    k = torch.empty(N, dtype=torch.int32, device=dev)
    scratch = torch.empty((N, SCRATCH_VECTORS, nd, d), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dpgo_stpcg(
            H.data_ptr(), P.data_ptr(), g.data_ptr(), v0.data_ptr(),
            Q.data_ptr(), S.data_ptr(), Delta.data_ptr(), act.data_ptr(),
            target.data_ptr(), h.data_ptr(), Hh.data_ptr(), norm.data_ptr(),
            k.data_ptr(), scratch.data_ptr(), N, nd, d, int(max_iters),
            stream)
    _build.check(err, "stpcg")
    Launches.count += 1
    Launches.by_d[d] += 1
    return h, Hh, norm, k
