"""Kernel K3 wrapper: batched products of small square blocks
(`csrc/block_mm.cu`).

`block_mm(A, B)` is A @ B and `block_mv(A, v)` is (A @ v[..., None])[..., 0]
over stacks of d x d blocks [..., d, d] (d = 2 or 3, float32 or float64)
whose batch shapes broadcast. Transposed views, and broadcasts over one
flat batch index, arrive as strides and are not copied; a batch that does
not flatten to one index (a broadcast over the leading of two batch axes,
a slice) is copied first. The shapes are checked on every device; a CPU
tensor then goes to the plain version (the torch product itself), a CUDA
tensor to the kernel, or the call raises. There is no fallback from one to
the other.

The kernel counts its own launches: it adds 1 (on the warm route, the
enclosing branch's flag) to the `DeviceCounters` tensor "block_mm" whose
pointer it is given, inside the same launch.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.ops import _build
from dpgo_tpu_torch.utils import DeviceCounters, live_flag

DIMS = (2, 3)  # the kernel's instantiations (block d x d)
_DTYPES = {torch.float32: 0, torch.float64: 1}
COUNTER = "block_mm"  # the DeviceCounters name of the kernel's launches


class Launches:
    """Kernel launches (a plain integer, bumped once per launch). A launch
    recorded into a CUDA graph counts once here, at capture; the device
    counter COUNTER counts every replay."""

    count = 0

    @classmethod
    def reset(cls):
        cls.count = 0


def _check(what: str, A: torch.Tensor, B: torch.Tensor, b_dims: int):
    """What the kernel takes, on any device: A [..., d, d] with d in DIMS,
    B [..., d, d] (b_dims 2) or [..., d] (1) with a batch shape that
    broadcasts with A's, one type of _DTYPES, one device. Returns (d, the
    broadcast batch shape)."""
    if A.dim() < 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{what}: A must be a stack of square blocks "
                         f"[..., d, d], got {tuple(A.shape)}")
    d = A.shape[-1]
    if d not in DIMS:
        raise ValueError(f"{what}: kernel takes d in {DIMS}, got {d}")
    if B.dim() < b_dims + 1 or tuple(B.shape[-b_dims:]) != (d,) * b_dims:
        raise ValueError(f"{what}: B has shape {tuple(B.shape)}, expected "
                         f"[..., {', '.join(['d'] * b_dims)}] with d = {d}")
    batch = A.shape[:-2]
    if B.shape[:-b_dims] != batch:
        try:
            batch = torch.broadcast_shapes(batch, B.shape[:-b_dims])
        except RuntimeError as e:
            raise ValueError(f"{what}: batch shapes {tuple(A.shape[:-2])} "
                             f"and {tuple(B.shape[:-b_dims])} do not "
                             "broadcast") from e
    if A.dtype not in _DTYPES or B.dtype != A.dtype:
        raise TypeError(f"{what}: kernel takes float32 or float64 operands "
                        f"of one type, got {A.dtype} and {B.dtype}")
    if A.device != B.device:
        raise ValueError(f"{what}: operands on {A.device} and {B.device}")
    return d, tuple(batch)


def _strides(x: torch.Tensor, tail: int) -> tuple:
    """(x or a contiguous copy, batch stride, row stride, column stride) of
    x's `tail` trailing dims under one flat batch index: x's own strides
    where its batch dims collapse to one (a contiguous stack, a transpose
    view, a broadcast), else those of a contiguous copy."""
    lead = [(n, s) for n, s in zip(x.shape[:-tail], x.stride()[:-tail])
            if n != 1]
    if any(s0 != s1 * n1 for (_, s0), (n1, s1) in zip(lead, lead[1:])):
        x = x.contiguous()
        return _strides(x, tail)
    inner = x.stride()[-tail:]
    bs = lead[-1][1] if lead else x.shape[-1] ** tail
    return (x, bs) + tuple(inner) + (0,) * (2 - tail)


def _launch(A: torch.Tensor, B: torch.Tensor, d: int, batch: tuple,
            mv: bool):
    if A.device.type != "cuda":
        raise ValueError(f"block_mm: unsupported device {A.device}")
    b_tail = (d,) if mv else (d, d)
    out = torch.empty(batch + b_tail, dtype=A.dtype, device=A.device)
    n = out.numel() // d ** len(b_tail)
    if n == 0:
        return out
    if A.shape[:-2] != batch:
        A = A.expand(batch + (d, d))
    if B.shape[:-len(b_tail)] != batch:
        B = B.expand(batch + b_tail)
    A, a_bs, a_rs, a_cs = _strides(A, 2)
    B, b_bs, b_rs, b_cs = _strides(B, len(b_tail))
    counter = DeviceCounters.tensor(COUNTER, A.device)
    live = live_flag()
    args = (A.data_ptr(), a_bs, a_rs, a_cs, B.data_ptr(), b_bs, b_rs, b_cs,
            out.data_ptr(), n, d, _DTYPES[A.dtype], int(mv),
            counter.data_ptr(), None if live is None else live.data_ptr())
    fn = _build.load().dpgo_block_mm
    if A.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(A.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "block_mm")
    Launches.count += 1
    return out


def block_mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B per block: [..., d, d] x [..., d, d] -> [..., d, d]."""
    d, batch = _check("block_mm", A, B, 2)
    if A.device.type == "cpu":
        return A @ B
    return _launch(A, B, d, batch, mv=False)


def block_mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v per block: [..., d, d] x [..., d] -> [..., d]."""
    d, batch = _check("block_mv", A, v, 1)
    if A.device.type == "cpu":
        return (A @ v[..., None])[..., 0]
    return _launch(A, v, d, batch, mv=True)
