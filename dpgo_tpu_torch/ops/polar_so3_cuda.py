"""Kernel K2 wrapper: batched SO(3) projection (`csrc/polar_so3.cu`).

Replaces dpgo_tpu/ops/pallas_so3.py::polar_so3_pallas. A CPU tensor goes to
the plain version `ops/so3.py::polar_so3`; a CUDA tensor goes to the kernel,
or the call raises. There is no fallback from one to the other. The kernel
is instantiated for float32 and float64 (the solver's default type).
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.ops import _build
from dpgo_tpu_torch.ops.so3 import polar_so3
from dpgo_tpu_torch.utils import DeviceCounters

# The C entry point of each instantiation.
_SYMBOLS = {torch.float32: "dpgo_polar_so3", torch.float64: "dpgo_polar_so3_f64"}
# The DeviceCounters name of each instantiation.
COUNTERS = {torch.float32: "polar_so3", torch.float64: "polar_so3_f64"}


class Launches:
    """Kernel launch counters (plain integers, bumped once per launch):
    `count` over all launches, `by_dtype` per instantiation. A launch
    recorded into a CUDA graph counts once here, at capture; the device
    counters (`utils.DeviceCounters`, names in COUNTERS) count every
    replay."""

    count = 0
    by_dtype = {dt: 0 for dt in _SYMBOLS}

    @classmethod
    def reset(cls):
        cls.count = 0
        cls.by_dtype = {dt: 0 for dt in _SYMBOLS}


def polar_so3_cuda(A: torch.Tensor) -> torch.Tensor:
    """Project [n, 3, 3] onto SO(3)."""
    if A.device.type == "cpu":
        return polar_so3(A)
    if A.device.type != "cuda":
        raise ValueError(f"polar_so3_cuda: unsupported device {A.device}")
    if A.dtype not in _SYMBOLS:
        raise TypeError("polar_so3_cuda: kernel takes float32 or float64, "
                        f"got {A.dtype}")
    if A.dim() != 3 or A.shape[1:] != (3, 3):
        raise ValueError(f"polar_so3_cuda: expected [n, 3, 3], got "
                         f"{tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("polar_so3_cuda: input must be contiguous")
    fn = getattr(_build.load(), _SYMBOLS[A.dtype])
    out = torch.empty_like(A)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], stream)
    _build.check(err, "polar_so3")
    DeviceCounters.bump(COUNTERS[A.dtype], A.device)
    Launches.count += 1
    Launches.by_dtype[A.dtype] += 1
    return out
