"""Small shared utilities."""

from __future__ import annotations

import time

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the CUDA card unless the caller
    names another (`device="cpu"` for the CPU). Raises when a CUDA device is
    asked for on a host without one; never picks the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dpgo_tpu_torch runs on a CUDA card by default and "
                           "this host has none; pass device='cpu' to run on "
                           "the CPU")
    return dev


class HostSyncs:
    """Counts the device-to-host reads of control flags.

    The JAX package keeps the whole step on the device (`lax.scan`,
    `lax.cond`, `lax.while_loop`). This port reads those loop and branch
    flags on the host instead (`if syncs.flag(mask.any()):`); each read waits
    for the device. The solver owns one counter and reports syncs per step.
    PCM reads one consistency mask per node pair through `read`, which
    counts the same way.

    `loops` holds, per host-driven loop that reports to it by name
    ("seg_cg": the segment path's translation CG, "stpcg": the torch STPCG,
    "lobpcg": the certificate's eigensolver), [times entered, trips in all];
    the certificate's host round trips report there too, one trip each
    ("lred_host": the host SuperLU solve inside S above the dense limit,
    "apply_S_host": an ARPACK matvec, "schur_host": the shift-invert
    preconditioner).
    """

    def __init__(self):
        self.count = 0
        self.loops: dict[str, list[int]] = {}

    def flag(self, x: torch.Tensor) -> bool:
        self.count += 1
        return bool(x)

    def read(self, x: torch.Tensor):
        """One read of a whole tensor (a mask) to the host, as numpy."""
        self.count += 1
        return x.cpu().numpy()

    def note(self, loop: str, trips: int) -> None:
        entry = self.loops.setdefault(loop, [0, 0])
        entry[0] += 1
        entry[1] += trips


class Stopwatch:
    """tick()/tock() wall-clock timer (the reference's
    Optimization::Util::Stopwatch); tock returns seconds since tick.
    `tock(sync=x)` first waits for the card that holds tensor `x` (or for
    the CUDA device `x`), since the card runs behind the host."""

    def __init__(self):
        self._t0 = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self, sync=None) -> float:
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) \
                else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if self._t0 is None:
            raise RuntimeError("tock() before tick()")
        return time.perf_counter() - self._t0
