"""The program's own spans (`dpgo_tpu_torch.utils.Spans`), as the
per-layer readers see them: None where the program keeps no spans."""

from __future__ import annotations


def registry():
    """The program's span registry, or None where it has none."""
    from dpgo_tpu_torch import utils
    return getattr(utils, "Spans", None)


def host_s(name: str) -> float | None:
    """Host seconds of the program's spans named `name`, summed (None
    where there are none)."""
    spans = registry()
    return None if spans is None else spans.host_s(name)


def window_solves(solves: list, steps: int, traced_steps: int):
    """The window's solves among `solves` (the ring's `solve` records,
    oldest first): from the newest, the records covering `traced_steps`
    steps are the traced solves and are skipped; the records before them
    covering `steps` steps are the window's, returned oldest first. None
    where the ring no longer holds all of them."""
    rest = list(solves)
    covered = 0
    while covered < traced_steps:
        if not rest:
            return None
        covered += rest.pop().steps
    window, covered = [], 0
    while covered < steps:
        if not rest:
            return None
        rec = rest.pop()
        window.append(rec)
        covered += rec.steps
    return window[::-1]
