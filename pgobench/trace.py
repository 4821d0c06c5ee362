"""Reading a torch.profiler session: device activity, its union over a
window, and the breakdown of where the window's time went.

Times are the profiler's microseconds. The session records the card's
activity alone: device operations, and the CUDA API calls on the host that
launch and wait for them; the window runs from the first of these to the
last."""

from __future__ import annotations

import dataclasses

NAME_CHARS = 160  # kernel names are clipped to this in the breakdown


@dataclasses.dataclass
class Trace:
    device: list   # [(name, start_us, end_us)] kernels, copies, sets
    host: list     # [(name, start_us, end_us)] CUDA API calls
    window: tuple  # (start_us, end_us)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device (the union of the device intervals)."""
        return sum(e - s for s, e in _merged(self.in_window())) * 1e-6

    def device_s(self, match) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        satisfies match(name), inside the window."""
        hits = [(s, e) for n, s, e in self.in_window() if match(n)]
        return sum(e - s for s, e in hits) * 1e-6, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event under each gap's middle."""
        by_name: dict = {}
        for n, s, e in self.in_window():
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        merged = _merged(self.in_window())
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            under = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            name = min(under)[1] if under else "host: no CUDA call"
            named.append([name[:NAME_CHARS], (b - a) * 1e-6])
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": named}


def _merged(iv):
    """The union of [(name, start, end)] as sorted disjoint (start, end)."""
    out = []
    for _, s, e in sorted(iv, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def from_profile(prof, card: bool = True) -> Trace:
    """The Trace of a finished torch.profiler session of CUDA activity (on
    a CPU device, of CPU activity: its operators stand for the device's)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        iv = (ev.name, ev.time_range.start, ev.time_range.end)
        on_device = ev.device_type == DeviceType.CUDA or not card
        (device if on_device else host).append(iv)
    if not device:
        raise RuntimeError("the trace holds no device operation")
    every = device + host
    return Trace(device=device, host=host,
                 window=(min(s for _, s, _ in every),
                         max(e for _, _, e in every)))
