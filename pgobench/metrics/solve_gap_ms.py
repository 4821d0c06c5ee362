"""The card's milliseconds between consecutive solves of the window: the
median, over the window's back-to-back solves, of the time from one
`solve` span's end event (after its last replay) to the next one's start
event (before its first replay), on the card's own clock. The gap holds
the copy of the result, the gather and the answer's host copy, the host
work around them and the next solve's load. The window's solves are the
ring's `solve` records before the traced ones. None on the CPU, where the
program keeps no spans, or where the ring no longer holds the window."""

import statistics

from pgobench import spans

LAYER = "Step control flow"
UNIT = "ms/solve"
MOVES = "iters_per_s"


def read(r):
    reg = spans.registry()
    if r.card == "cpu" or reg is None:
        return None
    solves = spans.window_solves(reg.records("solve"), r.steps,
                                 r.traced_steps)
    if solves is None or len(solves) < 2:
        return None
    return statistics.median(reg.card_ms(a, b)
                             for a, b in zip(solves, solves[1:]))
