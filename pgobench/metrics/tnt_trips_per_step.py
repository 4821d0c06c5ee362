"""Outer iterations of the TNT refinement per step over the window, from
the program's device counters: the first iteration, peeled out of the
loop, once per entry ("tnt.entries"), and the loop's trips after it
("tnt.trips"). 0 where the mix runs no TNT."""

LAYER = "Iterate and TNT"
UNIT = "trips/step"
MOVES = "iters_per_s"


def read(r):
    return (r.counters["tnt.entries"] + r.counters["tnt.trips"]) / r.steps
