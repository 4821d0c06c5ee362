"""solve_gap_ms of a cell on several cards, read on rank 0 by the same
reader: a metric of its own because it moves that cell's own rate,
sharded_iters_per_s."""

from pgobench import manifest

LAYER = "Step control flow"
UNIT = "ms/solve"
MOVES = "sharded_iters_per_s"


def read(r):
    return manifest.reader("solve_gap_ms").read(r)
