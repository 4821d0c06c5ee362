"""host_syncs_per_step of a cell on several cards, read on rank 0 by the same
reader: a metric of its own because it moves that cell's own rate,
sharded_iters_per_s."""

from pgobench import manifest

LAYER = "Step control flow"
UNIT = "syncs/step"
MOVES = "sharded_iters_per_s"


def read(r):
    return manifest.reader("host_syncs_per_step").read(r)
