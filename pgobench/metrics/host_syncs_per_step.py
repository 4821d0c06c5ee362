"""Host reads of a control flag per step over the window (solver.syncs):
0 on the graph route."""

LAYER = "Step control flow"
UNIT = "syncs/step"
MOVES = "iters_per_s"


def read(r):
    return r.host_syncs / r.steps
