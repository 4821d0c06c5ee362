"""Seconds of the step's warm-up and capture as a CUDA graph, as the
program reports them (DPGOSolver.graph_stats)."""

LAYER = "Step control flow"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    if r.card == "cpu":
        return None
    return r.spans["warmup_s"] + r.spans["capture_s"]
