"""Bytes the program's collectives landed in rank 0's buffers per step
over the window, from its device counter "collective_bytes"
(parallel/spmd.py, Collectives): every step's boundary all_gather,
captured in the step, and once per solve the answer's all_gather of the
own blocks and the sum of the objectives, spread over the solve's steps.
The window's decisions travel on the host and are not counted. None where
the run made no collective (one process)."""

LAYER = "Sharded driver"
UNIT = "bytes/step"
MOVES = "sharded_iters_per_s"


def read(r):
    if not r.counters.get("collectives"):
        return None
    return r.counters["collective_bytes"] / r.steps
