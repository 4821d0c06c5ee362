"""Device milliseconds per step of rank 0's NCCL kernels (names beginning
"nccl") in the traced solves: each step's boundary all_gather, at the top
level of the captured step, and once per solve the answer's all_gather
and objective sum. An NCCL kernel runs from its start until every rank
has joined it, so its time holds the exchange and the wait for the
slowest rank. None where the trace holds no NCCL kernel (gloo, or one
process)."""

LAYER = "Sharded driver"
UNIT = "ms/step"
MOVES = "sharded_iters_per_s"


def read(r):
    if r.trace is None or r.card == "cpu":
        return None
    secs, n = r.trace.device_s(lambda name: name.startswith("nccl"))
    if not n:
        return None
    return 1e3 * secs / r.traced_steps
