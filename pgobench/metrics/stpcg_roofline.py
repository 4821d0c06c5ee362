"""K1's share of its roofline: the least time a launch could take
(roofline.stpcg_work at this partition, bytes bind) over the device time
per launch in the trace. Read only where the trace's K1 launches equal the
program's "stpcg" counter over the same solves: a launch the trace lacks
(inside a conditional body) would make the time per launch wrong."""

from pgobench import roofline

LAYER = "Kernel K1"
UNIT = "%"
MOVES = "iters_per_s"


def read(r):
    if r.trace is None:
        return None
    secs, n = r.trace.device_s(lambda name: "stpcg_kernel" in name)
    if not n or n != r.traced_counters["stpcg"]:
        return None
    n0, _ = roofline.partition(r.num_poses, r.num_nodes)
    bound = roofline.bound_s(roofline.stpcg_work(r.num_nodes, n0, r.d),
                             r.card)
    if bound is None:
        return None
    return 100.0 * bound / (secs / n)
