"""K2's share of its roofline: the least time a launch on the node-batched
rotations [N n0_max, 3, 3] could take (roofline.polar_so3_work, bytes
bind) over the device time per launch in the trace. Read only where the
trace's K2 launches equal the program's "polar_so3" counter over the same
solves."""

from pgobench import roofline

LAYER = "Kernel K2"
UNIT = "%"
MOVES = "iters_per_s"


def read(r):
    if r.trace is None:
        return None
    secs, n = r.trace.device_s(lambda name: "polar_so3_kernel" in name)
    if not n or n != r.traced_counters["polar_so3"]:
        return None
    n0, _ = roofline.partition(r.num_poses, r.num_nodes)
    bound = roofline.bound_s(roofline.polar_so3_work(r.num_nodes * n0),
                             r.card)
    if bound is None:
        return None
    return 100.0 * bound / (secs / n)
