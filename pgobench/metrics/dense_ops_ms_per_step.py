"""Device milliseconds per step of everything the traced solves ran on the
card except the two hand kernels (K1 stpcg, K2 polar_so3) and the
conditional nodes' flag kernel: the dense operator images (cuBLAS) and
the elementwise work around them."""

LAYER = "Problem ops, dense"
UNIT = "ms/step"
MOVES = "iters_per_s"
OWN = ("stpcg_kernel", "polar_so3_kernel", "set_cond")


def read(r):
    if r.trace is None or r.card == "cpu":
        return None
    secs, n = r.trace.device_s(lambda name: not any(k in name for k in OWN))
    if not n:
        return None
    return 1e3 * secs / r.traced_steps
