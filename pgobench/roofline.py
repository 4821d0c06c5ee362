"""Peaks of the card and the work of the program's two hand kernels,
counted from shapes alone.

A roofline bound is the least time the card could take for a call: the
larger of its bytes over the memory rate and its operations over the peak
rate of their type. Each input is counted as read once and each output as
written once, whatever the kernel reads again.
"""

from __future__ import annotations

import math

# Published dense peaks (NVIDIA's H100 SXM data sheet, at the full 700 W):
# HBM3 bytes/s and float32 / float64 operations/s outside the tensor cores,
# the kernels' types.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "float32_s": 67e12,
                              "float64_s": 34e12},
}

F32 = 4
# K2's float operations per 3 x 3 matrix (csrc/polar_so3.cu): the
# normalization and 9 Newton steps, ~120 each.
POLAR_SO3_FLOPS = 1110


def partition(num_poses: int, num_nodes: int) -> tuple[int, int]:
    """(n0_max, n0_min): the most and least poses a node holds when the
    poses are split into contiguous blocks as evenly as they go."""
    return math.ceil(num_poses / num_nodes), num_poses // num_nodes


def stpcg_work(num_nodes: int, n0: int, d: int) -> dict:
    """K1 (`csrc/stpcg.cu`), one launch over N nodes of n0 poses: the
    reduced Hessian Hred and the preconditioner P [N, nd, nd] (nd = n0 d)
    read once; the vectors g, v0, Q, S [N, nd, d] read once and h, H h
    written once; Delta, active, |h| and k per node. Operations: one CG
    iteration per node, one Hred and one P product (2 nd^2 d each), the
    least a launch does; bytes bind the bound long before."""
    nd = n0 * d
    operators = 2 * num_nodes * nd * nd * F32
    vectors = 6 * num_nodes * nd * d * F32
    scalars = num_nodes * (F32 + 1 + F32 + 4)
    return {"operator_bytes": operators,
            "bytes": operators + vectors + scalars,
            "flops": num_nodes * 4 * nd * nd * d}


def polar_so3_work(num_matrices: int) -> dict:
    """K2 (`csrc/polar_so3.cu`), one launch on [M, 3, 3] float32: read once,
    written once."""
    return {"bytes": 2 * num_matrices * 9 * F32,
            "flops": num_matrices * POLAR_SO3_FLOPS}


def bound_s(work: dict, card: str, flop_type: str = "float32_s"):
    """The least seconds the card takes for `work`, or None for a card
    with no peaks in the table."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return max(work["bytes"] / peak["bytes_s"], work["flops"] / peak[flop_type])
