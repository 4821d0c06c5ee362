"""Kernel K1 wrapper: the whole Steihaug-Toint truncated preconditioned CG of
every node's TNT trust-region subproblem in one launch (`csrc/stpcg.cu`).

Replaces dpgo_tpu/ops/pallas_stpcg.py::stpcg_fused. A CPU tensor goes to the
plain version `ops/stpcg.py::stpcg_fused_reference`; a CUDA tensor goes to
the kernel, or the call raises. There is no fallback from one to the other.

The Hopper gate replacing the TPU's `fits_vmem`: the operators are streamed
from global memory on every matvec and only the node's vectors live in
shared memory, so the kernel takes any dense-path node block with d = 2 or
3, float32, on a CUDA device (`supported`). The kernel is instantiated for
both d, as the Pallas kernel is generic in d.

Each node runs on one thread-block cluster of C CTAs (`CLUSTER_SIZES`).
`choose_cluster_size` picks C from the card's answer to how many such
clusters it holds at once (`resident_clusters`, asked once per shape); the
`cluster` keyword forces one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dpgo_tpu_torch.ops import _build
from dpgo_tpu_torch.ops.stpcg import stpcg_fused_reference
from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

DIMS = (2, 3)  # the kernel's instantiations (pose block d x d)
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs per node; 8 is the portable maximum
# The DeviceCounters name of each instantiation.
COUNTERS = {2: "stpcg_d2", 3: "stpcg"}


class Launches:
    """Kernel launch counters (plain integers, bumped once per launch):
    `count` over all launches, `by_d` per instantiation. A launch recorded
    into a CUDA graph counts once here, at capture; the device counters
    (`utils.DeviceCounters`, names in COUNTERS) count every replay."""

    count = 0
    by_d = {d: 0 for d in DIMS}

    @classmethod
    def reset(cls):
        cls.count = 0
        cls.by_d = {d: 0 for d in DIMS}


def supported(d: int, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether K1 takes a dense-path problem of this shape and placement."""
    return d in DIMS and dtype == torch.float32 and device.type == "cuda"


def choose_cluster_size(N: int, npose: int, resident: dict) -> int:
    """The cluster size for N nodes of npose poses: the largest C of
    CLUSTER_SIZES with which all N clusters are resident at once
    (`resident[C]` clusters fit on the card) and every CTA owns a pose
    (C <= npose); when none does, the smallest C that fits at all (1 unless
    a CTA of one per node exceeds shared memory), and the clusters run in
    waves."""
    fits = [C for C in CLUSTER_SIZES
            if C <= npose and resident.get(C, 0) > 0]
    if not fits:
        raise ValueError(f"stpcg_fused: no cluster size fits {npose} poses "
                         f"on this card (resident clusters {resident})")
    full = [C for C in fits if resident[C] >= N]
    return max(full) if full else fits[0]


def resident_clusters(d: int, nd: int, device: torch.device) -> dict:
    """{C: clusters of C CTAs the card holds at once} for K1 at (d, nd),
    from cudaOccupancyMaxActiveClusters; 0 where C exceeds the pose count or
    a CTA does not fit. Asked once per shape and device."""
    return dict(_resident(device.index, d, nd))


@functools.cache
def _resident(index: int, d: int, nd: int) -> tuple:
    lib = _build.load()
    out = ctypes.c_int()
    res = []
    with torch.cuda.device(index):
        for C in CLUSTER_SIZES:
            n = 0
            if C <= nd // d:
                _build.check(lib.dpgo_stpcg_clusters(nd, d, C,
                                                     ctypes.byref(out)),
                             "stpcg occupancy")
                n = out.value
            res.append((C, n))
    return tuple(res)


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, device):
    if x.device != device:
        raise ValueError(f"stpcg_fused: {name} on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"stpcg_fused: {name} is {x.dtype}, kernel takes "
                        f"{dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"stpcg_fused: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"stpcg_fused: {name} must be contiguous")


def _check_args(H, P, g, v0, Q, S, Delta, active, cluster):
    """What the kernel takes, on any device: d, shapes, float32 operators and
    vectors, a bool `active`, contiguity, a cluster size of CLUSTER_SIZES.
    Returns (N, nd, d)."""
    if g.dim() != 3:
        raise ValueError(f"stpcg_fused: g must be [N, nd, d], got "
                         f"{tuple(g.shape)}")
    N, nd, d = g.shape
    dev, f32 = g.device, torch.float32
    if d not in DIMS:
        raise ValueError(f"stpcg_fused: kernel takes d in {DIMS}, got {d}")
    if nd % d:
        raise ValueError(f"stpcg_fused: nd = {nd} is not a multiple of {d}")
    for name, x, shape in (("H", H, (N, nd, nd)), ("P", P, (N, nd, nd)),
                           ("g", g, (N, nd, d)), ("v0", v0, (N, nd, d)),
                           ("Q", Q, (N, nd, d)), ("S", S, (N, nd, d)),
                           ("Delta", Delta, (N,))):
        _check(name, x, shape, f32, dev)
    _check("active", active, (N,), torch.bool, dev)
    if cluster is not None and (cluster not in CLUSTER_SIZES
                                or cluster > nd // d):
        raise ValueError(f"stpcg_fused: cluster {cluster} is not one of "
                         f"{CLUSTER_SIZES} up to the {nd // d} poses")
    return N, nd, d


def stpcg_fused(H, P, g, v0, Q, S, Delta, active, *, max_iters: int,
                kappa_fgr: float, theta: float,
                syncs: HostSyncs | None = None, cluster: int | None = None):
    """Batched fused STPCG for N nodes.

    H, P: [N, nd, nd] reduced Hessian Hred and dense preconditioner;
    g, v0, Q, S: [N, nd, d] gradient, preconditioned gradient, iterate and
    curvature blocks sym(Q_p nabla_p^T), tall storage; Delta [N]; active [N]
    bool. `cluster` forces the CTAs per node (default: choose_cluster_size).
    Returns (h, H h [N, nd, d], |h|_M [N], k [N] int32)."""
    if g.device.type == "cpu":
        return stpcg_fused_reference(H, P, g, v0, Q, S, Delta, active,
                                     max_iters=max_iters,
                                     kappa_fgr=kappa_fgr, theta=theta,
                                     syncs=syncs)
    N, nd, d = _check_args(H, P, g, v0, Q, S, Delta, active, cluster)
    if g.device.type != "cuda":
        raise ValueError(f"stpcg_fused: unsupported device {g.device}")
    dev = g.device
    resident = resident_clusters(d, nd, dev)
    C = cluster or choose_cluster_size(N, nd // d, resident)
    if resident[C] == 0:
        raise ValueError(f"stpcg_fused: a cluster of {C} does not fit at "
                         f"nd = {nd}, d = {d} (resident {resident})")

    lib = _build.load()
    h = torch.empty_like(g)
    Hh = torch.empty_like(g)
    norm = torch.empty(N, dtype=torch.float32, device=dev)
    k = torch.empty(N, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dpgo_stpcg(
            H.data_ptr(), P.data_ptr(), g.data_ptr(), v0.data_ptr(),
            Q.data_ptr(), S.data_ptr(), Delta.data_ptr(), active.data_ptr(),
            h.data_ptr(), Hh.data_ptr(), norm.data_ptr(), k.data_ptr(), N,
            nd, d, C, int(max_iters), float(kappa_fgr), float(theta), stream)
    _build.check(err, "stpcg")
    DeviceCounters.bump(COUNTERS[d], dev)
    Launches.count += 1
    Launches.by_d[d] += 1
    return h, Hh, norm, k
