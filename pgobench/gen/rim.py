"""The rim family: a multi-floor building sweep (frozen, vectorized copy of
the repository's `tools/make_rim.py`).

Each floor is a boustrophedon sweep of `rows` rows of `cols` poses, floors
3 m apart; the graph holds the odometry chain, same-floor revisits between
adjacent sweep rows (every 4th column) and inter-floor closures at
vertically aligned poses (every 4th row, every 8th column). Noise is drawn
in the order of the loop version, so seed 1 at 10 x 16 x 64 gives the
edges of `artifacts/rim_synth.g2o` to its printed precision.

Given `num_poses` and `num_edges`, the sweep stops after its first
`num_poses` poses and holds exactly `num_edges` edges: the chain, and
closures drawn from the seed among every same-floor revisit (the same x,
or one column off, in an adjacent sweep row) and every vertically aligned
pair of adjacent floors. That is how a published graph's counts (rim.g2o:
10,195 poses, 29,743 edges) are kept where its measurements are not in
the repository.
"""

from __future__ import annotations

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula for rotation vectors w [..., 3]."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)
    safe = np.where(th < 1e-12, 1.0, th)
    k = w / safe[..., None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(th)[..., None, None]
    c = (1.0 - np.cos(th))[..., None, None]
    R = np.eye(3) + s * K + c * (K @ K)
    return np.where((th < 1e-12)[..., None, None], np.eye(3), R)


def graph(seed: int, floors: int, rows: int, cols: int,
          rot_noise: float, trans_noise: float,
          num_poses: int | None = None, num_edges: int | None = None
          ) -> dict:
    """The graph as plain arrays: edges i, j [m]; relative rotations R
    [m, 3, 3] and translations t [m, 3] (frame j in frame i); precisions
    kappa, tau [m] (from isotropic information 1 / noise^2 by the g2o
    convention: tau = 3 / tr(I_t^-1), kappa = 3 / (2 tr(I_R^-1))); the
    ground truth t_true [P, 3], R_true [P, 3, 3]; num_poses; d = 3."""
    rng = np.random.default_rng(seed)
    F, Rw, C = floors, rows, cols
    n = F * Rw * C
    f, r, c = (a.ravel() for a in np.meshgrid(np.arange(F), np.arange(Rw),
                                              np.arange(C), indexing="ij"))
    odd = r % 2 == 1
    x = np.where(odd, C - 1 - c, c)
    t_true = np.stack([x, 2.0 * r, 3.0 * f], axis=1).astype(np.float64)
    yaw = np.zeros((n, 3))
    yaw[odd, 2] = np.pi
    R_true = so3_exp(yaw) @ so3_exp(0.05 * rng.normal(size=(n, 3)))

    def pid(f, r, c):
        return (f * Rw + r) * C + c

    if num_edges is None:
        edges = _sparse_edges(F, Rw, C, pid)
    else:
        n = n if num_poses is None else int(num_poses)
        t_true, R_true = t_true[:n], R_true[:n]
        edges = _counted_edges(F, Rw, C, pid, n, int(num_edges), rng)

    i, j = edges[:, 0], edges[:, 1]
    m = len(i)
    noise = rng.normal(size=(m, 2, 3))
    Rt_i = np.swapaxes(R_true[i], 1, 2)
    R = Rt_i @ R_true[j] @ so3_exp(rot_noise * noise[:, 0])
    t = np.einsum("mab,mb->ma", Rt_i, t_true[j] - t_true[i]) \
        + trans_noise * noise[:, 1]
    # Isotropic information 1 / sigma^2 per axis: tr(I^-1) = 3 sigma^2.
    tau = np.full(m, 3.0 / (3.0 * trans_noise ** 2))
    kappa = np.full(m, 3.0 / (2.0 * 3.0 * rot_noise ** 2))
    return {"i": i.astype(np.int64), "j": j.astype(np.int64), "R": R,
            "t": t, "kappa": kappa, "tau": tau, "t_true": t_true,
            "R_true": R_true, "num_poses": n, "d": 3}


def _sparse_edges(F, Rw, C, pid):
    """The chain, revisits every 4th column, floors every 4th row and 8th
    column (tools/make_rim.py's edges, in its order)."""
    n = F * Rw * C
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    # Same-floor revisits: adjacent sweep rows pass the same x position.
    ff, rr, cc = (a.ravel() for a in np.meshgrid(
        np.arange(F), np.arange(Rw - 1), np.arange(0, C, 4), indexing="ij"))
    xx = np.where(rr % 2 == 0, cc, C - 1 - cc)
    c2 = np.where((rr + 1) % 2 == 0, xx, C - 1 - xx)
    revisit = np.stack([pid(ff, rr, cc), pid(ff, rr + 1, c2)], axis=1)
    # Inter-floor closures at vertically aligned positions.
    ff, rr, cc = (a.ravel() for a in np.meshgrid(
        np.arange(F - 1), np.arange(0, Rw, 4), np.arange(0, C, 8),
        indexing="ij"))
    floor = np.stack([pid(ff, rr, cc), pid(ff + 1, rr, cc)], axis=1)
    cand = np.concatenate([revisit, floor])
    # Closures that repeat a chain edge, or join a pose to itself, drop.
    cand = cand[np.abs(cand[:, 0] - cand[:, 1]) > 1]
    cand = np.sort(cand, axis=1)
    # Duplicates keep their first occurrence, in order.
    _, first = np.unique(cand, axis=0, return_index=True)
    return np.concatenate([chain, cand[np.sort(first)]])


def _counted_edges(F, Rw, C, pid, n, m, rng):
    """The chain of the first n poses and m - (n - 1) closures drawn from
    the seed among every revisit (same x or one column off, adjacent sweep
    rows) and every aligned pair of adjacent floors, in pose order."""
    ff, rr, cc = (a.ravel() for a in np.meshgrid(
        np.arange(F), np.arange(Rw - 1), np.arange(C), indexing="ij"))
    xx = np.where(rr % 2 == 0, cc, C - 1 - cc)
    pairs = []
    for dx in (0, -1, 1):
        x2 = xx + dx
        ok = (x2 >= 0) & (x2 < C)
        c2 = np.where((rr + 1) % 2 == 0, x2, C - 1 - x2)
        pairs.append(np.stack([pid(ff, rr, cc), pid(ff, rr + 1, c2)],
                              axis=1)[ok])
    ff, rr, cc = (a.ravel() for a in np.meshgrid(
        np.arange(F - 1), np.arange(Rw), np.arange(C), indexing="ij"))
    pairs.append(np.stack([pid(ff, rr, cc), pid(ff + 1, rr, cc)], axis=1))
    cand = np.sort(np.concatenate(pairs), axis=1)
    cand = cand[(cand[:, 1] < n) & (cand[:, 1] - cand[:, 0] > 1)]
    cand = np.unique(cand, axis=0)
    k = m - (n - 1)
    if not 0 <= k <= len(cand):
        raise ValueError(f"{m} edges on {n} poses: {len(cand)} closures "
                         "to draw from")
    closures = cand[np.sort(rng.choice(len(cand), k, replace=False))]
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return np.concatenate([chain, closures])
