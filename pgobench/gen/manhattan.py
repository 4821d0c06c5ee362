"""The city10000 family: a 2-D Manhattan world (frozen copy of the port's
`synthetic.manhattan_world`, for a later 2-D cell).

A 1 m-step random walk on the integer grid of a grid x grid square that
goes straight with probability 0.8, otherwise turns +-90 degrees, and turns
back at the border; odometry between consecutive poses; loop closures from
pose i to the earlier poses j < i - 10 at the same grid point, each kept
with the probability that leaves about `closures` of them (city10000:
10,000 poses, 20,687 edges). Noise sigma_t per axis and sigma_theta, with
the matching precisions.
"""

from __future__ import annotations

import numpy as np


def graph(seed: int, num_poses: int = 10_000, grid: int = 50,
                    closures: int = 10_500, sigma_t: float = 0.05,
                    sigma_theta: float = 0.01) -> dict:
    """The graph as plain arrays, in the layout of `rim.graph`
    (d = 2)."""
    rng = np.random.default_rng(seed)
    steps = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])
    xy = np.zeros((num_poses, 2), np.int64)
    head = np.zeros(num_poses, np.int64)
    xy[0] = grid // 2
    u = rng.random(num_poses)
    for p in range(1, num_poses):
        h = head[p - 1]
        if u[p] >= 0.8:
            h = (h + (1 if u[p] < 0.9 else -1)) % 4
        nxt = xy[p - 1] + steps[h]
        if not ((nxt >= 0) & (nxt < grid)).all():
            h = (h + 2) % 4
            nxt = xy[p - 1] + steps[h]
        xy[p], head[p] = nxt, h
    visits: dict = {}
    cand = []
    for p in range(num_poses):
        seen = visits.setdefault((int(xy[p, 0]), int(xy[p, 1])), [])
        cand.extend((j, p) for j in seen if j < p - 10)
        seen.append(p)
    cand = np.array(cand, np.int64).reshape(-1, 2)
    keep = rng.random(len(cand)) < min(1.0, closures / max(len(cand), 1))
    ei = np.concatenate([np.arange(num_poses - 1), cand[keep, 0]])
    ej = np.concatenate([np.arange(1, num_poses), cand[keep, 1]])

    theta = head * (np.pi / 2)
    c, s = np.cos(theta), np.sin(theta)
    R_true = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    t_true = xy.astype(np.float64)
    m = len(ei)
    dth = theta[ej] - theta[ei] + rng.normal(size=m) * sigma_theta
    c, s = np.cos(dth), np.sin(dth)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    t = np.einsum("eba,eb->ea", R_true[ei], t_true[ej] - t_true[ei]) \
        + rng.normal(size=(m, 2)) * sigma_t
    return {"i": ei, "j": ej, "R": R, "t": t,
            "kappa": np.full(m, 1.0 / sigma_theta ** 2),
            "tau": np.full(m, 1.0 / sigma_t ** 2), "t_true": t_true,
            "R_true": R_true, "num_poses": num_poses, "d": 2}
