"""Synthetic pose graphs made from a seed: a 2-D Manhattan world of the
city10000 family, and outlier injection on the inter-node edges of a graph.
Host numpy; the graphs are `Measurements` as the g2o reader returns them.
"""

from __future__ import annotations

import copy

import numpy as np

from dpgo_tpu_torch.graph import make_partition
from dpgo_tpu_torch.io.g2o import Measurements


def random_rotations(rng: np.random.Generator, m: int) -> np.ndarray:
    """m Haar-uniform rotations [m, 3, 3] (QR of Gaussian matrices)."""
    G = rng.normal(size=(m, 3, 3))
    Qr, Rr = np.linalg.qr(G)
    Qr = Qr * np.sign(np.diagonal(Rr, axis1=1, axis2=2))[:, None, :]
    Qr[np.linalg.det(Qr) < 0, :, 0] *= -1
    return Qr


def manhattan_world(rng: np.random.Generator, num_poses: int = 10_000,
                    grid: int = 50, closures: int = 10_500,
                    sigma_t: float = 0.05, sigma_theta: float = 0.01):
    """A 2-D Manhattan-world pose graph of the city10000 family.

    A 1 m-step random walk on the integer grid of a grid x grid square that
    goes straight with probability 0.8, otherwise turns +-90 degrees, and
    turns back at the border; odometry between consecutive poses; loop
    closures from pose i to the earlier poses j < i - 10 at the same grid
    point, each kept with the probability that leaves about `closures` of
    them (city10000: 10,000 poses, 20,687 edges). Noise sigma_t per axis and
    sigma_theta, with the matching information. Returns (Measurements,
    t_true [P, 2], R_true [P, 2, 2])."""
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
    meas = Measurements(i=ei, j=ej, R=R, t=t,
                        kappa=np.full(m, 1.0 / sigma_theta ** 2),
                        tau=np.full(m, 1.0 / sigma_t ** 2),
                        num_poses=num_poses, d=2)
    return meas, t_true, R_true


def with_outliers(meas: Measurements, rng: np.random.Generator,
                  num_nodes: int, every: int = 10):
    """Replace every `every`-th inter-node edge (under make_partition) of a
    3-D graph by an outlier: a uniform random rotation and a translation
    uniform in [-10, 10]^3 m, keeping its information. Returns (meas,
    outlier edge indices)."""
    part = make_partition(meas.num_poses, num_nodes)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    bad = inter[::every]
    meas = copy.deepcopy(meas)
    meas.R[bad] = random_rotations(rng, len(bad))
    meas.t[bad] = rng.uniform(-10.0, 10.0, size=(len(bad), meas.d))
    return meas, bad
