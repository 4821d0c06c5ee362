"""The split polish's pieces that need no process group: a pose axis split
into node ranges, simulated in one process (each share's halo rows read
from the global arrays), against the port's global oracles and against
the share that holds every pose. The process groups themselves run in
tests/test_torch_spmd.py."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

NUM_POSES, NUM_NODES = 67, 5  # uneven: nodes of 14 and 13 poses
LOSS_REG = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(d, loss):
    from dpgo_tpu_torch.graph import make_partition
    from dpgo_tpu_torch.io.g2o import Measurements
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.objective import EdgeData

    meas, _, _ = random_pose_graph(np.random.default_rng(5),
                                   num_poses=NUM_POSES, d=d,
                                   loop_closures=30)
    meas = Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})
    node_of = make_partition(NUM_POSES, NUM_NODES).node_of
    edges = EdgeData.from_measurements(meas, node_of=node_of, device="cpu")
    rng = np.random.default_rng(9)
    t = torch.as_tensor(3.0 * rng.normal(size=(NUM_POSES, d)))
    R = torch.as_tensor(np.linalg.qr(rng.normal(size=(NUM_POSES, d, d)))[0])
    vt = torch.as_tensor(rng.normal(size=(2, NUM_POSES, d)))
    vR = torch.as_tensor(rng.normal(size=(2, NUM_POSES, d, d)))
    return meas, node_of, edges, (t, R, vt, vR), dict(loss=Loss(loss),
                                                      loss_reg=LOSS_REG)


def _shares(edges, node_of, meas, parts):
    """One SplitEdges per node range of `parts` equal ranges, each with its
    halo: the other ranges' poses its edges read, by global id."""
    from dpgo_tpu_torch.objective import SplitEdges

    bounds = np.linspace(0, NUM_NODES, parts + 1).astype(int)
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        own = (node_of >= a) & (node_of < b)
        touch = own[meas.i] | own[meas.j]
        ends = np.concatenate([meas.i[touch], meas.j[touch]])
        halo = np.unique(ends[~own[ends]])
        out.append((SplitEdges.build(edges, node_of, a, b, halo), halo,
                    np.flatnonzero(own)))
    return out


def _ext(x, rows, halo):
    """Extended rows [own; halo] of a global array (pose axis -2 for t,
    -3 for R, after any batch axes)."""
    return torch.cat([x[..., rows, :], x[..., halo, :]], dim=-2)


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
@pytest.mark.parametrize("loss", ["trivial", "huber"])
@pytest.mark.parametrize("d", [2, 3])
def test_split_shares_match_global_oracles(d, loss, parts):
    """Split into `parts` node ranges: the objective's node partials of the
    shares add up, bit for bit, to those of the share holding every pose
    (each node's partial is made by one share), whose sum is evaluate_f
    (rtol 1e-12); each share's gradient and Hessian-vector rows (a batch
    of two directions) are its rows of the global ones; the per-pose
    inner products' node partials add up bit for bit likewise."""
    from dpgo_tpu_torch.objective import (evaluate_euclidean_grad,
                                          evaluate_f, split_euclidean_grad,
                                          split_f)
    from dpgo_tpu_torch.solvers.polish import (_pose_ip, euclidean_hess_vp,
                                               split_hess_vp)

    meas, node_of, edges, (t, R, vt, vR), kw = _setup(d, loss)
    (whole, _, _), = _shares(edges, node_of, meas, 1)
    f_whole = split_f(whole, t, R, **kw)
    np.testing.assert_allclose(float(f_whole.sum()),
                               float(evaluate_f(edges, t, R, **kw)),
                               rtol=1e-12)
    gt, gR = evaluate_euclidean_grad(edges, t, R, **kw)
    ht, hR = euclidean_hess_vp(edges, t, R, vt, vR, **kw)
    ip_whole = whole.pose_partials(_pose_ip((vt, vR), (vt, vR)))
    f_sum = torch.zeros_like(f_whole)
    ip_sum = torch.zeros_like(ip_whole)
    for share, halo, rows in _shares(edges, node_of, meas, parts):
        assert share.num_own == len(rows) and share.num_halo == len(halo)
        te, Re = _ext(t, rows, halo), _ext(R.flatten(-2), rows, halo)
        Re = Re.unflatten(-1, (d, d))
        f_sum = f_sum + split_f(share, te, Re, **kw)
        g = split_euclidean_grad(share, te, Re, **kw)
        vte = _ext(vt, rows, halo)
        vRe = _ext(vR.flatten(-2), rows, halo).unflatten(-1, (d, d))
        h = split_hess_vp(share, te, Re, vte, vRe, **kw)
        for got, want in ((g[0], gt[rows]), (g[1], gR[rows]),
                          (h[0], ht[:, rows]), (h[1], hR[:, rows])):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-12)
        ip_sum = ip_sum + share.pose_partials(
            _pose_ip((vt[:, rows], vR[:, rows]), (vt[:, rows], vR[:, rows])))
    np.testing.assert_array_equal(f_sum.numpy(), f_whole.numpy())
    np.testing.assert_array_equal(ip_sum.numpy(), ip_whole.numpy())


def test_with_halo_packs_batched_rows():
    """polish.with_halo sends one [P_r, k] buffer per exchange, k holding
    every batch entry's (t, R) of a pose, and unpacks the [H, k] reply
    behind the own rows, batch axes kept."""
    from dpgo_tpu_torch.solvers.polish import with_halo

    rng = np.random.default_rng(2)
    t = torch.as_tensor(rng.normal(size=(2, 3, 7, 3)))
    R = torch.as_tensor(rng.normal(size=(2, 3, 7, 3, 3)))
    pick = torch.tensor([6, 0, 4])
    seen = []

    def exchange(rows):
        seen.append(tuple(rows.shape))
        return rows[pick]

    te, Re = with_halo(exchange, t, R)
    assert seen == [(7, 2 * 3 * 12)]
    assert torch.equal(te, torch.cat([t, t[..., pick, :]], dim=-2))
    assert torch.equal(Re, torch.cat([R, R[..., pick, :, :]], dim=-3))


def test_polish_stats_report_the_tnt_run():
    """DPGOSolver.polish_stats: outer and CG iterations equal the host-read
    STPCG loop's entries and trips, and the history holds one row per
    outer iteration."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.utils import HostSyncs

    meas, _, _, _, _ = _setup(3, "trivial")
    s = DPGOSolver(meas, NUM_NODES, device="cpu")
    st = s.initialize()
    s.syncs = HostSyncs()
    _, f2 = s.polish(st, outer=4, tcg=20, coarse=True,
                     coarse_segments=(7,))
    stats = s.polish_stats
    assert [stats["outer"], stats["cg_iterations"]] == s.syncs.loops["stpcg"]
    h = stats["history"]
    assert all(len(v) == stats["outer"] for v in h.values())
    assert int(h["inner_iterations"].sum()) == stats["cg_iterations"]
    assert np.isfinite(f2) and 2.0 * h["fx"][0] > f2
