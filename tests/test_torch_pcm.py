"""PCM outlier rejection (pcm.py) and the native host library (io/native.py)
in the port against the JAX package, on the CPU (f64).

Every parity case names the clique route it runs (the native C++ solver or
the Python one) and checks that both packages took it: the JAX package's
`native_available()` and the port's `CliqueRoutes` record.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIM = os.path.join(REPO, "artifacts", "rim_synth.g2o")
GRID3D = os.path.join(REPO, "artifacts", "grid3D_synth.g2o")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native loader, pointed at the library the port's
    loader built from the same sources (native/*.cpp), so that a `make` in
    native/ by another test process cannot hand it a half-written file."""
    from dpgo_tpu.io import native as jn

    from dpgo_tpu_torch.io import native as tn

    assert tn.native_available(), tn._Loaded.failed
    monkeypatch.setattr(jn, "_LIB_PATH", tn.LIB_PATH)
    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_build_failed", False)
    return jn


def _jax_meas(meas):
    from dpgo_tpu.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _random_rotations(rng, m, d):
    U, _, Vt = np.linalg.svd(rng.normal(size=(m, d, d)))
    R = U @ Vt
    R[np.linalg.det(R) < 0, :, 0] *= -1
    return R


def _oriented_set(rng, m, d):
    return (_random_rotations(rng, m, d), rng.normal(size=(m, d)),
            rng.uniform(0.5, 2.0, m), rng.uniform(0.5, 2.0, m),
            rng.normal(size=(m, d)), _random_rotations(rng, m, d),
            rng.normal(size=(m, d)), _random_rotations(rng, m, d))


@pytest.mark.parametrize("d", [3, 2])
def test_loop_errors_match_jax(d):
    """loop_errors on two random oriented sets (7 x 5 measurements, random
    information) against the JAX package, rtol 1e-12; the cross matrix is
    not symmetric in p and q (the translation part closes the loop from
    different frames)."""
    from dpgo_tpu.pcm import loop_errors as jax_loop_errors

    from dpgo_tpu_torch.pcm import loop_errors

    rng = np.random.default_rng(d)
    P, Q = _oriented_set(rng, 7, d), _oriented_set(rng, 5, d)
    want = np.asarray(jax_loop_errors(P, Q))
    got = loop_errors(tuple(torch.as_tensor(x) for x in P),
                      tuple(torch.as_tensor(x) for x in Q))
    assert got.dtype == torch.float64 and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    PP = tuple(torch.as_tensor(x) for x in P)
    E = loop_errors(PP, PP).numpy()
    assert np.abs(E - E.T).max() > 1e-3


@functools.lru_cache(maxsize=None)
def _noisy_graph():
    """60 poses, 3 nodes, every fourth inter-node edge moved by 10 m, and a
    noisy estimate (rotations perturbed by ~0.05, translations by 0.05 m):
    the batch and incremental filters keep different edges on it."""
    from dpgo_tpu.graph import make_partition

    rng = np.random.default_rng(5)
    meas, t, R = random_pose_graph(rng, num_poses=60, d=3, loop_closures=60,
                                   noise=0.01)
    part = make_partition(meas.num_poses, 3)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    bad = inter[::4]
    meas.t[bad] += 10.0
    U, _, Vt = np.linalg.svd(R + 0.05 * rng.normal(size=R.shape))
    Rn = U @ Vt
    Rn[np.linalg.det(Rn) < 0] *= -1
    return meas, t + 0.05 * rng.normal(size=t.shape), Rn, inter, bad


def _route_options(route):
    from dpgo_tpu.pcm import PCMOptions as JOpts

    from dpgo_tpu_torch.pcm import PCMOptions

    native = route == "native"
    return (JOpts(tolerance=1.0, native=native),
            PCMOptions(tolerance=1.0, native=native))


def _check_route(route, jn, pairs):
    from dpgo_tpu_torch.pcm import CliqueRoutes

    counts = CliqueRoutes.counts
    if route == "native":
        assert jn.native_available()
        assert counts == {"native": pairs, "python": 0, "heuristic": 0}
    else:
        assert counts == {"native": 0, "python": pairs, "heuristic": 0}


@pytest.mark.parametrize("batch", [None, 1, 3])
@pytest.mark.parametrize("route", ["native", "python"])
def test_pcm_filters_match_jax_on_noisy_estimate(jax_native, route, batch):
    """pcm_filter (batch None) and pcm_filter_incremental (batch 1, 3) on a
    corrupted 3-node graph scored on a noisy estimate at tolerance 1.0:
    the same keep mask as the JAX package's counterpart, through the same
    clique route (3 node pairs, one clique solve each); every corrupted edge
    is dropped. On this estimate the incremental filter keeps different
    edges than the batch filter (in both packages)."""
    from dpgo_tpu import pcm as jp

    from dpgo_tpu_torch import pcm as tp

    meas, t, R, inter, bad = _noisy_graph()
    jo, to = _route_options(route)
    tp.CliqueRoutes.reset()
    if batch is None:
        _, kj = jp.pcm_filter(_jax_meas(meas), 3, t, R, jo)
        filtered, kt = tp.pcm_filter(_torch_meas(meas), 3, t, R, to,
                                     device="cpu")
    else:
        _, kj = jp.pcm_filter_incremental(_jax_meas(meas), 3, t, R, jo,
                                          batch=batch)
        filtered, kt = tp.pcm_filter_incremental(
            _torch_meas(meas), 3, t, R, to, batch=batch, device="cpu")
    _check_route(route, jax_native, 3)
    np.testing.assert_array_equal(kt, kj)
    if batch is not None:
        _, k_batch = tp.pcm_filter(_torch_meas(meas), 3, t, R, to,
                                   device="cpu")
        assert (k_batch != kt).any()
    assert len(filtered) == int(kt.sum()) < len(meas)
    assert not kt[bad].any() and kt[np.setdiff1d(inter, bad)].any()


@functools.lru_cache(maxsize=None)
def _rim_outliers():
    """rim_synth with every tenth inter-node edge (16 nodes) an outlier, as
    chip_smoke.py's pcm_rim path builds it, and its centralized chordal
    estimate (the start the CLI scores PCM on)."""
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.synthetic import with_outliers

    meas, bad = with_outliers(read_g2o_file(RIM),
                              np.random.default_rng(0), 16)
    R = chordal_initialization(meas)
    return meas, bad, recover_translations_global(meas, R), R


@pytest.mark.parametrize("tol", [0.2, 3.0])
@pytest.mark.parametrize("pipeline", ["batch", "incremental"])
def test_rim_outliers_match_jax(jax_native, tol, pipeline):
    """The 53-outlier rim graph at tolerance 0.2 (the CLI default) and 3.0,
    scored on its chordal estimate: pcm_filter and
    pcm_filter_incremental(batch=5) each give the keep mask of their JAX
    counterpart (native cliques, 29 node pairs). Observed: at 3.0 the batch
    filter keeps 0 of the 53 outliers and drops 143 of the 474 inlier
    inter-node edges."""
    from dpgo_tpu import pcm as jp
    from dpgo_tpu.graph import make_partition

    from dpgo_tpu_torch import pcm as tp

    meas, bad, t, R = _rim_outliers()
    jo, to = jp.PCMOptions(tolerance=tol), tp.PCMOptions(tolerance=tol)
    tp.CliqueRoutes.reset()
    if pipeline == "batch":
        _, kj = jp.pcm_filter(_jax_meas(meas), 16, t, R, jo)
        _, kt = tp.pcm_filter(meas, 16, t, R, to, device="cpu")
    else:
        _, kj = jp.pcm_filter_incremental(_jax_meas(meas), 16, t, R, jo,
                                          batch=5)
        _, kt = tp.pcm_filter_incremental(meas, 16, t, R, to, batch=5,
                                          device="cpu")
    _check_route("native", jax_native, 29)
    np.testing.assert_array_equal(kt, kj)
    if pipeline == "batch" and tol == 3.0:
        part = make_partition(meas.num_poses, 16)
        inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
        assert len(bad) == 53 and not kt[bad].any()
        assert int((~kt[np.setdiff1d(inter, bad)]).sum()) == 143


def test_rim_loop_errors_are_asymmetric_as_in_jax():
    """The reference-side behaviour the port reproduces: on the rim outlier
    graph's chordal estimate, err[p, q] and err[q, p] of one node pair
    differ by up to 83.6 in both packages (same value to 1e-9), and the
    batch adjacency (err <= 0.2, kept asymmetric) differs from the
    incremental one (the cross block mirrored) in 12 of the 29 pairs."""
    from dpgo_tpu import pcm as jp

    from dpgo_tpu_torch import pcm as tp

    meas, _, t, R = _rim_outliers()
    worst = {"jax": 0.0, "torch": 0.0}
    differ = 0
    for es, Rm, tm, gi, gj in tp._oriented_pairs(meas, 16):
        ones = np.ones(len(es))
        A = (Rm, tm, ones, ones, t[gi], R[gi], t[gj], R[gj])
        E = tp.loop_errors(tuple(torch.as_tensor(x) for x in A),
                           tuple(torch.as_tensor(x) for x in A)).numpy()
        Ej = np.asarray(jp.loop_errors(A, A))
        worst["torch"] = max(worst["torch"], np.abs(E - E.T).max())
        worst["jax"] = max(worst["jax"], np.abs(Ej - Ej.T).max())
        solver = tp.PCMSolver(tp.PCMOptions(), device="cpu")
        for pos in range(0, len(es), 5):
            solver.update(*(x[pos:pos + 5] for x in A))
        adj = E <= 0.2
        np.fill_diagonal(adj, False)
        differ += bool((solver.adj != adj).any())
    np.testing.assert_allclose(worst["torch"], worst["jax"], rtol=1e-9)
    assert 83.5 < worst["torch"] < 83.7
    assert differ == 12


@pytest.mark.parametrize("n,density", [(12, 0.4), (30, 0.5), (40, 0.6)])
def test_native_clique_matches_python_on_symmetric_graphs(n, density):
    """On symmetric random graphs the native exact clique has the size of
    the Python exact one and is a clique; the native and Python heuristics
    return cliques no larger."""
    from dpgo_tpu_torch.io.native import max_clique_native
    from dpgo_tpu_torch.pcm import max_clique_exact, max_clique_heuristic

    rng = np.random.default_rng(n)
    for _ in range(3):
        adj = rng.random((n, n)) < density
        adj = adj | adj.T
        np.fill_diagonal(adj, False)
        exact = max_clique_exact(adj)
        native = max_clique_native(adj, exact=True)
        assert native.sum() == exact.sum()
        for mask in (native, max_clique_native(adj, exact=False),
                     max_clique_heuristic(adj)):
            idx = np.nonzero(mask)[0]
            assert all(adj[a, b] for a in idx for b in idx if a != b)
            assert mask.sum() <= exact.sum()


def test_read_g2o_native_matches_python_and_jax(jax_native):
    """read_g2o_file_native on grid3D_synth: the port's native reader gives
    the JAX package's native measurements exactly and the Python reader's
    within rtol 1e-12 (the two parsers round the quaternion conversion
    differently, 5e-13); the port's library lies in its own build
    directory."""
    from dpgo_tpu.io.native import read_g2o_file_native as jax_read

    from dpgo_tpu_torch.io import native
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops._build import BUILD_DIR

    assert os.path.dirname(native.LIB_PATH) == BUILD_DIR
    assert jax_native.native_available()
    got = native.read_g2o_file_native(GRID3D)
    for other, rtol in ((jax_read(GRID3D), 0), (read_g2o_file(GRID3D),
                                                1e-12)):
        assert (got.num_poses, got.d) == (other.num_poses, other.d)
        for f in ("i", "j", "R", "t", "kappa", "tau"):
            np.testing.assert_allclose(getattr(got, f), getattr(other, f),
                                       rtol=rtol, atol=rtol, err_msg=f)
