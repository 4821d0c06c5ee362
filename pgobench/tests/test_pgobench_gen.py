"""The graph generators: the frozen rim family against the repository's
artifact and its published shapes, the Manhattan copy against the port's."""

import os

import numpy as np
import pytest

from pgobench.gen import manhattan, rim
from pgobench.tests.conftest import ROOT


def read_rim_artifact(path):
    """(i, j, t, R) of an EDGE_SE3:QUAT file (plain parse)."""
    rows = np.loadtxt(path, usecols=range(1, 10))
    i, j = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    x, y, z, w = (rows[:, 5 + k] for k in range(4))
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    return i, j, rows[:, 2:5], R


def test_seed_1_reproduces_rim_synth():
    g = rim.graph(1, floors=10, rows=16, cols=64, rot_noise=0.05,
                  trans_noise=0.1)
    i, j, t, R = read_rim_artifact(
        os.path.join(ROOT, "artifacts", "rim_synth.g2o"))
    np.testing.assert_array_equal(g["i"], i)
    np.testing.assert_array_equal(g["j"], j)
    # The file prints translations to 6 decimals, quaternions to 7.
    assert np.abs(g["t"] - t).max() <= 5.0001e-7
    assert np.abs(g["R"] - R).max() <= 5e-7
    assert np.allclose(g["tau"], 100.0) and np.allclose(g["kappa"], 200.0)


@pytest.mark.parametrize("kw,poses,edges", [
    (dict(floors=10, rows=16, cols=64), 10_240, 12_927),
    (dict(floors=50, rows=32, cols=64), 102_400, 130_335),
    # rim.g2o's counts, as the configuration rim3d_10k_16n draws them.
    (dict(floors=10, rows=16, cols=64, num_poses=10_195, num_edges=29_743),
     10_195, 29_743),
])
def test_rim_shapes(kw, poses, edges):
    g = rim.graph(987654321987, rot_noise=0.05, trans_noise=0.1, **kw)
    assert g["num_poses"] == poses and len(g["i"]) == edges
    assert g["R"].shape == (edges, 3, 3) and g["t"].shape == (edges, 3)
    assert g["R_true"].shape == (poses, 3, 3)
    assert g["t_true"].shape == (poses, 3)
    assert np.all(g["i"] < g["j"]) and g["j"].max() == poses - 1
    # A simple graph: no edge twice.
    assert len(np.unique(np.stack([g["i"], g["j"]], 1), axis=0)) == edges
    RtR = np.swapaxes(g["R"], 1, 2) @ g["R"]
    assert np.abs(RtR - np.eye(3)).max() < 1e-12


def test_configuration_holds_its_stated_counts():
    from pgobench import manifest
    bench = manifest.benchmark()
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        g = manifest.generator(cfg["generator"]).graph(**cfg["graph"])
        assert (g["num_poses"], len(g["i"])) == (cfg["num_poses"],
                                                  cfg["num_edges"])


def test_too_many_edges_are_refused():
    with pytest.raises(ValueError):
        rim.graph(1, floors=1, rows=2, cols=4, rot_noise=0.05,
                  trans_noise=0.1, num_poses=8, num_edges=40)


def test_same_seed_same_graph():
    kw = dict(floors=2, rows=4, cols=16, rot_noise=0.05, trans_noise=0.1)
    a, b = rim.graph(2 ** 31 + 5, **kw), rim.graph(2 ** 31 + 5, **kw)
    c = rim.graph(2 ** 31 + 6, **kw)
    np.testing.assert_array_equal(a["t"], b["t"])
    assert not np.array_equal(a["t"], c["t"])


def test_manhattan_equals_the_ports():
    from dpgo_tpu_torch.synthetic import manhattan_world
    g = manhattan.graph(5, num_poses=600, grid=12, closures=300)
    meas, t_true, R_true = manhattan_world(np.random.default_rng(5),
                                           num_poses=600, grid=12,
                                           closures=300)
    for k in ("i", "j", "R", "t", "kappa", "tau"):
        np.testing.assert_array_equal(g[k], getattr(meas, k))
    np.testing.assert_array_equal(g["t_true"], t_true)
    np.testing.assert_array_equal(g["R_true"], R_true)
