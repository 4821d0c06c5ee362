"""The port's front door (cli.py) and its helpers (checkpoint.py, config.py,
metrics.py) against the JAX package, on the CPU (f64)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@pytest.fixture(scope="module")
def g2o(tmp_path_factory):
    """A 30-pose SE(3) graph written as g2o text."""
    from dpgo_tpu_torch.io.g2o import write_g2o_file

    meas, t, R = random_pose_graph(np.random.default_rng(7), num_poses=30,
                                   d=3, loop_closures=15, noise=0.05)
    path = str(tmp_path_factory.mktemp("graph") / "graph.g2o")
    write_g2o_file(path, t, R, _torch_meas(meas))
    return path


def _rows(path):
    return np.loadtxt(path, ndmin=2)


@pytest.mark.parametrize("accelerated", ["true", "false"])
@pytest.mark.parametrize("solver", ["hash", "star"])
def test_cli_matches_jax_cli(g2o, tmp_path, monkeypatch, solver,
                             accelerated):
    """The port's cli.main and the JAX package's on one .g2o file (f64,
    centralized chordal start, 10 iterations recorded every 5): the same
    results_chordal_<N>_<amm|mm>.txt rows (iteration column equal, 2f and
    2|grad| within rtol 1e-9) and the same gauge-normalized estimates
    (atol 1e-8)."""
    from dpgo_tpu.cli import main as jax_main

    from dpgo_tpu_torch.cli import main

    args = ["--dataset", g2o, "--num_nodes", "2", "--iters", "10",
            "--record_every", "5", "--dist_init", "false", "--solver",
            solver, "--accelerated", accelerated]
    name = f"results_chordal_2_{'amm' if accelerated == 'true' else 'mm'}.txt"
    out = {}
    for pkg, fn in (("jax", jax_main), ("torch", main)):
        wd = tmp_path / pkg
        wd.mkdir()
        monkeypatch.chdir(wd)
        fn(args + (["--device", "cpu"] if pkg == "torch" else []))
        out[pkg] = (_rows(wd / name), _rows(wd / "estimates_trivial.txt"))
    (jr, je), (tr, te) = out["jax"], out["torch"]
    assert tr.shape == jr.shape == (3, 4)
    np.testing.assert_array_equal(tr[:, 0], [0, 5, 10])
    np.testing.assert_allclose(tr[:, 2:], jr[:, 2:], rtol=1e-9)
    assert te.shape == je.shape == (30 * 4, 3)
    np.testing.assert_allclose(te, je, atol=1e-8)


@pytest.fixture(scope="module")
def g2o_outliers(tmp_path_factory):
    """A 40-pose SE(3) graph with three of its inter-node edges (2 nodes)
    moved by 10 m, written as g2o text."""
    from dpgo_tpu_torch.graph import make_partition
    from dpgo_tpu_torch.io.g2o import write_g2o_file

    meas, t, R = random_pose_graph(np.random.default_rng(3), num_poses=40,
                                   d=3, loop_closures=30, noise=0.02)
    part = make_partition(meas.num_poses, 2)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    meas.t[inter[::4][:3]] += 10.0
    path = str(tmp_path_factory.mktemp("outliers") / "outliers.g2o")
    write_g2o_file(path, t, R, _torch_meas(meas))
    return path


@pytest.mark.parametrize("flag", [["--pcm"], ["--pcm", "--pcm_stream", "4"]])
def test_cli_refuses_flags_not_ported(g2o_outliers, tmp_path, monkeypatch,
                                      capsys, flag):
    """The PCM flags, refused before they were ported, now run as in the
    JAX package's CLI: on a graph with three corrupted inter-node edges,
    one-shot PCM (--pcm) and the incremental pipeline in batches of 4
    (--pcm_stream 4) at tolerance 1.0 on the chordal start print the same
    "PCM kept X/Y edges" line (some edges dropped), and the solve of the
    filtered graph (f64, 10 iterations recorded every 5) gives the same
    result rows (2f and 2|grad| within rtol 1e-9) and estimates (atol
    1e-9)."""
    from dpgo_tpu.cli import main as jax_main

    from dpgo_tpu_torch.cli import main

    args = ["--dataset", g2o_outliers, "--num_nodes", "2", "--iters", "10",
            "--record_every", "5", "--dist_init", "false",
            "--pcm_tolerance", "1.0"] + flag
    out = {}
    for pkg, fn in (("jax", jax_main), ("torch", main)):
        wd = tmp_path / pkg
        wd.mkdir()
        monkeypatch.chdir(wd)
        fn(args + (["--device", "cpu"] if pkg == "torch" else []))
        kept = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("PCM kept")]
        out[pkg] = (kept, _rows(wd / "results_chordal_2_amm.txt"),
                    _rows(wd / "estimates_trivial.txt"))
    (jk, jr, je), (tk, tr, te) = out["jax"], out["torch"]
    assert len(tk) == 1 and tk == jk
    kept, total = map(int, tk[0].split()[2].split("/"))
    assert kept < total
    assert tr.shape == jr.shape == (3, 4)
    np.testing.assert_allclose(tr[:, 2:], jr[:, 2:], rtol=1e-9)
    assert te.shape == je.shape == (40 * 4, 3)
    np.testing.assert_allclose(te, je, atol=1e-9)


def _certification(out):
    """(verdict, lambda_min, bound) of the CLI's certification line."""
    line = next(ln for ln in out.splitlines()
                if ln.startswith("certification:"))
    verdict = "GLOBAL OPT" if "GLOBAL OPT" in line else "uncertified"
    nums = dict(kv.split("=") for kv in line.split() if "=" in kv)
    return verdict, float(nums["lambda_min"]), float(
        nums["suboptimality_bound"])


@pytest.fixture(scope="module")
def chain_runs(g2o, tmp_path_factory):
    """Both packages' cli.main with --polish 3 --lm_polish --certify after 10
    iterations (f64, centralized chordal start; the polish's CG capped at 12
    iterations, where the two packages' CG still agree to rounding, see
    tests/test_torch_polish.py): {package: (result rows, estimates, standard
    output)}."""
    import contextlib
    import io

    from dpgo_tpu.cli import main as jax_main

    from dpgo_tpu_torch.cli import main

    args = ["--dataset", g2o, "--num_nodes", "2", "--iters", "10",
            "--record_every", "5", "--dist_init", "false", "--polish", "3",
            "--polish_tcg", "12", "--lm_polish", "--certify"]
    out = {}
    here = os.getcwd()
    for pkg, fn in (("jax", jax_main), ("torch", main)):
        wd = tmp_path_factory.mktemp(pkg)
        buf = io.StringIO()
        try:
            os.chdir(wd)
            with contextlib.redirect_stdout(buf):
                fn(args + (["--device", "cpu"] if pkg == "torch" else []))
        finally:
            os.chdir(here)
        out[pkg] = (_rows(wd / "results_chordal_2_amm.txt"),
                    _rows(wd / "estimates_trivial.txt"), buf.getvalue())
    return out


@pytest.mark.parametrize("flag", ["--polish", "--lm_polish", "--certify"])
def test_cli_polish_and_certify_match_jax_cli(chain_runs, flag):
    """--polish, --lm_polish and --certify, run in that order after the MM
    iterations by the port's CLI and the JAX package's: the same result rows
    (iterations 0, 5, 10, then the polish row and the LM row; 2f within
    rtol 1e-9; 2|grad| within rtol 1e-9, on the LM row both below 1e-8, the
    rounding floor at the optimum LM reaches from either start) and
    estimates (atol 1e-8); per flag: its row lowers 2f (LM: not above the
    polish), and the certification lines give the same verdict (GLOBAL
    OPT), lambda_min and bound within 1e-6 of the JAX CLI's."""
    (jr, je, jout), (tr, te, tout) = chain_runs["jax"], chain_runs["torch"]
    assert tr.shape == jr.shape == (5, 4)
    np.testing.assert_array_equal(tr[:, 0], [0, 5, 10, 10, 10])
    np.testing.assert_allclose(tr[:, 2], jr[:, 2], rtol=1e-9)
    np.testing.assert_allclose(tr[:4, 3], jr[:4, 3], rtol=1e-9)
    assert tr[4, 3] < 1e-8 and jr[4, 3] < 1e-8
    np.testing.assert_allclose(te, je, atol=1e-8)
    if flag == "--polish":
        assert "polish(3):" in tout and tr[3, 2] < tr[2, 2]
    elif flag == "--lm_polish":
        assert "lm_polish(" in tout and tr[4, 2] <= tr[3, 2] * (1 + 1e-12)
    else:
        jv, jl, jb = _certification(jout)
        tv, tl, tb = _certification(tout)
        assert tv == jv == "GLOBAL OPT"
        assert abs(tl - jl) <= 1e-6 and abs(tb - jb) <= 1e-6


def test_cli_lm_polish_refuses_robust_loss(g2o, tmp_path, monkeypatch):
    """--lm_polish with a robust loss exits non-zero before the solve (the
    host LM models the trivial loss only) and writes nothing."""
    from dpgo_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        main(["--dataset", g2o, "--num_nodes", "2", "--device", "cpu",
              "--lm_polish", "--loss", "huber"])
    assert "trivial loss" in str(exc.value.code)
    assert os.listdir(tmp_path) == []


def test_sesync_cli_matches_jax(g2o, capsys):
    """sesync_cli.main of both packages on one .g2o file: the same status
    line, SDP value and rounded value (printed to 12 digits)."""
    from dpgo_tpu.sesync_cli import main as jax_main

    from dpgo_tpu_torch.sesync_cli import main

    lines = {}
    for pkg, fn, extra in (("jax", jax_main, []),
                           ("torch", main, ["--device", "cpu"])):
        capsys.readouterr()
        fn(["--dataset", g2o] + extra)
        lines[pkg] = {ln.split(":")[0]: ln for ln in
                      capsys.readouterr().out.splitlines() if ":" in ln}
    j, t = lines["jax"], lines["torch"]
    assert t["status"].split("(")[0] == j["status"].split("(")[0]
    assert "GlobalOpt" in t["status"] and "rank 3" in t["status"]
    assert t["SDP value (2x)"] == j["SDP value (2x)"]
    assert t["rounded F (2x)"] == j["rounded F (2x)"]


@pytest.mark.parametrize("solver", ["hash", "star"])
def test_checkpoint_roundtrip_and_resume(solver, tmp_path):
    """tests/test_aux.py::test_checkpoint_roundtrip for both solver states
    (MMState, StarState; f32 with the local gauge on): every field restored
    exactly, the gauge centroids restored into a fresh solver, and the next
    step from the restored state equals the next step from the original."""
    from dpgo_tpu_torch.checkpoint import _flatten, load_state, save_state
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    meas, _, _ = random_pose_graph(np.random.default_rng(42), num_poses=24,
                                   d=2, loop_closures=10)
    cls = DPGOStarSolver if solver == "star" else DPGOSolver

    def make():
        return cls(_torch_meas(meas), num_nodes=2, opts=MMOptions(),
                   dtype=torch.float32, device="cpu")

    s = make()
    st, k = s.run_steps(s.initialize(), 0, 5)
    p = str(tmp_path / "ck.npz")
    save_state(p, st, k, gauge_c=s._c)
    s2 = make()
    st2, step = load_state(p, s2.initialize(), solver=s2)
    assert step == 5 and s2._c is not None
    np.testing.assert_array_equal(s2._c, s._c)
    a, b = _flatten(st), _flatten(st2)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    n1 = s._step(st, 5)
    n2 = s2._step(st2, 5)
    np.testing.assert_array_equal(n1.fobj.numpy(), n2.fobj.numpy())
    with pytest.raises(ValueError, match="shape"):
        load_state(p, cls(_torch_meas(meas), num_nodes=3, opts=MMOptions(),
                          dtype=torch.float32, device="cpu").initialize())


def test_cli_checkpoint_resume(g2o, tmp_path, monkeypatch, capsys):
    """The CLI writes a checkpoint every 5 iterations and a second run with
    more iterations resumes from it, ending where one uninterrupted run
    ends (2f within rtol 1e-12)."""
    from dpgo_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    base = ["--dataset", g2o, "--num_nodes", "2", "--dist_init", "false",
            "--device", "cpu", "--record_every", "5"]
    main(base + ["--iters", "10", "--checkpoint", "ck.npz",
                 "--checkpoint_every", "5"])
    main(base + ["--iters", "15", "--checkpoint", "ck.npz",
                 "--checkpoint_every", "5"])
    assert "resumed from ck.npz at iteration 10" in capsys.readouterr().out
    resumed = _rows(tmp_path / "results_chordal_2_amm.txt")
    np.testing.assert_array_equal(resumed[:, 0], [10, 15])
    main(base + ["--iters", "15"])
    straight = _rows(tmp_path / "results_chordal_2_amm.txt")
    np.testing.assert_allclose(resumed[-1, 2:], straight[-1, 2:],
                               rtol=1e-12)


def test_config_json_roundtrip(tmp_path):
    """save_config / load_config through JSON (tests/test_aux.py::
    test_config_roundtrip): options, nested TNT parameters and extras come
    back; flat TNT keys are taken too."""
    from dpgo_tpu_torch.config import load_config, save_config
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    opts = MMOptions(accelerated=False, eta0=1e-3, preconditioner="jacobi",
                     tnt=TNTParams(max_iterations=7))
    p = str(tmp_path / "conf.json")
    save_config(p, opts, dataset="foo.g2o", num_nodes=4)
    opts2, extras = load_config(p)
    assert opts2 == opts
    assert extras == {"dataset": "foo.g2o", "num_nodes": 4}
    p2 = str(tmp_path / "flat.json")
    with open(p2, "w") as fh:
        fh.write('{"accelerated": true, "kappa_fgr": 0.1, '
                 '"max_iterations": 5}')
    opts3, _ = load_config(p2)
    assert opts3.tnt.kappa_fgr == 0.1 and opts3.tnt.max_iterations == 5


def test_ate_and_rotation_errors_match_jax():
    """metrics.ate / rotation_errors (tests/test_aux.py::test_ate_alignment):
    zero after a random gauge transform, a matching scale after a
    perturbation, and equal to the JAX package's values."""
    from dpgo_tpu import metrics as jm

    from dpgo_tpu_torch.manifold import project_sod
    from dpgo_tpu_torch.metrics import ate, rotation_errors

    rng = np.random.default_rng(42)
    t = rng.normal(size=(50, 3)) * 3
    R = project_sod(torch.tensor(rng.normal(size=(50, 3, 3)))).numpy()
    G = project_sod(torch.tensor(rng.normal(size=(3, 3)))).numpy()
    t2 = t @ G.T + rng.normal(size=3)
    R2 = np.einsum("ab,nbc->nac", G, R)
    assert ate(t2, t) < 1e-10
    assert rotation_errors(R2, R, t2, t).max() < 1e-8
    t3 = t2 + rng.normal(size=t.shape) * 0.1
    assert 0.05 < ate(t3, t) < 0.2
    assert ate(t3, t) == jm.ate(t3, t)
    np.testing.assert_array_equal(rotation_errors(R2, R, t3, t),
                                  jm.rotation_errors(R2, R, t3, t))
