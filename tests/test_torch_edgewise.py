"""The edge-wise path (node blocks with n0 d above `dense_limit`, at most
`segment_limit` poses) in the port against the JAX package and against the
port's own dense path, on the CPU (f64).

The path is forced with `dense_limit=0` on the 120-pose graph of
tests/test_segment.py (d = 3, 2 nodes), as tests/test_solver.py::
test_edgewise_dense_path_parity forces it on CSAIL.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

EDGE = dict(dense_limit=0)
STEPS = 20
LOSS_REG = 0.25
# The dense images the edge-wise path must not build.
PLACEHOLDERS = ("mG00_d", "mG01_d", "mG11_d", "Hred_d", "precon_dense")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(outliers=False):
    rng = np.random.default_rng(0)
    meas, _, _ = random_pose_graph(rng, num_poses=120, d=3, loop_closures=60,
                                   noise=0.05)
    if outliers:
        from dpgo_tpu.graph import make_partition
        part = make_partition(meas.num_poses, 2)
        inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
        meas.t[inter[:2]] += 5.0
    return meas


def _arrays(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _state_arrays(st) -> dict:
    return {name: (_arrays(v) if dataclasses.is_dataclass(v)
                   else np.asarray(v))
            for name, v in st._asdict().items()}


@functools.lru_cache(maxsize=None)
def _jax_problems(loss="trivial"):
    from dpgo_tpu.graph import build_multigraph
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.problem import build_node_problems
    _, _, mg = build_multigraph(_graph(), 2)
    return mg, build_node_problems(mg, xi=1e-11, loss=Loss(loss),
                                   loss_reg=LOSS_REG, **EDGE)


def test_edgewise_build_matches_jax():
    """Minv_red, null_V, SU, ipose and precon_inv (Gershgorin lambda_max, no
    Lanczos) against the JAX build, rtol 1e-10; the dense images are
    [N, 1, 1] placeholders, the segment fields [N, 1, ...] ones."""
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.problem import build_node_problems

    _, jp = _jax_problems()
    _, _, mg = build_multigraph(_torch_meas(_graph()), 2)
    tp = build_node_problems(mg, xi=1e-11, device="cpu", **EDGE)
    assert not tp.dense and not tp.seg
    for name in ("Minv_red", "SU", "precon_inv", "diagT_inv", "nvec", "W"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)
    # The null basis is an eigenvector block: compare its projector.
    tV, jV = tp.null_V.numpy(), np.asarray(jp.null_V)
    np.testing.assert_allclose(tV @ tV.transpose(0, 2, 1),
                               jV @ jV.transpose(0, 2, 1), atol=1e-10)
    np.testing.assert_array_equal(tp.ipose.numpy(), np.asarray(jp.ipose))
    N = tp.num_nodes
    for name in PLACEHOLDERS:
        assert tuple(getattr(tp, name).shape) == (N, 1, 1), name
    assert tuple(tp.seg_R_inv.shape) == (N, 1, 1, 1)
    # The dense build's block-Jacobi blocks take lambda_max from Lanczos on
    # mG11, below the Gershgorin bound: the two regimes' blocks differ.
    dense = build_node_problems(mg, xi=1e-11, device="cpu")
    assert dense.dense
    assert float((dense.precon_inv - tp.precon_inv).abs().max()) > 1e-9


def test_convert_edgewise_problem_and_operators(rng):
    """convert.py on the JAX edge-wise problem and an MM state of the JAX
    edge-wise solver: evaluate_G (the edge-wise 1/2 <G X, X> + <g, X> + f),
    euclidean_Df, solve_mG00, reduced_hessian_vp and precondition on the
    converted state against the JAX package, rtol 1e-10 of the largest
    entry; and the dense-image methods refuse."""
    from dpgo_tpu.manifold import proj_tangent

    from dpgo_tpu_torch.convert import problem_from_numpy, state_from_numpy
    from dpgo_tpu_torch.problem import NodeState

    js, jst, _, _ = _jax_run("prox")
    jp = js.probs
    tp = problem_from_numpy(_arrays(jp), device="cpu")
    ts = state_from_numpy(_state_arrays(jst), device="cpu")
    assert not tp.dense and not tp.seg
    for name in PLACEHOLDERS:
        assert tuple(getattr(tp, name).shape) == (2, 1, 1), name
    xt = torch.tensor(rng.normal(size=tuple(ts.Z.t.shape)))
    xR = torch.tensor(rng.normal(size=tuple(ts.Z.R.shape)))
    jxt, jxR = jnp.asarray(xt.numpy()), jnp.asarray(xR.numpy())

    def close(ours, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-10 * max(np.abs(ref).max(), 1.0))

    close(tp.evaluate_G(xt, xR, (ts.g_t, ts.g_R), ts.f),
          jax.vmap(lambda p, a, b, gt, gr, f: p.evaluate_G(a, b, (gt, gr), f))(
              jp, jxt, jxR, jst.g_t, jst.g_R, jst.f))
    Df = tp.euclidean_Df(NodeState(t=xt, R=xR, th=ts.Z.th, Rh=ts.Z.Rh),
                         (ts.g_t, ts.g_R))
    jZ = dataclasses.replace(jst.Z, t=jxt, R=jxR)
    jDf = jax.vmap(lambda p, z, gt, gr: p.euclidean_Df(z, g=(gt, gr)))(
        jp, jZ, jst.g_t, jst.g_R)
    close(Df[0], jDf[0])
    close(Df[1], jDf[1])
    close(tp.solve_mG00(xt, ts.Z.t),
          jax.vmap(lambda p, r, a: p.solve_mG00(r, a))(jp, jxt, jst.Z.t))
    nab = tp.reduced_euclidean_grad(ts.Z.t, ts.Z.R, ts.g_R)
    jnab = jax.vmap(lambda p, a, b, c: p.reduced_euclidean_grad(a, b, c))(
        jp, jst.Z.t, jst.Z.R, jst.g_R)
    close(nab, jnab)
    Rdot = proj_tangent(jst.Z.R, jxR)
    close(tp.reduced_hessian_vp(ts.Z.R, nab, torch.tensor(np.asarray(Rdot))),
          jax.vmap(lambda p, r, n, x: p.reduced_hessian_vp(r, n, x))(
              jp, jst.Z.R, jnab, Rdot))
    close(tp.precondition(ts.Z.R, xR),
          jax.vmap(lambda p, r, x: p.precondition(r, x))(jp, jst.Z.R, jxR))
    with pytest.raises(ValueError, match="dense operator images"):
        tp.reduced_grad_tall(xt, tp.to_tall(xR), tp.to_tall(xR))


def test_with_weights_edgewise_matches_jax():
    """with_weights off the dense path (Huber, random weights in [0.05, 1])
    against dpgo_tpu.problem.with_weights: the proximal constants and the
    Woodbury core within rtol 1e-10, no operator image rebuilt (the
    placeholders stay), and the reweighted translation solve alike."""
    from dpgo_tpu.problem import with_weights as jax_with_weights

    from dpgo_tpu_torch.convert import problem_from_numpy
    from dpgo_tpu_torch.problem import with_weights

    mg, jp = _jax_problems("huber")
    rng = np.random.default_rng(3)
    w = np.where(mg.e_mask, rng.uniform(0.05, 1.0, size=mg.e_mask.shape),
                 1.0)
    jw = jax.vmap(jax_with_weights)(jp, jnp.asarray(w))
    tw = with_weights(problem_from_numpy(_arrays(jp), device="cpu"),
                      torch.tensor(w))
    assert tw.dynamic and not tw.dense
    for name in ("wood_C", "diagT_inv", "nvec", "W"):
        ref = np.asarray(getattr(jw, name))
        np.testing.assert_allclose(getattr(tw, name).numpy(), ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)
    for name in PLACEHOLDERS:
        assert tuple(getattr(tw, name).shape) == (2, 1, 1), name
    rhs = rng.normal(size=(2, mg.n0_max, 3))
    anchor = rng.normal(size=(2, mg.n0_max, 3))
    ref = np.asarray(jax.vmap(lambda p, r, a: p.solve_mG00(r, a))(
        jw, jnp.asarray(rhs), jnp.asarray(anchor)))
    out = tw.solve_mG00(torch.tensor(rhs), torch.tensor(anchor))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


# ------------------------------------------------------------ the slice

# name -> (outliers, loss, options kw, TNT kw, rtol of 2f, rtol of 2|grad|)
CASES = {
    "prox": (False, "trivial", {}, dict(max_iterations=0), 1e-9, 1e-9),
    "refined_jacobi": (False, "trivial", {}, {}, 1e-9, 1e-8),
    "huber_dynamic": (True, "huber", dict(rescale="dynamic"), {}, 1e-9,
                      1e-9),
}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.solvers.tnt import TNTParams

    outliers, loss, okw, tkw, _, _ = CASES[case]
    s = DPGOSolver(_graph(outliers), num_nodes=2,
                   opts=MMOptions(accelerated=True, tnt=TNTParams(**tkw),
                                  **okw),
                   loss=Loss(loss), loss_reg=LOSS_REG, dtype=jnp.float64,
                   **EDGE)
    st, _, (f, g) = s.run_steps_history(s.initialize(),
                                        jnp.zeros((), jnp.int32), STEPS)
    return s, st, np.asarray(f), np.asarray(g)


def _port_solver(case, **kw):
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    outliers, loss, okw, tkw, _, _ = CASES[case]
    return DPGOSolver(_torch_meas(_graph(outliers)), num_nodes=2,
                      opts=MMOptions(accelerated=True, tnt=TNTParams(**tkw),
                                     **okw),
                      loss=Loss(loss), loss_reg=LOSS_REG, device="cpu", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_edgewise_solver_matches_jax_f64(case):
    """The port's DPGOSolver against the JAX one on the forced edge-wise
    path, initialize + 20 steps, per-step 2f and 2|grad| within rtol 1e-9
    (2|grad| of the refined trivial-loss case within 1e-8: its
    Jacobi-preconditioned STPCG runs ~19 iterations per call).

    Observed (2f / 2|grad|): prox 1.8e-14 / 3.5e-13, refined_jacobi
    3.2e-14 / 1.2e-9, huber_dynamic 2.6e-14 / 1.8e-11.

    The refined cases run `_make_tnt_model` with the block-Jacobi
    preconditioner (`resolve_preconditioner` gives "jacobi"); kernel K1's
    gate stays closed."""
    from dpgo_tpu_torch.solvers.mm import resolve_preconditioner

    _, _, _, tkw, rtol_f, rtol_g = CASES[case]
    _, jst, jf, jg = _jax_run(case)
    ts = _port_solver(case, **EDGE)
    assert not ts.probs.dense and not ts.probs.seg
    assert resolve_preconditioner(ts.probs, ts.opts) == "jacobi"
    assert not ts.fused_stpcg_engaged()
    tst, _, (tf, tg) = ts.run_steps_history(ts.initialize(), 0, STEPS)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=rtol_f)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=rtol_g)
    np.testing.assert_allclose(tst.Z.R.numpy(), np.asarray(jst.Z.R),
                               atol=1e-8)
    if tkw.get("max_iterations", 1) > 0:
        assert ts.syncs.loops["stpcg"][1] > 0  # the R-space TNT ran
    if case == "huber_dynamic":
        np.testing.assert_allclose(tst.scale_w.numpy(),
                                   np.asarray(jst.scale_w), rtol=1e-9)
        assert float(tst.scale_w.min()) < 1.0
    f_exact, _ = ts._metrics(tst)
    np.testing.assert_allclose(float(f_exact), float(tf[-1]), rtol=1e-9)


@pytest.mark.parametrize("case", ["prox", "huber_dynamic"])
def test_edgewise_matches_dense_path_proximal_only(case):
    """The port's edge-wise path against the port's dense path with the
    refinement off (the two paths refine with different preconditioners, so
    only the proximal / update math must agree): 15 steps, exact global 2f
    within rtol 1e-8 and 2|grad| within rtol 1e-5 (the tolerances of
    tests/test_solver.py::test_edgewise_dense_path_parity, which needs
    CSAIL.g2o), for the trivial loss and for Huber + dynamic rescale."""
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    out = []
    for kw in ({}, EDGE):
        s = _port_solver(case, **kw)
        s.opts = dataclasses.replace(s.opts,
                                     tnt=TNTParams(max_iterations=0))
        st, _ = s.run_steps(s.initialize(), 0, 15)
        out.append([float(x) for x in s._metrics(st)])
        assert s.probs.dense == (not kw)
    (fd, gd), (fe, ge) = out
    np.testing.assert_allclose(fe, fd, rtol=1e-8)
    np.testing.assert_allclose(ge, gd, rtol=1e-5, atol=1e-8)
    assert isinstance(s.opts, MMOptions)
