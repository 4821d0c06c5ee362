"""MM-PGO, the R-space TNT model and the three STPCG preconditioners in the
port against the JAX package, on the CPU (f64)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

STEPS = 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(d):
    rng = np.random.default_rng(42)
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=d, loop_closures=30,
                                   noise=0.05)
    return meas


@functools.lru_cache(maxsize=None)
def _jax_mm(d):
    """The JAX MM-PGO solver (f64, 2 nodes): initialize, then STEPS steps
    with history."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    s = DPGOSolver(_graph(d), num_nodes=2, opts=MMOptions(accelerated=False),
                   dtype=jnp.float64)
    st, _, (f, g) = s.run_steps_history(s.initialize(),
                                        jnp.zeros((), jnp.int32), STEPS)
    return s, st, np.asarray(f), np.asarray(g)


@pytest.mark.parametrize("d", [3, 2])
def test_mm_matches_jax_f64(d):
    """MMOptions(accelerated=False): initialize + 20 steps, per-step 2f and
    2|grad| within rtol 1e-9, final Z within atol 1e-8; the 2f history is
    monotone (MM-PGO decreases in exact arithmetic: up to 1e-12 relative
    rounding) and the Nesterov bookkeeping stays at its initial values."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    js, jst, jf, jg = _jax_mm(d)
    ts = DPGOSolver(_torch_meas(_graph(d)), num_nodes=2,
                    opts=MMOptions(accelerated=False), device="cpu")
    tst, _, (tf, tg) = ts.run_steps_history(ts.initialize(), 0, STEPS)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-9)
    np.testing.assert_allclose(tst.Z.t.numpy(), np.asarray(jst.Z.t),
                               atol=1e-8)
    np.testing.assert_allclose(tst.Z.R.numpy(), np.asarray(jst.Z.R),
                               atol=1e-8)
    f = tf.numpy()
    assert np.all(np.diff(f) <= 1e-12 * np.abs(f[1:]))
    assert float((tst.s == 1).all()) and float((tst.gamma == 0).all())


def _arrays(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _state_arrays(st) -> dict:
    return {name: (_arrays(v) if dataclasses.is_dataclass(v)
                   else np.asarray(v))
            for name, v in st._asdict().items()}


def test_precon_inv_and_rspace_operators_match_jax(rng):
    """The block-Jacobi blocks precon_inv built by the port (Lanczos seed a
    per node) and the R-space operators on a converted MM state against the
    JAX package, rtol 1e-10: mG10_apply, mG11_apply, G_apply,
    reduced_euclidean_grad, reduced_hessian_vp, precondition,
    precondition_tall_jacobi and evaluate_G."""
    from dpgo_tpu_torch.convert import problem_from_numpy, state_from_numpy
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.problem import build_node_problems

    js, jst, _, _ = _jax_mm(3)
    jp = js.probs
    _, _, mg = build_multigraph(_torch_meas(_graph(3)), 2)
    built = build_node_problems(mg, xi=1e-11, precon_cond=1e6, device="cpu")
    tol = dict(rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(built.precon_inv.numpy(),
                               np.asarray(jp.precon_inv), **tol)

    tp = problem_from_numpy(_arrays(jp), device="cpu")
    ts = state_from_numpy(_state_arrays(jst), device="cpu")
    t, R = ts.Z.t, ts.Z.R
    v = torch.tensor(rng.normal(size=t.shape))
    M = torch.tensor(rng.normal(size=R.shape))
    jv, jM = jnp.asarray(v.numpy()), jnp.asarray(M.numpy())

    def jmap(fn, *args):
        return np.asarray(jax.vmap(fn)(jp, *args))

    def close(ours, ref):
        np.testing.assert_allclose(ours.numpy(), ref, **tol)

    close(tp.mG10_apply(v), jmap(lambda p, x: p.mG10_apply(x), jv))
    close(tp.mG11_apply(M), jmap(lambda p, x: p.mG11_apply(x), jM))
    Gt, GR = tp.G_apply(t, R)
    jG = jax.vmap(lambda p, a, b: p.G_apply(a, b))(jp, jst.Z.t, jst.Z.R)
    close(Gt, np.asarray(jG[0]))
    close(GR, np.asarray(jG[1]))
    from dpgo_tpu.manifold import proj_tangent

    nab = tp.reduced_euclidean_grad(t, R, ts.g_R)
    jnab = jax.vmap(lambda p, a, b, c: p.reduced_euclidean_grad(a, b, c))(
        jp, jst.Z.t, jst.Z.R, jst.g_R)
    close(nab, np.asarray(jnab))
    Rdot = proj_tangent(jst.Z.R, jM)
    close(tp.reduced_hessian_vp(R, nab, torch.tensor(np.asarray(Rdot))),
          jmap(lambda p, r, n, x: p.reduced_hessian_vp(r, n, x), jst.Z.R,
               jnab, Rdot))
    close(tp.precondition(R, M),
          jmap(lambda p, r, x: p.precondition(r, x), jst.Z.R, jM))
    Q = tp.to_tall(R)
    close(tp.precondition_tall_jacobi(Q, tp.to_tall(M)),
          jmap(lambda p, r, x: p.precondition_tall_jacobi(
              p.to_tall(r), p.to_tall(x)), jst.Z.R, jM))
    close(tp.evaluate_G(t, R, (ts.g_t, ts.g_R), ts.f),
          jmap(lambda p, a, b, gt, gr, f: p.evaluate_G(a, b, (gt, gr), f),
               jst.Z.t, jst.Z.R, jst.g_t, jst.g_R, jst.f))


def test_rspace_tnt_model_matches_jax_oracle():
    """_make_tnt_model (block-Jacobi, absolute objective, no translation
    anchor) through tnt() on the single-node surrogate at the chordal start,
    run long to a critical point (the oracle of
    tests/test_solver.py::test_full_tnt_oracle_matches_amm_direction):
    value within rtol 1e-9, rotations within atol 1e-7 and translations up
    to the gauge within atol 1e-7, gradient norm below 1e-5 in both
    packages."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOptions
    from dpgo_tpu.solvers.mm import _make_tnt_model as j_model
    from dpgo_tpu.solvers.tnt import TNTParams as JParams
    from dpgo_tpu.solvers.tnt import tnt as j_tnt

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions, _make_tnt_model
    from dpgo_tpu_torch.solvers.tnt import TNTParams, tnt

    kw = dict(max_iterations=200, max_iterations_accepted=200,
              gradient_tolerance=1e-8,
              preconditioned_gradient_tolerance=1e-10,
              relative_decrease_tolerance=1e-15, stepsize_tolerance=1e-10,
              Delta_tolerance=1e-12)
    meas = _graph(3)
    js = JSolver(meas, num_nodes=1, opts=JOptions(accelerated=True))
    st0 = js.initialize()
    p = jax.tree.map(lambda x: x[0], js.probs)
    model = j_model(p, st0.g_t[0], st0.g_R[0], st0.f[0])
    jt, jR, jfx, jgn, _ = j_tnt(model, st0.Z.t[0], st0.Z.R[0],
                                JParams(**kw))

    ts = DPGOSolver(_torch_meas(meas), num_nodes=1,
                    opts=MMOptions(accelerated=True), device="cpu")
    tst0 = ts.initialize()
    tmodel = _make_tnt_model(ts.probs, tst0.g_t, tst0.g_R, tst0.f)
    tt, tR, tfx, tgn, _ = tnt(tmodel, tst0.Z.t, tst0.Z.R, TNTParams(**kw))
    assert float(jgn) < 1e-5 and float(tgn[0]) < 1e-5
    np.testing.assert_allclose(float(tfx[0]), float(jfx), rtol=1e-9)
    np.testing.assert_allclose(tR[0].numpy(), np.asarray(jR), atol=1e-7)
    # Without a translation anchor the solves divide the gauge (null)
    # response by xi = 1e-11, which scales rounding up by 1e11: the two
    # packages agree up to a common translation.
    tt, jt = tt[0].numpy(), np.asarray(jt)
    np.testing.assert_allclose(tt - tt.mean(0), jt - jt.mean(0), atol=1e-7)


@pytest.mark.parametrize("kind", ["none", "jacobi", "dense"])
def test_amm_preconditioners_match_jax_f64(kind):
    """AMM-PGO# with each STPCG preconditioner (tests/test_solver.py::
    test_preconditioner_enum_variants): 10 steps per-step 2f within rtol
    1e-9 of the JAX package; kernel K1's gate stays closed except under
    "dense" (and on the CPU always)."""
    from dpgo_tpu.driver import DPGOSolver as JSolver
    from dpgo_tpu.solvers.mm import MMOptions as JOptions

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions, resolve_preconditioner

    js = JSolver(_graph(3), num_nodes=2,
                 opts=JOptions(accelerated=True, preconditioner=kind))
    _, _, (jf, _) = js.run_steps_history(js.initialize(),
                                         jnp.zeros((), jnp.int32), 10)
    ts = DPGOSolver(_torch_meas(_graph(3)), num_nodes=2,
                    opts=MMOptions(accelerated=True, preconditioner=kind),
                    device="cpu")
    assert resolve_preconditioner(ts.probs, ts.opts) == kind
    assert not ts.fused_stpcg_engaged()
    _, _, (tf, _) = ts.run_steps_history(ts.initialize(), 0, 10)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9)


def test_schemes_and_preconditioners_reject_unknowns():
    """An unknown scheme raises ValueError at the first update (scheme="aa"
    runs, tests/test_torch_aa.py); an unknown preconditioner raises
    ValueError."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions, resolve_preconditioner

    meas = _torch_meas(_graph(2))
    with pytest.raises(ValueError, match="anderson"):
        DPGOSolver(meas, 2, opts=MMOptions(scheme="anderson"),
                   device="cpu").initialize()
    s = DPGOSolver(meas, 2, device="cpu")
    with pytest.raises(ValueError):
        resolve_preconditioner(s.probs, MMOptions(preconditioner="ichol"))
