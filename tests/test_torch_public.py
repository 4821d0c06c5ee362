"""The last public functions of the JAX package given a counterpart in the
port, each against the JAX one on the CPU in f64: manifold.retract and
random_rotations, utils.Stopwatch, NodeState.own / with_own,
NodeProblem.riemannian_grad and surrogate_g_f_fobj."""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("d", [3, 2])
def test_retract_matches_jax(d):
    from dpgo_tpu import manifold as jm

    from dpgo_tpu_torch import manifold as tm

    rng = np.random.default_rng(3)
    R = np.asarray(jm.project_sod(jnp.asarray(rng.normal(size=(50, d, d)))))
    V = 0.3 * rng.normal(size=(50, d, d))
    np.testing.assert_allclose(
        tm.retract(torch.tensor(R), torch.tensor(V)).numpy(),
        np.asarray(jm.retract(jnp.asarray(R), jnp.asarray(V))),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("d", [3, 2])
def test_random_rotations(d):
    """Rotations drawn from an explicit torch.Generator: the same seed gives
    the same rotations, each in SO(d), and they are the JAX package's
    projection of the generator's normal matrices."""
    from dpgo_tpu import manifold as jm

    from dpgo_tpu_torch.manifold import random_rotations

    R = random_rotations(torch.Generator().manual_seed(7), 40, d)
    assert R.shape == (40, d, d) and R.dtype == torch.float64
    assert torch.equal(R, random_rotations(torch.Generator().manual_seed(7),
                                           40, d))
    assert not torch.equal(R, random_rotations(
        torch.Generator().manual_seed(8), 40, d))
    eye = torch.eye(d, dtype=torch.float64)
    assert float((R.transpose(-1, -2) @ R - eye).abs().max()) < 1e-12
    assert float((torch.linalg.det(R) - 1).abs().max()) < 1e-12
    A = torch.randn((40, d, d), generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    np.testing.assert_allclose(R.numpy(),
                               np.asarray(jm.project_sod(jnp.asarray(
                                   A.numpy()))), rtol=0, atol=1e-12)


def test_stopwatch_matches_jax():
    """tick / tock in both packages: tock before tick raises RuntimeError,
    tock measures at least the time slept, and a tensor (or device) given
    as `sync` is waited for first."""
    from dpgo_tpu.utils import Stopwatch as JStopwatch

    from dpgo_tpu_torch.utils import Stopwatch

    for sw, sync in ((JStopwatch(), jnp.ones(3)),
                     (Stopwatch(), torch.ones(3))):
        with pytest.raises(RuntimeError, match="tick"):
            sw.tock()
        sw.tick()
        time.sleep(0.02)
        a = sw.tock(sync=sync)
        b = sw.tock()
        assert 0.02 <= a <= b
    sw = Stopwatch()
    sw.tick()
    assert sw.tock(sync="cpu") >= 0.0


@functools.lru_cache(maxsize=None)
def _jax_state(loss):
    """The JAX solver (f64, 40 poses, 2 nodes) after 3 AMM steps."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.solvers.mm import MMOptions

    meas, _, _ = random_pose_graph(np.random.default_rng(42), num_poses=40,
                                   d=3, loop_closures=30, noise=0.05)
    s = DPGOSolver(meas, num_nodes=2, opts=MMOptions(accelerated=True),
                   loss=Loss(loss), loss_reg=0.25, dtype=jnp.float64)
    st, _ = s.run_steps(s.initialize(), jnp.zeros((), jnp.int32), 3)
    return s, st


def _port(s, st):
    from dpgo_tpu_torch.convert import problem_from_numpy, state_from_numpy

    probs = problem_from_numpy({f.name: getattr(s.probs, f.name)
                                for f in dataclasses.fields(s.probs)},
                               device="cpu")
    arrays = {name: ({f.name: np.asarray(getattr(v, f.name))
                      for f in dataclasses.fields(v)}
                     if dataclasses.is_dataclass(v) else np.asarray(v))
              for name, v in st._asdict().items()}
    return probs, state_from_numpy(arrays, device="cpu")


def test_node_state_own_and_with_own():
    s, st = _jax_state("trivial")
    _, ts = _port(s, st)
    Z = ts.Z
    t, R = Z.own()
    assert t is Z.t and R is Z.R
    jt, jR = st.Z.own()
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(R.numpy(), np.asarray(jR))
    Z2 = Z.with_own(t + 1.0, R * 2.0)
    jZ2 = st.Z.with_own(jt + 1.0, jR * 2.0)
    for name in ("t", "R", "th", "Rh"):
        np.testing.assert_array_equal(getattr(Z2, name).numpy(),
                                      np.asarray(getattr(jZ2, name)))
    assert Z2.th is Z.th and Z2.Rh is Z.Rh


@pytest.mark.parametrize("loss", ["trivial", "huber"])
def test_riemannian_grad_and_surrogate_match_jax(loss):
    """NodeProblem.riemannian_grad (with the default Euclidean gradient and
    with a given one) and surrogate_g_f_fobj on the same state, batched
    over the nodes, against the JAX package's vmapped per-node methods
    (rtol 1e-11)."""
    s, st = _jax_state(loss)
    probs, ts = _port(s, st)
    tol = dict(rtol=1e-11, atol=1e-12)

    jg = jax.vmap(lambda p, z: p.riemannian_grad(z))(s.probs, st.Z)
    tg = probs.riemannian_grad(ts.Z)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    Df = (ts.Df_t, ts.Df_R)
    jg = jax.vmap(lambda p, z, a, b: p.riemannian_grad(z, (a, b)))(
        s.probs, st.Z, st.Df_t, st.Df_R)
    for a, b in zip(probs.riemannian_grad(ts.Z, Df), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)

    (jgt, jgR), jf, jfo = jax.vmap(lambda p, z: p.surrogate_g_f_fobj(z))(
        s.probs, st.Z)
    (tgt, tgR), tf, tfo = probs.surrogate_g_f_fobj(ts.Z)
    for a, b in ((tgt, jgt), (tgR, jgR), (tf, jf), (tfo, jfo)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
