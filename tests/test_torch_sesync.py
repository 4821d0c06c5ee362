"""The port's SE-Sync problem, staircase and certificate (sesync/problem.py,
sesync/staircase.py) and its copy of the host LM polish against the JAX
package, on the CPU in float64."""

import dataclasses
import functools

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


@functools.lru_cache(maxsize=None)
def _graph(d=3, num_poses=30, seed=11):
    meas, _, _ = random_pose_graph(np.random.default_rng(seed),
                                   num_poses=num_poses, d=d,
                                   loop_closures=20, noise=0.05)
    return meas


@functools.lru_cache(maxsize=None)
def _jax_sesync(formulation):
    from dpgo_tpu.sesync.staircase import sesync
    return sesync(_graph(), formulation=formulation)


def _gauge_free(R):
    """R_0^T R_i: the rotations with the global gauge removed."""
    R = np.asarray(R)
    return np.einsum("ba,nbc->nac", R[0], R)


@pytest.mark.parametrize("dense_limit", [4096, 10])
def test_sesync_problem_operators_match_jax(dense_limit):
    """apply_Q, objective, Lambda_blocks, apply_S, project_blocks,
    round_solution and recover_translations equal the JAX package's to
    1e-12 on the same inputs, with the dense reduced-Laplacian inverse and
    with the host SuperLU solve (dense_limit=10: every application is a
    host round trip, counted as "lred_host"). round_solution is compared
    with the global gauge removed (the SVD's column signs are free)."""
    from dpgo_tpu.sesync.problem import build_sesync_problem as jbuild

    from dpgo_tpu_torch.sesync.problem import build_sesync_problem

    meas = _graph()
    jp = jbuild(meas, dense_limit=dense_limit)
    tp = build_sesync_problem(_torch_meas(meas), dense_limit=dense_limit,
                              device="cpu")
    assert (tp.lred_host is not None) == (dense_limit == 10)
    rng = np.random.default_rng(0)
    n, d, r = tp.n, tp.d, 5
    Y = np.asarray(jp.project_blocks(jnp.asarray(
        rng.normal(size=(n * d, r)))))
    V = rng.normal(size=(n * d, r))

    def close(a, b, tol=1e-12):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))

    Yt, Vt, Yj, Vj = (torch.as_tensor(Y), torch.as_tensor(V),
                      jnp.asarray(Y), jnp.asarray(V))
    close(tp.apply_Q(Vt), jp.apply_Q(Vj))
    close(tp.objective(Yt), jp.objective(Yj))
    Lt, Lj = tp.Lambda_blocks(Yt), jp.Lambda_blocks(Yj)
    close(Lt, Lj)
    close(tp.apply_S(Lt, Vt), jp.apply_S(Lj, Vj))
    close(tp.project_blocks(Vt), jp.project_blocks(Vj))
    close(tp.hess_vp(Yt, tp.apply_Q(Yt), Vt),
          jp.hess_vp(Yj, jp.apply_Q(Yj), Vj))
    close(tp.precondition(Yt, Vt), jp.precondition(Yj, Vj))
    Rt, Rj = tp.round_solution(Yt), jp.round_solution(Yj)
    close(_gauge_free(Rt.numpy()), _gauge_free(Rj))
    close(tp.recover_translations(torch.as_tensor(np.asarray(Rj))),
          jp.recover_translations(Rj))
    if dense_limit == 10:
        assert tp.syncs.loops["lred_host"][0] > 0


def test_explicit_gradient_and_hessian_match_jax():
    """SESyncExplicit's analytic gradient and Hessian-vector product equal
    the JAX package's jax.grad / jax.jvp ones to 1e-12."""
    from dpgo_tpu.sesync.problem import build_sesync_explicit as jbuild

    from dpgo_tpu_torch.sesync.problem import build_sesync_explicit

    meas = _graph(num_poses=12)
    je = jbuild(meas)
    te = build_sesync_explicit(_torch_meas(meas), device="cpu")
    rng = np.random.default_rng(1)
    n, d, r = 12, 3, 4
    Y = np.asarray(je.base.project_blocks(jnp.asarray(
        rng.normal(size=(n * d, r)))))
    t = rng.normal(size=(n, r))
    v = (rng.normal(size=(n, r)), rng.normal(size=(n * d, r)))
    xj, xt = (jnp.asarray(t), jnp.asarray(Y)), (torch.as_tensor(t),
                                                 torch.as_tensor(Y))
    gj, nj = je.tnt_model().grad_and_nabla(xj)
    gt, nt = te.tnt_model().grad_and_nabla(xt)
    hj = je.hess_vp(xj, nj, tuple(jnp.asarray(a) for a in v))
    ht = te.hess_vp(xt, nt, tuple(torch.as_tensor(a) for a in v))
    for a, b in zip(gt + nt + ht, gj + nj + hj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(float(te.objective(xt)),
                               float(je.objective(xj)), rtol=1e-13)


@pytest.mark.parametrize("formulation", ["simplified", "explicit", "sosync"])
def test_sesync_matches_jax(formulation):
    """The staircase on a 30-pose graph in each formulation: the same
    status and rank as the JAX package, fxhat and sdp_val within 1e-8
    (relative), and the same rounded rotations up to the global gauge."""
    from dpgo_tpu_torch.sesync.staircase import sesync

    jr = _jax_sesync(formulation)
    tr = sesync(_torch_meas(_graph()), formulation=formulation, device="cpu")
    assert tr.status == jr.status
    assert tr.rank == jr.rank
    np.testing.assert_allclose(tr.fxhat, jr.fxhat, rtol=1e-8)
    np.testing.assert_allclose(tr.sdp_val, jr.sdp_val, rtol=1e-8)
    np.testing.assert_allclose(_gauge_free(tr.R), _gauge_free(jr.R),
                               atol=1e-6)


@pytest.mark.parametrize("method", ["auto", "lobpcg"])
def test_certify_solution_matches_jax(method):
    """certify_solution on the staircase's optimum: the same verdict as the
    JAX package (certified), fxhat within 1e-10 (relative), lambda_min
    within 1e-6 of JAX's (the bound charges residuals of two eigensolves
    with different random starts) and the same route; both packages reject
    the negative control (rotations of poses 10-19 turned 0.5 rad about z)
    with lambda_min below -1e-2."""
    from dpgo_tpu.sesync.staircase import certify_solution as jcertify

    from dpgo_tpu_torch.sesync.staircase import certify_solution

    meas = _graph()
    R = _jax_sesync("simplified").R
    jok, jlam, jbound, jfx = jcertify(meas, R, method=method)
    stats = {}
    tok, tlam, tbound, tfx = certify_solution(
        _torch_meas(meas), R, method=method, device="cpu", stats=stats)
    assert tok and jok
    np.testing.assert_allclose(tfx, jfx, rtol=1e-10)
    assert abs(tlam - jlam) <= 1e-6
    assert stats["route"] == ("psd_accept" if method == "auto"
                              else "lobpcg")
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    Rbad = R.copy()
    Rbad[10:20] = turn @ Rbad[10:20]
    jok, jlam, _, _ = jcertify(meas, Rbad, method=method)
    tok, tlam, _, _ = certify_solution(_torch_meas(meas), Rbad,
                                       method=method, device="cpu")
    assert not tok and not jok
    assert tlam < -1e-2 and jlam < -1e-2


@pytest.mark.parametrize("precon", [False, True])
def test_min_eig_lobpcg_matches_dense(precon):
    """min_eig_lobpcg's smallest eigenvalue against numpy.linalg.eigvalsh:
    plainly on a random symmetric matrix (tests/test_sesync.py's case), and
    with the Chebyshev preconditioner on a certificate-like spectrum (an
    isolated 1e-3 below a band 1 .. 1e3) where at the same 20 iterations it
    is far more converged than the plain run."""
    from dpgo_tpu_torch.sesync.staircase import (chebyshev_precon,
                                                 min_eig_lobpcg)

    rng = np.random.default_rng(42)
    if not precon:
        n = 60
        A = rng.normal(size=(n, n))
        S = torch.as_tensor(0.5 * (A + A.T))
        lam, _, _ = min_eig_lobpcg(lambda V: S @ V, n, 0, torch.float64,
                                   block=4, iters=150, device="cpu")
        np.testing.assert_allclose(float(lam),
                                   np.linalg.eigvalsh(S.numpy())[0],
                                   rtol=1e-6, atol=1e-8)
        return
    n = 120
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([[1e-3], np.geomspace(1.0, 1e3, n - 1)])
    S = torch.as_tensor((Q * w[None, :]) @ Q.T)

    def apply_S(V):
        return S @ V

    pre = chebyshev_precon(apply_S, lam_max=1.05e3, degree=10)
    _, _, resid_p = min_eig_lobpcg(apply_S, n, 0, torch.float64, block=4,
                                   iters=20, device="cpu")
    lam_c, _, resid_c = min_eig_lobpcg(apply_S, n, 0, torch.float64,
                                       block=4, iters=20, precon=pre,
                                       device="cpu")
    assert float(resid_c) < 0.1 * float(resid_p)
    np.testing.assert_allclose(float(lam_c), np.linalg.eigvalsh(S.numpy())[0],
                               rtol=1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_host_lm_matches_jax(d):
    """The port's copy of host_lm (lm_polish, host_objective_2f) equals the
    JAX package's to 1e-12 from the same perturbed start."""
    from dpgo_tpu.solvers.host_lm import host_objective_2f as jf2
    from dpgo_tpu.solvers.host_lm import lm_polish as jlm

    from dpgo_tpu_torch.solvers.host_lm import host_objective_2f, lm_polish

    meas, t_true, R_true = random_pose_graph(np.random.default_rng(d),
                                             num_poses=40, d=d,
                                             loop_closures=20, noise=0.05)
    rng = np.random.default_rng(9)
    t0 = t_true + 0.1 * rng.normal(size=t_true.shape)
    jr = jlm(meas, t0, R_true)
    tr = lm_polish(_torch_meas(meas), t0, R_true)
    assert tr.iters == jr.iters and tr.converged == jr.converged
    np.testing.assert_allclose(tr.f2x, jr.f2x, rtol=1e-12)
    np.testing.assert_allclose(tr.t, jr.t, atol=1e-12)
    np.testing.assert_allclose(tr.R, jr.R, atol=1e-12)
    np.testing.assert_allclose(host_objective_2f(_torch_meas(meas), tr.t,
                                                 tr.R),
                               jf2(meas, jr.t, jr.R), rtol=1e-12)
