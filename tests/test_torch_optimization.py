"""The optimization library (solvers/optimization.py) in the port against
the JAX package, on the CPU (f64): the toy problems of
tests/test_optimization.py fed the same inputs in both packages. The results
agree to 1e-10 and the iteration counts are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _sphere(xp):
    """min |x - p|^2 on S^2 (the reference's TNT unit-test problem) for the
    array module `xp` (jnp or torch): objective, Riemannian gradient,
    retraction."""
    p = xp.asarray([1.0, 2.0, 2.0]) if xp is jnp else torch.tensor(
        [1.0, 2.0, 2.0], dtype=torch.float64)

    def obj(x):
        return ((x - p) ** 2).sum()

    def grad(x):
        g = 2.0 * (x - p)
        return g - (g * x).sum() * x

    def retract(x, v):
        y = x + v
        return y / xp.linalg.norm(y)

    return obj, grad, retract, p


def test_gradient_descent_sphere():
    """gradient_descent from (1, 0, 0): x, f, |grad| and iterations."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    params = dict(max_iterations=200)
    jx, jf, jg, jk = jo.gradient_descent(*_sphere(jnp)[:3],
                                         jnp.asarray([1.0, 0.0, 0.0]),
                                         jo.GDParams(**params))
    tx, tf, tg, tk = to.gradient_descent(
        *_sphere(torch)[:3], torch.tensor([1.0, 0.0, 0.0],
                                          dtype=torch.float64),
        to.GDParams(**params))
    assert tk == int(jk) and 1 < tk < 200
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(tf), float(jf), **TOL)
    np.testing.assert_allclose(float(tg), float(jg), **TOL)
    np.testing.assert_allclose(tx.numpy(), [1 / 3, 2 / 3, 2 / 3], atol=1e-5)


def _lsqr_both(A, b, **kw):
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    n = A.shape[1]
    j = jo.lsqr(lambda v: Aj @ v, lambda u: Aj.T @ u, bj, jnp.zeros(n),
                return_info=True, **kw)
    t = to.lsqr(lambda v: At @ v, lambda u: At.T @ u, bt,
                torch.zeros(n, dtype=torch.float64), return_info=True, **kw)
    return j, t


@pytest.mark.parametrize("case", ["plain", "damped", "trust_region"])
def test_lsqr_matches_jax(rng, case):
    """lsqr on a 30 x 10 least-squares problem: plain (atol 1e-12, the
    lstsq solution), Tikhonov-damped (damp 0.5), and with a trust radius a
    quarter of the solution's norm (the boundary step): x, |x| and the
    iteration count."""
    A = rng.normal(size=(30, 10))
    b = rng.normal(size=(30,))
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    kw = {"plain": dict(), "damped": dict(damp=0.5),
          "trust_region": dict(Delta=0.25 * float(np.linalg.norm(x_ref)))}[
        case]
    (jx, jn, jk), (tx, tn, tk) = _lsqr_both(A, b, max_iters=200, atol=1e-12,
                                            **kw)
    assert tk == int(jk) > 0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    if case == "plain":
        np.testing.assert_allclose(tx.numpy(), x_ref, atol=1e-6)
    if case == "trust_region":
        np.testing.assert_allclose(float(torch.linalg.norm(tx)),
                                   kw["Delta"], rtol=1e-6)


def test_tnls_step_matches_jax(rng):
    """tnls_step (the Gauss-Newton step min |J h + r|) on a 20 x 6 system."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    J = rng.normal(size=(20, 6))
    r = rng.normal(size=(20,))
    Jj, Jt = jnp.asarray(J), torch.as_tensor(J)
    hj = jo.tnls_step(lambda v: Jj @ v, lambda u: Jj.T @ u, jnp.asarray(r),
                      jnp.zeros(6), max_iters=100)
    ht = to.tnls_step(lambda v: Jt @ v, lambda u: Jt.T @ u,
                      torch.as_tensor(r), torch.zeros(6, dtype=torch.float64),
                      max_iters=100)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


def _curve(xp):
    """The exponential curve fit of test_tnls_euclidean_nonlinear_ls with
    analytic Jacobians: F(p) = p0 exp(p1 t) - y."""
    if xp is jnp:
        tgrid = jnp.linspace(0.0, 1.0, 25)
        p_true = jnp.asarray([1.3, -0.7])
    else:
        tgrid = torch.linspace(0.0, 1.0, 25, dtype=torch.float64)
        p_true = torch.tensor([1.3, -0.7], dtype=torch.float64)

    def model(p):
        return p[0] * xp.exp(p[1] * tgrid)

    y = model(p_true)

    def F(p):
        return model(p) - y

    def jac(p, v):
        e = xp.exp(p[1] * tgrid)
        return v[0] * e + v[1] * p[0] * tgrid * e

    def jacT(p, w):
        e = xp.exp(p[1] * tgrid)
        s = (w * e).sum(), (w * p[0] * tgrid * e).sum()
        return xp.stack(s)

    return F, jac, jacT, p_true


def _sphere_ls(xp):
    """min |x - p| on S^2 through the least-squares machinery."""
    _, _, retract, p = _sphere(xp)

    def F(x):
        return x - p

    def jac(x, v):
        return v

    def jacT(x, w):
        return w - x * (x * w).sum()

    return F, jac, jacT, retract


@pytest.mark.parametrize("problem", ["curve_fit", "sphere"])
def test_tnls_matches_jax(problem):
    """Full TNLS on the curve fit (Euclidean, from (2, 0.5)) and on the
    sphere (from (0, 0, 1)), 60 iterations at most: x, |F| and the
    iteration count; on the sphere also |grad|. The curve fit ends at a
    zero residual: there |F| (~1e-10) is rounding, held to atol 1e-10,
    and |grad| = |J^T F| / |F| is the norm of a rounding direction (both
    packages' are O(1), 4e-6 apart), so it is not compared."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    if problem == "curve_fit":
        Fj, jj, jTj, _ = _curve(jnp)
        Ft, jt, jTt, p_true = _curve(torch)
        retj = rett = (lambda p, h: p + h)
        x0 = [2.0, 0.5]
    else:
        Fj, jj, jTj, retj = _sphere_ls(jnp)
        Ft, jt, jTt, rett = _sphere_ls(torch)
        x0 = [0.0, 0.0, 1.0]
    params = dict(max_iterations=60)
    jx, jF, jg, jk = jo.tnls(Fj, jj, jTj, retj, jnp.asarray(x0),
                             jo.TNLSParams(**params))
    tx, tF, tg, tk = to.tnls(Ft, jt, jTt, rett,
                             torch.tensor(x0, dtype=torch.float64),
                             to.TNLSParams(**params))
    assert tk == int(jk) and 1 < tk < 60
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(tF), float(jF), **TOL)
    if problem == "curve_fit":
        np.testing.assert_allclose(tx.numpy(), p_true.numpy(), atol=1e-6)
        assert float(tF) < 1e-7
    else:
        np.testing.assert_allclose(float(tg), float(jg), **TOL)
        np.testing.assert_allclose(float(tF), 2.0, rtol=1e-9)


def _lasso(rng):
    A = rng.normal(size=(40, 15))
    b = rng.normal(size=(40,))
    return A, b, 0.5


def test_proximal_gradient_lasso_matches_jax(rng):
    """FISTA on the lasso (and the unaccelerated iteration): x and the
    iteration count."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    A, b, lam = _lasso(rng)
    L = float(np.linalg.norm(A, 2) ** 2)
    out = {}
    for pkg, mod, xp, arr in (("jax", jo, jnp, jnp.asarray),
                              ("torch", to, torch, torch.as_tensor)):
        Ax, bx = arr(A), arr(b)

        def grad_f(x, Ax=Ax, bx=bx):
            return Ax.T @ (Ax @ x - bx)

        def prox_g(v, step, xp=xp):
            return xp.sign(v) * xp.clip(xp.abs(v) - lam * step, 0.0, None)

        out[pkg] = [mod.proximal_gradient(
            grad_f, prox_g, arr(np.zeros(15)),
            mod.PGParams(step=1.0 / L, max_iterations=2000, tol=1e-12,
                         accelerated=acc)) for acc in (True, False)]
    for (jx, jk), (tx, tk) in zip(out["jax"], out["torch"]):
        assert tk == int(jk) > 1
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_admm_lasso_matches_jax(rng):
    """ADMM consensus split of the lasso (f = 1/2|Ax-b|^2, g = lam|z|_1,
    x - z = 0): x, z, u and the iteration count."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    A, b, lam = _lasso(rng)
    M = np.linalg.inv(A.T @ A + np.eye(15))
    Atb = A.T @ b
    out = {}
    for pkg, mod, xp, arr in (("jax", jo, jnp, jnp.asarray),
                              ("torch", to, torch, torch.as_tensor)):
        Mx, Atbx = arr(M), arr(Atb)

        def prox_f(v, rho, Mx=Mx, Atbx=Atbx):
            return Mx @ (Atbx - rho * v)

        def prox_g(v, rho, xp=xp):
            return xp.sign(v) * xp.clip(xp.abs(v) - lam / rho, 0.0, None)

        z0 = arr(np.zeros(15))
        out[pkg] = mod.admm(prox_f, prox_g, A=lambda x: x, B=lambda z: -z,
                            c=z0, x0=z0, z0=z0,
                            params=mod.ADMMParams(rho=1.0,
                                                  max_iterations=500))
    (jx, jz, ju, jk), (tx, tz, tu, tk) = out["jax"], out["torch"]
    assert tk == int(jk) > 1
    for t, j in ((tx, jx), (tz, jz), (tu, ju)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_tuple_points_match_jax(rng):
    """Points as a tuple of tensors (the JAX package's pytrees): lsqr on a
    block operator acting on (x1 [4], x2 [3, 2])."""
    from dpgo_tpu.solvers import optimization as jo

    from dpgo_tpu_torch.solvers import optimization as to

    A1 = rng.normal(size=(20, 4))
    A2 = rng.normal(size=(20, 3, 2))
    b = rng.normal(size=(20,))
    out = {}
    for pkg, mod, xp, arr, zeros in (
            ("jax", jo, jnp, jnp.asarray, jnp.zeros),
            ("torch", to, torch, torch.as_tensor,
             lambda s: torch.zeros(s, dtype=torch.float64))):
        a1, a2 = arr(A1), arr(A2)

        def A(x, a1=a1, a2=a2):
            return a1 @ x[0] + (a2 * x[1]).sum((-1, -2))

        def At(u, a1=a1, a2=a2):
            return (a1.T @ u, (a2 * u[:, None, None]).sum(0))

        out[pkg] = mod.lsqr(A, At, arr(b), (zeros(4), zeros((3, 2))),
                            max_iters=50, atol=1e-12, return_info=True)
    (jx, _, jk), (tx, _, tk) = out["jax"], out["torch"]
    assert tk == int(jk) > 1
    for t, j in zip(tx, jx):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
