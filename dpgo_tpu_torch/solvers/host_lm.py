"""Host-side exact sparse Levenberg-Marquardt polish (f64, scipy): a copy of
dpgo_tpu/solvers/host_lm.py, which imports no JAX, kept in this package so
that it imports nothing of dpgo_tpu.

Role: the tail-convergence fallback for pathologically conditioned graphs
(ais2klinik's multiscale corridor), where every iterative method — the AMM
fixed point, node-block/multilevel-preconditioned STPCG — plateaus because
the Hessian's condition number spans the corridor's scale hierarchy. A
sparse DIRECT solve is immune to conditioning: this module builds the exact
Gauss-Newton normal equations of the chordal PGO objective and factors them
with SuperLU (scipy.sparse.linalg.splu), converging quadratically from any
stationarity plateau.

This is the moral equivalent of the reference's CHOLMOD-backed second-order
machinery (Eigen::CholmodDecomposition, DPGO/DPGO_types.h:27; TNT inner
solves, DPGOProblem.cpp:93-124) — the one architectural piece the
accelerator design replaced with preconditioned CG, reintroduced here as a
host-side f64 tool for the rare graph whose conditioning defeats
preconditioning. It is NOT on the device hot path.

Objective (matches dpgo_tpu_torch.objective.evaluate_f, trivial loss):
    F(t, theta) = 1/2 sum_e  tau_e |t_i + R(th_i) t~_e - t_j|^2
                           + kappa_e |R(th_i) R~_e - R(th_j)|^2_F
For d = 2, |R(a) - R(b)|^2_F = 2 |u(a) - u(b)|^2 with u(th) = (cos, sin),
so F = 1/2 |r|^2 with per-edge residual rows
    r_t = sqrt(tau)  (t_i + R(th_i) t~ - t_j)            (2 rows)
    r_R = sqrt(2 kappa) (u(th_i + th~) - u(th_j))        (2 rows)
which is an exact nonlinear least-squares in (x, y, theta) per pose — no
manifold retraction needed (theta is an unconstrained chart of SO(2)).

Gauge: the LM damping term lam * diag(J^T J) regularizes the 3-dimensional
gauge null space; no anchoring required (the solution is reported in the
input's gauge up to the vanishing damped step along the null directions).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from dpgo_tpu_torch.io.g2o import Measurements


@dataclasses.dataclass
class LMResult:
    t: np.ndarray        # [n, d]
    R: np.ndarray        # [n, d, d]
    f2x: float           # 2 * F at the solution
    grad_inf: float      # max |dF/d(t, theta)| (euclidean chart gradient)
    iters: int
    converged: bool


def _theta_of(R: np.ndarray) -> np.ndarray:
    return np.arctan2(R[:, 1, 0], R[:, 0, 0])


def _R_of(theta: np.ndarray) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    R = np.empty((theta.shape[0], 2, 2))
    R[:, 0, 0] = c
    R[:, 0, 1] = -s
    R[:, 1, 0] = s
    R[:, 1, 1] = c
    return R


def _residual_and_jac(meas: Measurements, t: np.ndarray, theta: np.ndarray,
                      want_jac: bool = True):
    """Stacked residual r [4m] and sparse Jacobian J [4m, 3n] (COO built
    vectorized; 6 nonzero columns per edge: x_i y_i th_i x_j y_j th_j)."""
    n = t.shape[0]
    i, j = meas.i, meas.j
    m = len(i)
    th_i, th_j = theta[i], theta[j]
    # Measurement rotation angle and translation.
    th_e = np.arctan2(meas.R[:, 1, 0], meas.R[:, 0, 0])
    te = meas.t  # [m, 2]
    st_, ct_ = np.sin(th_i), np.cos(th_i)
    # R(th_i) t~
    Rt = np.stack([ct_ * te[:, 0] - st_ * te[:, 1],
                   st_ * te[:, 0] + ct_ * te[:, 1]], axis=1)
    sq_tau = np.sqrt(meas.tau)
    sq_kap = np.sqrt(2.0 * meas.kappa)
    r_t = sq_tau[:, None] * (t[i] + Rt - t[j])              # [m, 2]
    a = th_i + th_e
    r_R = sq_kap[:, None] * np.stack(
        [np.cos(a) - np.cos(th_j), np.sin(a) - np.sin(th_j)], axis=1)
    r = np.concatenate([r_t.ravel(), r_R.ravel()])
    if not want_jac:
        return r, None, None

    # dRt/dth_i = R(th_i + pi/2) t~
    dRt = np.stack([-st_ * te[:, 0] - ct_ * te[:, 1],
                    ct_ * te[:, 0] - st_ * te[:, 1]], axis=1)
    rows = []
    cols = []
    vals = []

    def add(rr, cc, vv):
        rows.append(rr)
        cols.append(cc)
        vals.append(vv)

    e = np.arange(m)
    # Translation rows: row ids 2e, 2e+1.
    for comp in (0, 1):
        rr = 2 * e + comp
        add(rr, 3 * i + comp, sq_tau)                    # d/dx_i (or y_i)
        add(rr, 3 * j + comp, -sq_tau)
        add(rr, 3 * i + 2, sq_tau * dRt[:, comp])        # d/dth_i
    # Rotation rows: row ids 4m offset... place after translation block.
    base = 2 * m
    # r_R rows: [cos(a) - cos(th_j), sin(a) - sin(th_j)] * sq_kap
    add(base + 2 * e + 0, 3 * i + 2, -sq_kap * np.sin(a))
    add(base + 2 * e + 0, 3 * j + 2, sq_kap * np.sin(th_j))
    add(base + 2 * e + 1, 3 * i + 2, sq_kap * np.cos(a))
    add(base + 2 * e + 1, 3 * j + 2, -sq_kap * np.cos(th_j))
    J = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(4 * m, 3 * n)).tocsr()

    # Exact-Hessian curvature correction H = J^T J + diag(c): the residuals
    # are linear in t and trigonometric in theta only, so every second-order
    # term sum_k r_k Hess(r_k) lands on the theta diagonal:
    #   d2 r_t / dth_i^2 = -sqrt(tau) R(th_i) t~      (rotation is its own
    #   d2 r_R / dth_i^2 = -sqrt(2kap) u(th_i + th~)   negative 2nd deriv)
    #   d2 r_R / dth_j^2 = +sqrt(2kap) u(th_j)
    c_i = -sq_tau * np.einsum("ec,ec->e", r_t, Rt) \
        - sq_kap * (r_R[:, 0] * np.cos(a) + r_R[:, 1] * np.sin(a))
    c_j = sq_kap * (r_R[:, 0] * np.cos(th_j) + r_R[:, 1] * np.sin(th_j))
    curv = np.zeros(3 * n)
    np.add.at(curv, 3 * i + 2, c_i)
    np.add.at(curv, 3 * j + 2, c_j)
    return r, J, curv


def lm_polish_2d(meas: Measurements, t0: np.ndarray, R0: np.ndarray,
                 max_iters: int = 50, grad_tol: float = 1e-10,
                 lam0: float = 1e-6, newton: bool = True,
                 verbose: bool = False) -> LMResult:
    """Exact sparse damped-Newton polish of the d=2 chordal PGO objective.

    newton=True (default) solves with the EXACT Hessian J^T J + diag(curv)
    — quadratic local convergence; Gauss-Newton (newton=False) drops the
    curvature term and converges only linearly when residuals are large
    (observed on ais2klinik: GN shaves ~1.5%/iter off the gradient where
    full Newton converges in a handful of steps). Conditioning is irrelevant
    either way: the damped system is factored exactly by SuperLU. `grad_tol`
    is on the max-abs euclidean chart gradient J^T r — the stationarity the
    certificate machinery needs (S Y ~ 0)."""
    assert meas.d == 2, "lm_polish_2d: d=2 only (theta chart of SO(2))"
    t = np.asarray(t0, np.float64).copy()
    theta = _theta_of(np.asarray(R0, np.float64))
    lam = lam0
    r, J, curv = _residual_and_jac(meas, t, theta)
    f = 0.5 * float(r @ r)
    it = 0
    converged = False
    for it in range(1, max_iters + 1):
        g = J.T @ r
        ginf = float(np.max(np.abs(g)))
        if verbose:
            print(f"  lm iter {it - 1}: 2f={2 * f:.12g} |g|_inf={ginf:.3e} "
                  f"lam={lam:.1e}", flush=True)
        if ginf < grad_tol:
            converged = True
            break
        H = (J.T @ J).tocsc()
        if newton:
            H = (H + sp.diags(curv)).tocsc()
        dscale = np.maximum(np.abs(H.diagonal()), 1e-12)
        accepted = False
        for _ in range(40):
            A = (H + sp.diags(lam * dscale)).tocsc()
            try:
                lu = spla.splu(A)
                step = lu.solve(-g)
            except RuntimeError:
                lam = max(lam, 1e-12) * 10.0
                continue
            if not np.all(np.isfinite(step)):
                lam = max(lam, 1e-12) * 10.0
                continue
            t_new = t + step.reshape(-1, 3)[:, :2]
            th_new = theta + step.reshape(-1, 3)[:, 2]
            r_new, _, _ = _residual_and_jac(meas, t_new, th_new,
                                            want_jac=False)
            f_new = 0.5 * float(r_new @ r_new)
            pred = -float(g @ step) - 0.5 * float(step @ (H @ step))
            rho = (f - f_new) / max(pred, 1e-300)
            if f_new < f and (rho > 1e-4 or not newton):
                t, theta, f = t_new, th_new, f_new
                r, J, curv = _residual_and_jac(meas, t, theta)
                lam = max(lam * (0.2 if rho > 0.75 else 0.7), 1e-14)
                accepted = True
                break
            lam = max(lam, 1e-12) * 10.0
        if not accepted:
            break
    g = J.T @ r
    return LMResult(t=t, R=_R_of(theta), f2x=2 * f,
                    grad_inf=float(np.max(np.abs(g))), iters=it,
                    converged=converged)


# ---------------------------------------------------------------------------
# d = 3: SE(3) local chart (right-perturbation R_i <- R_i Exp(w_i^)),
# Gauss-Newton LM with per-iteration re-linearization.
# ---------------------------------------------------------------------------


def _hat(w):
    """[m, 3] -> [m, 3, 3] skew matrices."""
    O = np.zeros_like(w[:, 0])
    return np.stack([
        np.stack([O, -w[:, 2], w[:, 1]], -1),
        np.stack([w[:, 2], O, -w[:, 0]], -1),
        np.stack([-w[:, 1], w[:, 0], O], -1)], -2)


def _expmap(w):
    """[n, 3] rotation vectors -> [n, 3, 3] rotations (Rodrigues)."""
    th = np.linalg.norm(w, axis=1, keepdims=True)
    # Clamp well above sqrt(smallest normal): below ~1e-150 the th**2 in b
    # would underflow to 0 and produce 0/0 = NaN; at the clamp, sin(th)/th
    # = 1 and (1-cos)/th^2 = 0.5 to machine precision, so R = I exactly as
    # the zero-rotation limit requires.
    th = np.maximum(th, 1e-150)
    a = (np.sin(th) / th)[:, :, None]
    b = ((1 - np.cos(th.ravel())) / th.ravel() ** 2)[:, None, None]
    W = _hat(w)
    return np.eye(3) + a * W + b * (W @ W)


def _residual_3d(meas: Measurements, t, R):
    Ri = R[meas.i]
    rt = np.sqrt(meas.tau)[:, None] * (
        t[meas.i] + np.einsum("eab,eb->ea", Ri, meas.t) - t[meas.j])
    rR = np.sqrt(meas.kappa)[:, None, None] * (
        np.einsum("eab,ebc->eac", Ri, meas.R) - R[meas.j])
    return np.concatenate([rt.ravel(), rR.reshape(len(meas.i), 9).ravel()])


def _jacobian_3d(meas: Measurements, t, R):
    """Sparse J of the stacked residual wrt the local chart
    (dt_i [3], w_i [3] with R_i <- R_i Exp(w_i^)), at w = 0.

    d(R_i Exp(w^) t~)/dw = -R_i [t~]_x ;  d(R_i Exp(w^) R~)/dw_k =
    R_i [e_k]_x R~ ;  d(R_j Exp(w^))/dw_k = R_j [e_k]_x."""
    n = t.shape[0]
    i, j = meas.i, meas.j
    m = len(i)
    sq_tau = np.sqrt(meas.tau)
    sq_kap = np.sqrt(meas.kappa)
    Ri, Rj = R[i], R[j]
    rows, cols, vals = [], [], []

    def add(rr, cc, vv):
        rows.append(np.broadcast_to(rr, vv.shape).ravel())
        cols.append(np.broadcast_to(cc, vv.shape).ravel())
        vals.append(np.ascontiguousarray(vv).ravel())

    e = np.arange(m)
    comp = np.arange(3)
    # --- translation rows (3 per edge): ids 3e + a.
    rt_rows = 3 * e[:, None] + comp[None, :]                       # [m, 3]
    eye3 = np.broadcast_to(np.eye(3), (m, 3, 3))
    # dt_i / dt_j
    add(rt_rows[:, :, None], 6 * i[:, None, None] + comp[None, None, :],
        sq_tau[:, None, None] * eye3)
    add(rt_rows[:, :, None], 6 * j[:, None, None] + comp[None, None, :],
        -sq_tau[:, None, None] * eye3)
    # w_i: -sqrt(tau) R_i [t~]_x  -> [m, 3(row a), 3(col k)]
    dRt = -np.einsum("eab,ebk->eak", Ri, _hat(meas.t))
    add(rt_rows[:, :, None], 6 * i[:, None, None] + 3 + comp[None, None, :],
        sq_tau[:, None, None] * dRt)
    # --- rotation rows (9 per edge): ids 3m + 9e + (3a + b) for entry
    # (a, b) of the residual matrix.
    ab = np.arange(9)
    rR_rows = 3 * m + 9 * e[:, None] + ab[None, :]                 # [m, 9]
    # w_i: d(R_i R~)/dw_k entry (a,b) = (R_i [e_k]_x R~)[a, b]
    Ek = _hat(np.eye(3))                                           # [3, 3, 3]
    dRi = np.einsum("eab,kbc,ecd->eadk", Ri, Ek, meas.R)           # [m,3,3,3]
    add(rR_rows[:, :, None],
        6 * i[:, None, None] + 3 + comp[None, None, :],
        sq_kap[:, None, None] * dRi.reshape(m, 9, 3))
    # w_j: -d(R_j)/dw_k = -(R_j [e_k]_x)
    dRj = -np.einsum("eab,kbc->eack", Rj, Ek)                      # [m,3,3,3]
    add(rR_rows[:, :, None],
        6 * j[:, None, None] + 3 + comp[None, None, :],
        sq_kap[:, None, None] * dRj.reshape(m, 9, 3))
    J = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(12 * m, 6 * n)).tocsr()
    return J


def lm_polish_3d(meas: Measurements, t0: np.ndarray, R0: np.ndarray,
                 max_iters: int = 50, grad_tol: float = 1e-10,
                 lam0: float = 1e-6, verbose: bool = False) -> LMResult:
    """Sparse Gauss-Newton LM on the d=3 chordal PGO objective in the
    SE(3) local chart (right perturbation, re-linearized per iteration;
    SuperLU-factored normal equations — conditioning-immune like the d=2
    path; GN rather than exact Newton, so local convergence is linear at
    nonzero residual but each step is an exact subproblem solve)."""
    assert meas.d == 3, "lm_polish_3d: d=3 only"
    t = np.asarray(t0, np.float64).copy()
    R = np.asarray(R0, np.float64).copy()
    lam = lam0
    r = _residual_3d(meas, t, R)
    f = 0.5 * float(r @ r)
    J = _jacobian_3d(meas, t, R)
    it = 0
    converged = False
    for it in range(1, max_iters + 1):
        g = J.T @ r
        ginf = float(np.max(np.abs(g)))
        if verbose:
            print(f"  lm3 iter {it - 1}: 2f={2 * f:.12g} "
                  f"|g|_inf={ginf:.3e} lam={lam:.1e}", flush=True)
        if ginf < grad_tol:
            converged = True
            break
        H = (J.T @ J).tocsc()
        dscale = np.maximum(np.abs(H.diagonal()), 1e-12)
        accepted = False
        for _ in range(40):
            A = (H + sp.diags(lam * dscale)).tocsc()
            try:
                step = spla.splu(A).solve(-g)
            except RuntimeError:
                lam = max(lam, 1e-12) * 10.0
                continue
            if not np.all(np.isfinite(step)):
                lam = max(lam, 1e-12) * 10.0
                continue
            s6 = step.reshape(-1, 6)
            t_new = t + s6[:, :3]
            R_new = R @ _expmap(s6[:, 3:])
            r_new = _residual_3d(meas, t_new, R_new)
            f_new = 0.5 * float(r_new @ r_new)
            if f_new < f:
                t, R, f, r = t_new, R_new, f_new, r_new
                J = _jacobian_3d(meas, t, R)
                lam = max(lam * 0.3, 1e-14)
                accepted = True
                break
            lam = max(lam, 1e-12) * 10.0
        if not accepted:
            break
    g = J.T @ r
    return LMResult(t=t, R=R, f2x=2 * f,
                    grad_inf=float(np.max(np.abs(g))), iters=it,
                    converged=converged)


def host_objective_2f(meas: Measurements, t: np.ndarray,
                      R: np.ndarray) -> float:
    """2*F in exact numpy f64 (chordal objective, trivial loss) — the
    host-side oracle beside a float32 solver (whose metrics evaluate in
    f32, with a ~1e-4-relative noise floor on 10k-pose graphs that masks
    polish-level improvements). Matches dpgo_tpu_torch.objective.evaluate_f
    exactly."""
    t = np.asarray(t, np.float64)
    R = np.asarray(R, np.float64)
    Ri = R[meas.i]
    rt = t[meas.i] + np.einsum("eab,eb->ea", Ri, meas.t) - t[meas.j]
    rR = np.einsum("eab,ebc->eac", Ri, meas.R) - R[meas.j]
    return float(np.sum(meas.tau * np.sum(rt * rt, -1))
                 + np.sum(meas.kappa * np.sum(rR * rR, (-1, -2))))


def lm_polish(meas: Measurements, t0: np.ndarray, R0: np.ndarray,
              **kw) -> LMResult:
    """Dimension dispatcher: exact-Newton theta chart for d=2, SE(3)
    local-chart Gauss-Newton for d=3."""
    if meas.d == 2:
        return lm_polish_2d(meas, t0, R0, **kw)
    return lm_polish_3d(meas, t0, R0, **kw)
