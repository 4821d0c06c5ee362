"""Global Riemannian trust-region polish of the full pose graph (torch port
of dpgo_tpu/solvers/polish.py).

The MM iterations refine each node against a surrogate; the polish runs
Riemannian TNT (solvers/tnt.py, as a batch of one) on the full coupled
problem E = R^{P x d} x SO(d)^P, with the matrix-free global objective and
gradient (objective.py) and the exact Hessian-vector product of the
Euclidean gradient. The MM fixed point propagates information one pose-graph
hop per iteration, so large-diameter graphs take hundreds of iterations for
the last 1e-4 of the objective; the global Newton step collapses that tail
superlinearly. Typical recipe: AMM-PGO# bulk phase -> `polish()` for a
handful of outer iterations.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.losses import Loss, loss_weight
from dpgo_tpu_torch.manifold import (proj_tangent, project_sod,
                                     sym_block_diag_product)
from dpgo_tpu_torch.objective import (EdgeData, edge_residuals,
                                      evaluate_euclidean_grad, evaluate_f)
from dpgo_tpu_torch.solvers.tnt import TNTModel, TNTParams, tnt_one
from dpgo_tpu_torch.utils import HostSyncs


def euclidean_hess_vp(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
                      vt: torch.Tensor, vR: torch.Tensor,
                      loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """Directional derivative of `evaluate_euclidean_grad` at (t, R) along
    (vt, vR), robust-loss weight derivatives included. The directions may
    carry leading batch axes ([..., P, d], [..., P, d, d]).

    Per edge the gradient is a scatter of u = w sqrt(tau) r_t and
    E = w sqrt(kappa) r_R; its derivative scatters
    du = sqrt(tau) (dw r_t + w dr_t) and dE likewise, with
    dr_t = sqrt(tau) (vt_i + vR_i t~ - vt_j), dr_R = sqrt(kappa)
    (vR_i R~ - vR_j) and dw = w'(s) ds, ds = 2 (<r_t, dr_t> + <r_R, dr_R>)."""
    i, j = edges.i, edges.j
    sq_tau = torch.sqrt(edges.tau)
    sq_kap = torch.sqrt(edges.kappa)
    vRi = vR[..., i, :, :]
    drt = sq_tau[:, None] * (vt[..., i, :]
                             + (vRi @ edges.t[:, :, None])[..., 0]
                             - vt[..., j, :])
    drR = sq_kap[:, None, None] * (vRi @ edges.R - vR[..., j, :, :])
    if loss == Loss.TRIVIAL:
        du = sq_tau[:, None] * drt
        dE = sq_kap[:, None, None] * drR
    else:
        rt, rR = edge_residuals(edges, t, R)
        s = torch.sum(rt * rt, dim=-1) + torch.sum(rR * rR, dim=(-1, -2))
        ds = 2.0 * (torch.sum(rt * drt, dim=-1)
                    + torch.sum(rR * drR, dim=(-1, -2)))
        # w'(s) by forward differentiation of the loss kernel itself.
        w, dw_ds = torch.func.jvp(lambda x: loss_weight(loss, x, loss_reg),
                                  (s,), (torch.ones_like(s),))
        inter = edges.is_inter
        w = torch.where(inter, w, torch.ones_like(w))
        dw = torch.where(inter, dw_ds * ds, torch.zeros_like(ds))
        du = sq_tau[:, None] * (dw[..., None] * rt + w[:, None] * drt)
        dE = sq_kap[:, None, None] * (dw[..., None, None] * rR
                                      + w[:, None, None] * drR)
    dim = vt.dim() - 2  # the pose axis (after any batch axes)
    Ht = torch.zeros_like(vt).index_add_(dim, i, du).index_add_(dim, j, -du)
    Gi = du[..., :, None] * edges.t[:, None, :] \
        + dE @ edges.R.transpose(-1, -2)
    HR = torch.zeros_like(vR).index_add_(dim, i, Gi).index_add_(dim, j, -dE)
    return Ht, HR


def global_tnt_model(edges: EdgeData, loss: Loss = Loss.TRIVIAL,
                     loss_reg: float = 1.0, num_poses: int | None = None,
                     precondition=None, kernels: bool = True) -> TNTModel:
    """TNTModel over the global variable x = (t [P, d], R [P, d, d]) (one
    problem; run it with `tnt_one`).

    `precondition(x, v) -> v'` overrides the built-in per-pose Jacobi
    preconditioner (driver.polish passes the node-block preconditioner).
    `kernels` routes the retraction's SO(3) projection through kernel K2
    (False: its plain version on any device)."""

    def objective(x):
        return evaluate_f(edges, x[0], x[1], loss, loss_reg)

    def grad_and_nabla(x):
        nabla = evaluate_euclidean_grad(edges, x[0], x[1], loss, loss_reg)
        return (nabla[0], proj_tangent(x[1], nabla[1])), nabla

    def hess_vp(x, nabla, v):
        # Riemannian Hessian on the embedded product manifold: directional
        # derivative of the Euclidean gradient, minus the SO(d) curvature
        # correction v_R sym(R^T nabla_R), tangent-projected.
        Ht, HR = euclidean_hess_vp(edges, x[0], x[1], v[0], v[1], loss,
                                   loss_reg)
        HR = HR - sym_block_diag_product(v[1], x[1], nabla[1])
        return Ht, proj_tangent(x[1], HR)

    # Jacobi preconditioner from per-pose stiffness scalars: translations
    # see the weighted-Laplacian diagonal sum(tau); rotations the
    # connection-Laplacian diagonal scale kappa (+ tau |t~|^2 on the i side).
    if precondition is None:
        P = (num_poses if num_poses is not None
             else int(edges.j.max()) + 1)
        tau = edges.tau
        tnorm2 = torch.sum(edges.t * edges.t, dim=-1)
        wt = (tau.new_zeros(P).index_add_(0, edges.i, tau)
              .index_add_(0, edges.j, tau))
        wR = (tau.new_zeros(P).index_add_(0, edges.i,
                                          edges.kappa + tau * tnorm2)
              .index_add_(0, edges.j, edges.kappa))
        wt = torch.clamp(wt, min=1e-12)
        wR = torch.clamp(wR, min=1e-12)

        def precondition(x, v):
            return (v[0] / wt[:, None],
                    proj_tangent(x[1], v[1] / wR[:, None, None]))

    def retract(x, h):
        return x[0] + h[0], project_sod(x[1] + h[1], kernels)

    # Every polish preconditioner (node-block base, optionally + rigid
    # coarse levels) excludes part of the inter-node coupling, so the
    # noise-floor gate stays off whatever TNTParams the caller passes.
    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract, precon_spans_full_space=False)


def _skew_basis(d: int, dtype, device) -> torch.Tensor:
    """Orthonormal-ish basis of skew d x d matrices [s, d, d]."""
    if d == 2:
        S = [[[0.0, -1.0], [1.0, 0.0]]]
    else:
        S = []
        for (a, b) in ((0, 1), (0, 2), (1, 2)):
            M = [[0.0] * 3 for _ in range(3)]
            M[a][b] = -1.0
            M[b][a] = 1.0
            S.append(M)
    return torch.tensor(S, dtype=dtype, device=device)


def _rigid_coarse_correction(hess_vp_fn, nabla, x0, block_of, num_blocks,
                             reg: float = 1e-8, chunk: int = 128):
    """One coarse-level correction v -> P A_c^+ P^T v over per-block RIGID
    MOTIONS (one rotation + one translation per block).

    Block-diagonal preconditioners are blind to cross-block lever arms: a
    rotation at one end of a corridor moves translations at the other by
    (graph length) x angle, so the Hessian's slow modes are smooth
    block-rigid motions. For block a with skew basis S_k,
      P(w, u)|_p = (W t_p - W c_a + u,  W R_p),  W = sum_k w_k S_k, p in a.
    The Galerkin operator A_c = P^T H(x0) P is built by Hessian passes
    batched over chunks of the basis (a chunk's one-hot coefficients are
    made from its index range; the full identity never exists) and
    pseudo-inverted (the global rigid motion is the gauge null space ->
    eigenvalue clip). `hess_vp_fn(x, nabla, v)` takes directions with a
    leading batch axis."""
    t0, R0 = x0
    P, d = t0.shape
    dtype, dev = t0.dtype, t0.device
    S = _skew_basis(d, dtype, dev)       # [s, d, d]
    s = S.shape[0]
    N = num_blocks
    K = s + d
    # Center each block so rotation/translation coarse dofs decouple.
    ones = t0.new_zeros(N).index_add_(0, block_of, torch.ones_like(t0[:, 0]))
    c = (t0.new_zeros(N, d).index_add_(0, block_of, t0)
         / torch.clamp(ones, min=1.0)[:, None])
    tc = t0 - c[block_of]

    def P_apply(coef):
        """[..., N, K] -> (vt [..., P, d], vR [..., P, d, d])."""
        w, u = coef[..., :s], coef[..., s:]
        Wp = torch.einsum("...ns,sab->...nab", w, S)[..., block_of, :, :]
        vR = Wp @ R0
        vt = (Wp @ tc[:, :, None])[..., 0] + u[..., block_of, :]
        return vt, vR

    def P_adj(vt, vR):
        """(vt [..., P, d], vR [..., P, d, d]) -> [..., N, K]."""
        aw = (torch.einsum("sab,pbc,...pac->...ps", S, R0, vR)
              + torch.einsum("sab,pb,...pa->...ps", S, tc, vt))
        dim = vt.dim() - 2
        w = aw.new_zeros(aw.shape[:-2] + (N, s)).index_add_(dim, block_of,
                                                           aw)
        u = vt.new_zeros(vt.shape[:-2] + (N, d)).index_add_(dim, block_of,
                                                           vt)
        return torch.cat([w, u], dim=-1)

    n = N * K
    rows = []
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        coefs = t0.new_zeros(m, n)
        coefs[torch.arange(m, device=dev), c0 + torch.arange(m, device=dev)] \
            = 1.0
        Vt, VR = P_apply(coefs.reshape(m, N, K))
        Ht, HR = hess_vp_fn(x0, nabla, (Vt, VR))
        rows.append(P_adj(Ht, HR).reshape(m, n))
    A = torch.cat(rows, 0)
    A = 0.5 * (A + A.T)
    lam, Q = torch.linalg.eigh(A)
    lam_max = torch.clamp(lam[-1], min=1e-30)
    lam_inv = torch.where(lam > reg * lam_max,
                          1.0 / torch.clamp(lam, min=1e-30),
                          torch.zeros_like(lam))

    def correction(v):
        coef = P_adj(*v).reshape(-1)
        y = (Q @ (lam_inv * (Q.T @ coef))).reshape(N, K)
        return P_apply(y)

    return correction


def coarse_rigid_preconditioner(hess_vp_fn, nabla, x0, node_of, num_nodes,
                                base_precon, reg: float = 1e-8):
    """Two-level preconditioner: block solve + per-node rigid coarse
    correction, applied additively:
      M v = M_block v + P A_c^+ P^T v   (SPD on the gauge complement)."""
    return multilevel_rigid_preconditioner(
        hess_vp_fn, nabla, x0, [(node_of, num_nodes)], base_precon, reg)


def contiguous_segments(num_poses: int, num_segments: int,
                        device=None) -> torch.Tensor:
    """Label poses with `num_segments` equal contiguous blocks [P] int64.

    Pose ids in the bundled datasets follow the trajectory, so contiguous id
    ranges are contiguous stretches of the robot path."""
    seg = (torch.arange(num_poses, device=device) * num_segments) // num_poses
    return torch.clamp(seg, max=num_segments - 1)


def multilevel_rigid_preconditioner(hess_vp_fn, nabla, x0, levels,
                                    base_precon, reg: float = 1e-8):
    """Additive multilevel (BPX-style) preconditioner: block solve + rigid
    coarse corrections at every granularity in `levels`, a sequence of
    (block_of [P] int, num_blocks). Corridor graphs have slow bending modes
    at every scale between the pose spacing and the graph diameter, so the
    hierarchy sums corrections over a ladder of segment sizes; each level's
    Galerkin operator is built once at x0."""
    corrs = [_rigid_coarse_correction(hess_vp_fn, nabla, x0, blk, nb, reg)
             for blk, nb in levels]

    def precondition(x, v):
        ct, cR = base_precon(x, v)
        for corr in corrs:
            dt, dR = corr(v)
            ct = ct + dt
            cR = cR + dR
        return ct, proj_tangent(x[1], cR)

    return precondition


def polish_params(outer: int = 20, tcg: int = 500,
                  grad_tol: float = 0.0) -> TNTParams:
    """TNT parameters for the polish role: run every outer iteration (no
    single-accept early exit), superlinear forcing from TNT defaults, the
    noise-floor gate off (the node-block preconditioner excludes inter-node
    coupling, so its model-decrease estimate is ~0 at any bulk-converged
    state)."""
    return TNTParams(max_iterations=outer, max_iterations_accepted=outer,
                     max_tCG_iterations=tcg,
                     gradient_tolerance=grad_tol,
                     preconditioned_gradient_tolerance=0.0,
                     Delta_tolerance=0.0,
                     relative_decrease_tolerance=0.0,
                     stepsize_tolerance=0.0,
                     noise_floor_gate=False)


def polish_global(edges: EdgeData, t: torch.Tensor, R: torch.Tensor,
                  loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
                  params: TNTParams | None = None, precondition=None,
                  kernels: bool = True, syncs: HostSyncs | None = None):
    """Run the global trust-region polish from (t, R) on their device and
    type. Returns (t, R, f_value)."""
    params = params or polish_params()
    model = global_tnt_model(edges, loss, loss_reg, num_poses=t.shape[0],
                             precondition=precondition, kernels=kernels)
    x, fx, _, _ = tnt_one(model, (t, R), params, syncs=syncs)
    return x[0], x[1], fx
