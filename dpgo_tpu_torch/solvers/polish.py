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

`split_tnt_model` is that model with the pose axis split over processes
(the sharded polish, parallel/spmd.py): each process holds its own rows,
reads the halo rows its edges need through an `exchange` of the point or
direction, and sums objective shares, inner products and the coarse
levels' restrictions over the processes through `reduce`. Its sums over
the pose axis go node by node (objective.SplitEdges), so the model gives
the same bits on one process (DPGOSolver.polish) and split;
`global_tnt_model` is the one-process case with a single node.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dpgo_tpu_torch.losses import Loss, loss_weight
from dpgo_tpu_torch.manifold import (proj_tangent, project_sod,
                                     sym_block_diag_product)
from dpgo_tpu_torch.objective import (EdgeData, SplitEdges, edge_residuals,
                                      split_euclidean_grad, split_f)
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


def split_hess_vp(se: SplitEdges, t: torch.Tensor, R: torch.Tensor,
                  vt: torch.Tensor, vR: torch.Tensor,
                  loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0):
    """The own rows of euclidean_hess_vp at the extended rows (t, R) along
    the extended directions (vt, vR), which may carry leading batch axes."""
    Ht, HR = euclidean_hess_vp(se.edges, t, R, vt, vR, loss, loss_reg)
    n = se.num_own
    return Ht[..., :n, :], HR[..., :n, :, :]


def with_halo(exchange, t: torch.Tensor, R: torch.Tensor):
    """Extended rows [own; halo] of (t [..., P_r, d], R [..., P_r, d, d])
    (a point or a direction, with any leading batch axes): one `exchange`
    of the rows packed per pose, [P_r, k] -> [H, k]. With no `exchange`
    (one process holding every pose) the rows are their own extension."""
    if exchange is None:
        return t, R
    d = t.shape[-1]
    lead = t.shape[:-2]
    m = math.prod(lead)
    P = t.shape[-2]
    rows = torch.cat([t.reshape(m, P, d), R.reshape(m, P, d * d)], dim=-1)
    h = exchange(rows.transpose(0, 1).reshape(P, -1))
    h = h.reshape(h.shape[0], m, d + d * d).transpose(0, 1)
    th = h[..., :d].reshape(lead + (-1, d))
    Rh = h[..., d:].reshape(lead + (-1, d, d))
    return torch.cat([t, th], dim=-2), torch.cat([R, Rh], dim=-3)


def _pose_ip(a, b) -> torch.Tensor:
    """Per-pose inner products [N_lanes, P] of batched (t, R) tangents."""
    return ((a[0] * b[0]).sum(-1)
            + (a[1] * b[1]).flatten(-2).sum(-1))


def split_tnt_model(se: SplitEdges, exchange=None, reduce=None,
                    loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
                    precondition=None, kernels: bool = True) -> TNTModel:
    """TNTModel of the global polish over one process's own rows
    x = (t [P_r, d], R [P_r, d, d]) when the pose axis is split over
    processes (`se`: its edges). `exchange(rows [P_r, k]) -> [H, k]` fills the halo rows from
    the other processes and `reduce(x) -> x` sums over them (None, None:
    one process holding every pose).

    The objective is the sum of the node partials; gradient,
    Hessian-vector product, preconditioner and retraction act on the own
    rows; every inner product TNT and STPCG take goes out through `reduce`
    as node partials (the model's `inner`), the scalars of one call in one
    collective. A gradient evaluation carries the point's extended rows in
    `nabla`, so a Hessian product exchanges only its direction: one
    exchange per CG iteration. `precondition` acts on the own rows (None:
    the per-pose Jacobi preconditioner of the share's edges)."""
    if reduce is None:
        def reduce(x):
            return x

    def objective(x):
        te, Re = with_halo(exchange, *x)
        return reduce(split_f(se, te, Re, loss, loss_reg)).sum(-1)

    def grad_and_nabla(x):
        te, Re = with_halo(exchange, *x)
        Dt, DR = split_euclidean_grad(se, te, Re, loss, loss_reg)
        return (Dt, proj_tangent(x[1], DR, kernels)), (Dt, DR, te, Re)

    def hess_vp(x, nabla, v):
        vte, vRe = with_halo(exchange, *v)
        Ht, HR = split_hess_vp(se, nabla[2], nabla[3], vte, vRe, loss,
                               loss_reg)
        HR = HR - sym_block_diag_product(v[1], x[1], nabla[1], kernels)
        return Ht, proj_tangent(x[1], HR, kernels)

    if precondition is None:
        precondition = _jacobi_precondition(
            se.edges, se.num_own + se.num_halo, rows=se.num_own,
            kernels=kernels)

    def retract(x, h):
        return x[0] + h[0], project_sod(x[1] + h[1], kernels)

    def inner(pairs):
        q = torch.stack([_pose_ip(a, b) for a, b in pairs])
        return tuple(reduce(se.pose_partials(q)).sum(-1).unbind(0))

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract, precon_spans_full_space=False,
                    inner=inner)


def _jacobi_precondition(edges: EdgeData, num_poses: int,
                         rows: int | None = None, kernels: bool = True):
    """Per-pose Jacobi preconditioner from stiffness scalars: translations
    see the weighted-Laplacian diagonal sum(tau); rotations the
    connection-Laplacian diagonal scale kappa (+ tau |t~|^2 on the i side).
    `rows`: keep the first rows only (the own rows of a split share)."""
    P = num_poses
    tau = edges.tau
    tnorm2 = torch.sum(edges.t * edges.t, dim=-1)
    wt = (tau.new_zeros(P).index_add_(0, edges.i, tau)
          .index_add_(0, edges.j, tau))
    wR = (tau.new_zeros(P).index_add_(0, edges.i,
                                      edges.kappa + tau * tnorm2)
          .index_add_(0, edges.j, edges.kappa))
    if rows is not None:
        wt, wR = wt[:rows], wR[:rows]
    wt = torch.clamp(wt, min=1e-12)
    wR = torch.clamp(wR, min=1e-12)

    def precondition(x, v):
        return (v[0] / wt[:, None],
                proj_tangent(x[1], v[1] / wR[:, None, None], kernels))

    return precondition


def global_tnt_model(edges: EdgeData, loss: Loss = Loss.TRIVIAL,
                     loss_reg: float = 1.0, num_poses: int | None = None,
                     precondition=None, kernels: bool = True) -> TNTModel:
    """TNTModel over the global variable x = (t [P, d], R [P, d, d]) (one
    problem; run it with `tnt_one`): split_tnt_model with one share holding
    every pose, its sums over the pose axis in one pass.

    `precondition(x, v) -> v'` overrides the built-in per-pose Jacobi
    preconditioner. `kernels` routes the retraction's SO(3) projection
    through kernel K2 and the tangent projections' block products through
    kernel K3 (False: their plain versions on any device)."""
    P = (num_poses if num_poses is not None
         else int(torch.maximum(edges.i.max(), edges.j.max())) + 1)
    se = SplitEdges.build(edges, np.zeros(P, np.int64), 0, 1)
    return split_tnt_model(se, None, None, loss, loss_reg, precondition,
                           kernels)


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


def _rigid_level(hess_vp_fn, nabla, x0, block_of, num_blocks,
                 reg: float = 1e-8, chunk: int = 128, reduce=None,
                 pieces=None):
    """One coarse level over per-block RIGID MOTIONS (one rotation + one
    translation per block), as (restrict, prolong): restrict(v) -> the
    piece sums of the coefficients P^T v, prolong(sums) -> P A_c^+ P^T v,
    so the correction is v -> prolong(restrict(v)).

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
    leading batch axis.

    Every sum over poses into blocks goes through `pieces` = (piece_of
    [P] int, block_of_piece [num_pieces] int): contiguous pose ranges that
    refine the blocks, summed per piece in pose order and then per block in
    piece order (None: the blocks themselves). With the pose axis split
    over processes (x0, `block_of` and `piece_of` the own rows, `reduce`
    summing over the processes, no piece on two processes), the piece sums
    are summed over the processes before the block sums, exactly (each
    piece is nonzero on one process), so the split gives the same bits as
    one process; the Galerkin operator and its eigendecomposition are
    identical on every process. `restrict` then returns the LOCAL piece
    sums of P^T v, which the caller reduces before `prolong`."""
    t0, R0 = x0
    P, d = t0.shape
    dtype, dev = t0.dtype, t0.device
    S = _skew_basis(d, dtype, dev)       # [s, d, d]
    s = S.shape[0]
    N = num_blocks
    K = s + d
    if pieces is None:
        pieces = (block_of, torch.arange(N, device=dev))
    piece_of, block_of_piece = pieces
    n_pieces = block_of_piece.shape[0]

    def piece_sums(x, dim):
        """Sums of x over the poses of each piece along `dim`."""
        shape = list(x.shape)
        shape[dim] = n_pieces
        return x.new_zeros(shape).index_add_(dim, piece_of, x)

    def block_sums(x, dim):
        """Sums of piece sums over the pieces of each block along `dim`."""
        shape = list(x.shape)
        shape[dim] = N
        return x.new_zeros(shape).index_add_(dim, block_of_piece, x)

    # Center each block so rotation/translation coarse dofs decouple.
    both = piece_sums(torch.cat([torch.ones_like(t0[:, :1]), t0], dim=1), 0)
    if reduce is not None:
        both = reduce(both)
    both = block_sums(both, 0)
    c = both[:, 1:] / torch.clamp(both[:, 0], min=1.0)[:, None]
    tc = t0 - c[block_of]

    def P_apply(coef):
        """[..., N, K] -> (vt [..., P, d], vR [..., P, d, d])."""
        w, u = coef[..., :s], coef[..., s:]
        Wp = torch.einsum("...ns,sab->...nab", w, S)[..., block_of, :, :]
        vR = Wp @ R0
        vt = (Wp @ tc[:, :, None])[..., 0] + u[..., block_of, :]
        return vt, vR

    def P_adj(vt, vR):
        """(vt [..., P, d], vR [..., P, d, d]) -> the piece sums of P^T v
        [..., n_pieces, K]."""
        aw = (torch.einsum("sab,pbc,...pac->...ps", S, R0, vR)
              + torch.einsum("sab,pb,...pa->...ps", S, tc, vt))
        dim = vt.dim() - 2
        return torch.cat([piece_sums(aw, dim), piece_sums(vt, dim)], dim=-1)

    n = N * K
    rows = []
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        coefs = t0.new_zeros(m, n)
        coefs[torch.arange(m, device=dev), c0 + torch.arange(m, device=dev)] \
            = 1.0
        Vt, VR = P_apply(coefs.reshape(m, N, K))
        Ht, HR = hess_vp_fn(x0, nabla, (Vt, VR))
        rows.append(P_adj(Ht, HR))
    A = torch.cat(rows, 0)
    if reduce is not None:
        A = reduce(A)
    A = block_sums(A, 1).reshape(n, n)
    A = 0.5 * (A + A.T)
    lam, Q = torch.linalg.eigh(A)
    lam_max = torch.clamp(lam[-1], min=1e-30)
    lam_inv = torch.where(lam > reg * lam_max,
                          1.0 / torch.clamp(lam, min=1e-30),
                          torch.zeros_like(lam))

    def restrict(v):
        return P_adj(*v).reshape(-1)

    def prolong(parts):
        coef = block_sums(parts.reshape(n_pieces, K), 0).reshape(-1)
        y = (Q @ (lam_inv * (Q.T @ coef))).reshape(N, K)
        return P_apply(y)

    return restrict, prolong


def coarse_rigid_preconditioner(hess_vp_fn, nabla, x0, node_of, num_nodes,
                                base_precon, reg: float = 1e-8,
                                kernels: bool = True):
    """Two-level preconditioner: block solve + per-node rigid coarse
    correction, applied additively:
      M v = M_block v + P A_c^+ P^T v   (SPD on the gauge complement)."""
    return multilevel_rigid_preconditioner(
        hess_vp_fn, nabla, x0, [(node_of, num_nodes)], base_precon, reg,
        kernels=kernels)


def contiguous_segments(num_poses: int, num_segments: int,
                        device=None) -> torch.Tensor:
    """Label poses with `num_segments` equal contiguous blocks [P] int64.

    Pose ids in the bundled datasets follow the trajectory, so contiguous id
    ranges are contiguous stretches of the robot path."""
    seg = (torch.arange(num_poses, device=device) * num_segments) // num_poses
    return torch.clamp(seg, max=num_segments - 1)


def multilevel_rigid_preconditioner(hess_vp_fn, nabla, x0, levels,
                                    base_precon, reg: float = 1e-8,
                                    reduce=None, kernels: bool = True):
    """Additive multilevel (BPX-style) preconditioner: block solve + rigid
    coarse corrections at every granularity in `levels`, a sequence of
    (block_of [P] int, num_blocks). Corridor graphs have slow bending modes
    at every scale between the pose spacing and the graph diameter, so the
    hierarchy sums corrections over a ladder of segment sizes; each level's
    Galerkin operator is built once at x0.

    A level may carry its pieces as a third element (see `_rigid_level`).
    `reduce` (the pose axis split over processes) sums every level's
    restriction over the processes in one collective per application;
    `kernels` routes the final tangent projection's block products through
    kernel K3."""
    lvls = [_rigid_level(hess_vp_fn, nabla, x0, lvl[0], lvl[1], reg,
                         reduce=reduce, pieces=lvl[2] if len(lvl) > 2
                         else None)
            for lvl in levels]

    def precondition(x, v):
        ct, cR = base_precon(x, v)
        coefs = [restrict(v) for restrict, _ in lvls]
        if reduce is not None:
            coefs = reduce(torch.cat(coefs)).split(
                [c.shape[0] for c in coefs])
        for (_, prolong), coef in zip(lvls, coefs):
            dt, dR = prolong(coef)
            ct = ct + dt
            cR = cR + dR
        return ct, proj_tangent(x[1], cR, kernels)

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
    type (global_tnt_model). Returns (t, R, f_value). On a CUDA card the
    TNT runs as one captured program replayed once (graph_nodes.run_once:
    no host read; `syncs` stays untouched), elsewhere on the host-read
    route."""
    params = params or polish_params()
    model = global_tnt_model(edges, loss, loss_reg, num_poses=t.shape[0],
                             precondition=precondition, kernels=kernels)
    if t.device.type == "cuda":
        from dpgo_tpu_torch.ops import graph_nodes
        (x, fx, _, _), _ = graph_nodes.run_once(
            t.device, lambda: tnt_one(model, (t, R), params))
    else:
        x, fx, _, _ = tnt_one(model, (t, R), params, syncs=syncs)
    return x[0], x[1], fx
