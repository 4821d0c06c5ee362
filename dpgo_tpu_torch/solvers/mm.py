"""MM-PGO and AMM-PGO# (decentralized, adaptive-restart) solvers, batched
over the node axis (torch port of dpgo_tpu/solvers/mm.py).

- `update_state` = DPGOHash::update: surrogate anchors at the freshly
  communicated Z, Nesterov s/gamma, exponential reference sequences
  Fk0/Fk1, restart hit counters, oscillation window (AMM), or the plain
  anchors (MM).
- `iterate_amm`  = DPGOHash::amm_pgo: extrapolation, closed-form proximal
  step, TNT refinement, the adaptive retry / restart / phi-test cascade.
- `iterate_mm`   = DPGOHash::mm_pgo: proximal step and TNT refinement.
- `rescale` / `reweighted_problems`: robust losses under dynamic rescale
  update and iterate on the problems reweighted by the state's persisted
  weights (`with_weights`).

The TNT refinement follows the problems' regime (`_tnt_batch`): on the dense
path the dense model with the preconditioner the options name ("dense",
"jacobi" or "none"), where kernel K1 takes the trust-region subproblem under
"dense" and the torch `stpcg` otherwise, as the JAX package runs its XLA CG
there; on the edge-wise path `_make_tnt_model`, the R-space model with the
block-Jacobi preconditioner (also DChordal's stage 0); on the segment path
`_make_tnt_model_coupled`, the coupled (t, R) model with the segment
preconditioners.

- `iterate_aa`   = safeguarded Anderson acceleration of the MM fixed point
  (`scheme="aa"`; no reference analog).

Control flow: where the JAX package branches on the device (`lax.cond` on
`jnp.any(mask)`), this port calls `utils.device_cond`: on the host route it
reads the flag through a `HostSyncs` counter and skips the branch in
Python, on the graph route the branch is an IF node of the captured step.
"""

from __future__ import annotations

import dataclasses

import torch

from dpgo_tpu_torch.losses import Loss
from dpgo_tpu_torch.manifold import (block_mm, proj_tangent, project_sod,
                                     sym_block_diag_product)
from dpgo_tpu_torch.ops.stpcg import sel, stpcg_fused_reference
from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused
from dpgo_tpu_torch.problem import NodeProblem, NodeState, _nsum, with_weights
from dpgo_tpu_torch.solvers.tnt import TNTModel, TNTParams, tnt_generic
from dpgo_tpu_torch.utils import HostSyncs, device_cond


@dataclasses.dataclass(frozen=True)
class MMOptions:
    """Driver options (reference DPGO::Options defaults with the dist_pgo
    overrides; the JAX package's MMOptions, AMM path)."""

    accelerated: bool = True
    regularizer: float = 1e-11
    accepted_delta: float = 5e-4
    # Max condition number of the regularized STPCG preconditioner. None =
    # by dtype: 1e6 in f64, 1e5 in f32.
    precon_cond: float | None = None
    rescale: str = "static"          # "static" | "dynamic" (robust losses)
    max_rescale_count: int = 5
    min_rescale: float = 0.01
    max_rescale: float = 1.0
    # Per-node objective sequence: True = the exact Q-telescoping, False =
    # direct edge-wise evaluation each update. None = telescoped in f64,
    # direct in f32.
    telescoped: bool | None = None
    # Local gauge centering (driver). None = on in f32, off in f64.
    local_gauge: bool | None = None
    # STPCG preconditioner: "none" | "jacobi" (block-Jacobi of mG11) |
    # "dense" (the regularized reduced-Hessian inverse). None = "dense" on
    # the dense operator path, "jacobi" on the edge-wise path; the segment
    # path's coupled model has its own segment preconditioners.
    preconditioner: str | None = None
    eta0: float = 5e-4
    eta1: float = 2.5e-2
    psi: float = 1e-10
    phi: float = 1e-6
    max_soft_restart_hits0: int = 10
    max_soft_restart_hits1: int = 25
    oscillation_cnt_period: int = 15
    max_oscillations: int = 12
    tnt: TNTParams = TNTParams()
    # Iteration scheme: None = "amm" when accelerated else "mm" (the two
    # reference schemes); "aa" = safeguarded Anderson acceleration of the MM
    # fixed point (iterate_aa).
    scheme: str | None = None
    aa_window: int = 8        # Anderson history depth m
    aa_reg: float = 1e-8      # Tikhonov regularization of the normalized Gram
    # Safeguard: "monotone" accepts the Anderson candidate only when its
    # surrogate value does not exceed the anchor objective (keeps the global
    # objective monotone, since sum_a G_a(X_a|Z) >= f(X)); "none" always
    # accepts (diverges on hard graphs; for studies only).
    aa_safeguard: str = "monotone"
    # Re-solve translations exactly (min_t G given the Anderson rotations)
    # instead of keeping the extrapolated translations.
    aa_resolve_t: bool = False


def resolve_scheme(opts: MMOptions) -> str:
    if opts.scheme is not None:
        return opts.scheme
    return "amm" if opts.accelerated else "mm"


@dataclasses.dataclass
class MMState:
    """Per-node solver state; every tensor has a leading node axis."""

    # Current anchor Z (own + halo) and previous anchor.
    Z: NodeState
    Z_prev: NodeState
    # Surrogate anchors at Z (and previous, for linear extrapolation).
    g_t: torch.Tensor
    g_R: torch.Tensor
    f: torch.Tensor          # [N]
    fobj: torch.Tensor       # [N] node objective
    Df_t: torch.Tensor
    Df_R: torch.Tensor
    g_t_prev: torch.Tensor
    g_R_prev: torch.Tensor
    Df_t_prev: torch.Tensor
    Df_R_prev: torch.Tensor
    fobj_prev: torch.Tensor
    gradFnorm: torch.Tensor  # [N]
    # Nesterov bookkeeping.
    Gk: torch.Tensor         # [N] surrogate value at current own estimate
    Fk0: torch.Tensor
    Fk1: torch.Tensor
    s: torch.Tensor          # [N] s_k
    s_next: torch.Tensor     # [N] s_{k+1} (may be halved by hard restarts)
    gamma: torch.Tensor
    hits0: torch.Tensor      # [N] int32
    hits1: torch.Tensor
    osc_buf: torch.Tensor    # [N, oscillation_cnt_period + 2] int32
    num_osc: torch.Tensor    # [N] int32
    # Anchor residual halves at Z, cached by update_state.
    z_rt: torch.Tensor       # [N, m0, d]
    z_rR: torch.Tensor       # [N, m0, d, d]
    z_us: torch.Tensor       # [N, m1, d]
    z_Es: torch.Tensor       # [N, m1, d, d]
    # Dynamic rescale (robust losses): persisted surrogate weights and the
    # updates since each node's last rescale.
    scale_w: torch.Tensor    # [N, m1]
    rescale_count: torch.Tensor  # [N] int32
    # Anderson acceleration history (scheme="aa"; zero-sized otherwise).
    aa_dX: torch.Tensor      # [N, m, D] iterate diffs, newest last
    aa_dR: torch.Tensor      # [N, m, D] residual diffs, newest last
    aa_x_prev: torch.Tensor  # [N, D] previous anchor (flattened own block)
    aa_r_prev: torch.Tensor  # [N, D] previous residual
    aa_count: torch.Tensor   # [N] int32 valid history length

    def replace(self, **kw) -> "MMState":
        return dataclasses.replace(self, **kw)


def _flat_own(t: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Flatten per-node own blocks (t [N,n,d], R [N,n,d,d]) to [N, D]."""
    N = t.shape[0]
    return torch.cat([t.reshape(N, -1), R.reshape(N, -1)], dim=-1)


def _unflat_own(x: torch.Tensor, t_like: torch.Tensor, R_like: torch.Tensor):
    nt = t_like[0].numel()
    return (x[:, :nt].reshape(t_like.shape), x[:, nt:].reshape(R_like.shape))


def init_state(probs: NodeProblem, Z: NodeState, opts: MMOptions) -> MMState:
    N = Z.t.shape[0]
    d = Z.t.shape[-1]
    dt, dev = Z.t.dtype, Z.t.device
    zeros = torch.zeros(N, dtype=dt, device=dev)
    izeros = torch.zeros(N, dtype=torch.int32, device=dev)
    period = opts.oscillation_cnt_period
    m0, m1 = probs.a_i.shape[1], probs.e_self.shape[1]
    m = opts.aa_window if resolve_scheme(opts) == "aa" else 0
    D = Z.t[0].numel() + Z.R[0].numel() if m else 0
    z = torch.zeros_like
    return MMState(
        Z=Z, Z_prev=Z,
        g_t=z(Z.t), g_R=z(Z.R), f=zeros, fobj=zeros,
        Df_t=z(Z.t), Df_R=z(Z.R),
        g_t_prev=z(Z.t), g_R_prev=z(Z.R),
        Df_t_prev=z(Z.t), Df_R_prev=z(Z.R),
        fobj_prev=zeros, gradFnorm=zeros,
        Gk=zeros, Fk0=zeros, Fk1=zeros,
        s=torch.ones(N, dtype=dt, device=dev),
        s_next=torch.ones(N, dtype=dt, device=dev),
        gamma=zeros, hits0=izeros, hits1=izeros,
        osc_buf=torch.ones((N, period + 2), dtype=torch.int32, device=dev),
        num_osc=izeros,
        z_rt=torch.zeros((N, m0, d), dtype=dt, device=dev),
        z_rR=torch.zeros((N, m0, d, d), dtype=dt, device=dev),
        z_us=torch.zeros((N, m1, d), dtype=dt, device=dev),
        z_Es=torch.zeros((N, m1, d, d), dtype=dt, device=dev),
        scale_w=torch.ones_like(probs.scale_w),
        rescale_count=izeros,
        aa_dX=torch.zeros((N, m, D), dtype=dt, device=dev),
        aa_dR=torch.zeros((N, m, D), dtype=dt, device=dev),
        aa_x_prev=torch.zeros((N, D), dtype=dt, device=dev),
        aa_r_prev=torch.zeros((N, D), dtype=dt, device=dev),
        aa_count=izeros,
    )


def _check_supported(probs: NodeProblem, opts: MMOptions):
    if opts.rescale not in ("static", "dynamic"):
        raise ValueError(f"unknown rescale {opts.rescale!r}")
    scheme = resolve_scheme(opts)
    if scheme not in ("amm", "mm", "aa"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "aa" and opts.aa_safeguard not in ("monotone", "none"):
        raise ValueError(f"unknown aa_safeguard {opts.aa_safeguard!r}")


def _dynamic(probs: NodeProblem, opts: MMOptions) -> bool:
    return opts.rescale == "dynamic" and probs.loss is not Loss.TRIVIAL


def rescale(probs: NodeProblem, st: MMState, opts: MMOptions) -> MMState:
    """The dynamic-rescale trigger (the reference's
    evaluate_g_and_f0_rescale): a node whose current weight exceeds its
    persisted one on some inter-node edge, or that has gone
    `max_rescale_count` updates without a rescale, takes 1.25 x its current
    weights, clamped to [min_rescale, max_rescale]. Selected per node on the
    device; no host read. The state unchanged when static or for the
    trivial loss. `probs` are the base problems."""
    if not _dynamic(probs, opts):
        return st
    w_cur, _ = probs.inter_weights(st.Z)
    exceeded = (w_cur > st.scale_w).any(1)
    rescaled = (st.rescale_count >= opts.max_rescale_count) | exceeded
    w_new = torch.clamp(1.25 * w_cur, opts.min_rescale, opts.max_rescale)
    return st.replace(
        scale_w=torch.where(rescaled[:, None], w_new, st.scale_w),
        rescale_count=torch.where(rescaled, 0, st.rescale_count + 1).to(
            torch.int32))


def reweighted_problems(probs: NodeProblem, st: MMState,
                        opts: MMOptions) -> NodeProblem:
    """The base problems with the state's persisted dynamic-rescale weights
    applied (the base problems themselves when static or for the trivial
    loss)."""
    if not _dynamic(probs, opts):
        return probs
    return with_weights(probs, st.scale_w)


# --------------------------------------------------------------------- update


def update_state(probs: NodeProblem, st: MMState, opts: MMOptions,
                 k: int, first: bool) -> MMState:
    """DPGOHash::update: recompute surrogate anchors at the new Z and run
    the Nesterov/restart bookkeeping. `k` is the iteration index (0 at
    `first`): a Python int, or on the graph route a 0-d int32 tensor on the
    device that the captured step advances.

    Under dynamic rescale `st` has been through `rescale` and `probs` are
    the problems reweighted by its weights (`reweighted_problems`), the
    same problems the next iterate runs on."""
    _check_supported(probs, opts)
    if opts.oscillation_cnt_period + 2 != st.osc_buf.shape[-1]:
        raise ValueError("state was initialized with a different "
                         "oscillation_cnt_period; re-run init_state with "
                         "these options")
    telescoped = opts.telescoped
    if telescoped is None:
        telescoped = st.Z.t.dtype == torch.float64

    Z = st.Z
    if first or probs.loss is not Loss.TRIVIAL or not telescoped:
        # Robust kernels / f32: evaluate the node objective directly, fused
        # with the surrogate anchors so the edge arrays are gathered once.
        g, f, fobj, zres = probs.surrogate_g_f_fobj_res(Z)
    else:
        g, _ = probs.surrogate_g_f(Z)
        fobj = st.Gk + probs.q_gap(Z - st.Z_prev)
        f = fobj + probs.p_form(Z)
        zres = probs.anchor_residuals(Z.t, Z.R)
    Df = probs.euclidean_Df(Z, g=g)
    grad_t, grad_R = Df[0], proj_tangent(Z.R, Df[1], probs.kernels)
    gradFnorm = torch.sqrt(_nsum(grad_t * grad_t) + _nsum(grad_R * grad_R))
    g_t, g_R = g
    Df_t, Df_R = Df

    if first:
        Fk0 = Fk1 = Gk = fobj_prev = fobj
    else:
        Fk0, Fk1, Gk, fobj_prev = st.Fk0, st.Fk1, st.Gk, st.fobj

    if resolve_scheme(opts) == "amm":
        s0 = st.s_next if not first else st.s  # s_k (post-restart value)
        s1 = 0.5 + 0.5 * torch.sqrt(4.0 * s0 * s0 + 1.0)
        gamma = (s0 - 1.0) / s1

        dec0 = fobj <= Fk1
        hits0 = torch.where(dec0, torch.clamp(st.hits0 - 2, min=0),
                            st.hits0 + 1).to(torch.int32)

        if first:
            hits1, osc_buf, num_osc = st.hits1, st.osc_buf, st.num_osc
        else:
            dec = fobj <= fobj_prev
            hits1 = torch.where(dec, 0, st.hits1 + 1).to(torch.int32)
            osc_new = dec.to(torch.int32)
            osc_buf = torch.cat([st.osc_buf[:, 1:], osc_new[:, None]], dim=1)
            # += osc[k] != osc[k-1]
            num_osc = st.num_osc + (osc_buf[:, -1] != osc_buf[:, -2]).to(
                torch.int32)
            # -= osc[k-P] != osc[k-P-1] once k > P
            late = k > opts.oscillation_cnt_period
            left = num_osc - (osc_buf[:, 1] != osc_buf[:, 0]).to(torch.int32)
            if isinstance(late, torch.Tensor):
                num_osc = torch.where(late, left, num_osc)
            elif late:
                num_osc = left

        Fk0 = Fk0 * (1 - opts.eta0) + fobj * opts.eta0
        Fk1 = torch.maximum(fobj, Fk1 * (1 - opts.eta1) + fobj * opts.eta1)
    else:
        s0, s1, gamma = st.s, st.s_next, st.gamma
        hits0, hits1 = st.hits0, st.hits1
        osc_buf, num_osc = st.osc_buf, st.num_osc
        Fk0 = Fk1 = fobj

    return st.replace(
        g_t=g_t, g_R=g_R, f=f, fobj=fobj, Df_t=Df_t, Df_R=Df_R,
        g_t_prev=st.g_t if not first else g_t,
        g_R_prev=st.g_R if not first else g_R,
        Df_t_prev=st.Df_t if not first else Df_t,
        Df_R_prev=st.Df_R if not first else Df_R,
        fobj_prev=fobj_prev, gradFnorm=gradFnorm,
        Gk=Gk, Fk0=Fk0, Fk1=Fk1,
        s=s0, s_next=s1, gamma=gamma,
        hits0=hits0, hits1=hits1, osc_buf=osc_buf,
        num_osc=num_osc,
        z_rt=zres[0][0], z_rR=zres[0][1], z_us=zres[1][0], z_Es=zres[1][1],
    )


# -------------------------------------------------------------- TNT plumbing


def _make_tnt_model(p: NodeProblem, g_t, g_R, f, t_anchor=None,
                    precon: str = "jacobi", anchor=None,
                    syncs: HostSyncs | None = None) -> TNTModel:
    """Edge-wise TNT model in R-space (variable (t, R [N, n, d, d])), the
    translations eliminated through the split inverse; preconditioned by
    the block-Jacobi blocks (or not at all under "none").

    `anchor` = (z_t, z_R, fobj): the objective is the f32-stable relative
    form against the MM anchor (evaluate_G_rel), else the absolute form
    with the surrogate constant `f`. `t_anchor`: see solve_mG00."""
    if anchor is not None:
        z_t, z_R, fobj = anchor
        zres = p.anchor_residuals(z_t, z_R)

        def objective(x):
            return p.evaluate_G_rel(z_t, z_R, x[0], x[1], (g_t, g_R), fobj,
                                    zres=zres)
    else:
        def objective(x):
            return p.evaluate_G(x[0], x[1], (g_t, g_R), f)

    def grad_and_nabla(x):
        nabla = p.reduced_euclidean_grad(x[0], x[1], g_R)
        return proj_tangent(x[1], nabla, p.kernels), nabla

    def hess_vp(x, nabla, v):
        return p.reduced_hessian_vp(x[1], nabla, v)

    if precon == "none":
        def precondition(x, v):
            return v
    else:
        def precondition(x, v):
            return p.precondition(x[1], v)

    def retract(x, h):
        R_new = project_sod(x[1] + h, p.kernels)
        return p.recover_translations(R_new, g_t, t_anchor, syncs), R_new

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract)


def _make_tnt_model_coupled(p: NodeProblem, g_t, g_R, anchor) -> TNTModel:
    """Coupled (t, R) TNT model of the segment path; tangents are (t, R)
    pairs.

    The reduced (t-eliminated) model's Hessian-vector product needs one
    mG00 solve per STPCG iteration, which on the segment path would nest CG
    inside CG. The surrogate G is an exact quadratic in (t, R), so refining
    the coupled variable makes the product one edge-wise G_apply (no solve)
    with the same surrogate decrease guarantee (the trust-region acceptance
    still evaluates the true G). Preconditioner: the two-level segment
    Schwarz for t, the segment-dense regularized mG11 inverses for R.

    `anchor` = (z_t, z_R, fobj): the objective is the f32-stable relative
    form against the MM anchor (evaluate_G_rel)."""
    z_t, z_R, fobj = anchor
    zres = p.anchor_residuals(z_t, z_R)

    def objective(x):
        return p.evaluate_G_rel(z_t, z_R, x[0], x[1], (g_t, g_R), fobj,
                                zres=zres)

    def grad_and_nabla(x):
        Gt, GR = p.G_apply(x[0], x[1])
        nt, nR = Gt + g_t, GR + g_R
        return (nt, proj_tangent(x[1], nR, p.kernels)), (nt, nR)

    def hess_vp(x, nabla, v):
        # G is linear, so G_apply(v) is the Euclidean Hessian action.
        Ht, HR = p.G_apply(v[0], v[1])
        HR = HR - sym_block_diag_product(v[1], x[1], nabla[1], p.kernels)
        return Ht, proj_tangent(x[1], HR, p.kernels)

    def precondition(x, v):
        return (p._precondition_t_seg(v[0]),
                proj_tangent(x[1], p.precondition_R_seg(v[1]), p.kernels))

    def retract(x, h):
        return x[0] + h[0], project_sod(x[1] + h[1], p.kernels)

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract)


def _make_tnt_model_dense(p: NodeProblem, g_t, g_Q, t_anchor, anchor,
                          tnt_params: TNTParams, precon: str = "dense",
                          syncs: HostSyncs | None = None) -> TNTModel:
    """Dense TNT model in tall Q-storage (variable (t, Q [N, n d, d])),
    preconditioned by the regularized reduced-Hessian inverse ("dense"),
    the block-Jacobi blocks ("jacobi") or nothing ("none").

    `anchor` = (z_t, z_Q, fobj): the objective is the f32-stable relative
    form against the MM anchor (evaluate_G_tall_rel)."""
    p._dense_only("the dense TNT model")
    z_t, z_Q, fobj = anchor

    def objective(x):
        return p.evaluate_G_tall_rel(x[0], x[1], z_t, z_Q, g_t, g_Q, fobj)

    def grad_and_nabla(x):
        nabla = p.reduced_grad_tall(x[0], x[1], g_Q)
        return p.proj_tall(x[1], nabla), nabla

    def hess_vp(x, nabla, v):
        return p.hessian_vp_tall(x[1], nabla, v)

    if precon == "none":
        def precondition(x, v):
            return v
    elif precon == "jacobi":
        def precondition(x, v):
            return p.precondition_tall_jacobi(x[1], v)
    else:
        def precondition(x, v):
            return p.precondition_tall(x[1], v)

    def retract(x, h):
        N = h.shape[0]
        Qb = (x[1] + h).reshape(N, -1, p.d, p.d)
        Q_new = project_sod(Qb, p.kernels).reshape(x[1].shape)
        return p.recover_translations_tall(Q_new, g_t, t_anchor), Q_new

    # Fused single-launch STPCG (kernel K1) behind its Hopper gate, with
    # the dense preconditioner it streams.
    fused = None
    if precon == "dense" and p.fused_stpcg_supported():
        fkern = stpcg_fused if p.kernels else stpcg_fused_reference

        def fused(x, nabla, grad, pgrad, Delta, active):
            Q = x[1]
            return fkern(p.Hred_d, p.precon_dense, grad.contiguous(),
                         pgrad.contiguous(), Q.contiguous(),
                         _curvature_blocks(Q, nabla, p.kernels),
                         Delta.contiguous(),
                         active.contiguous(),
                         max_iters=tnt_params.max_tCG_iterations,
                         kappa_fgr=tnt_params.kappa_fgr,
                         theta=tnt_params.theta, syncs=syncs)

    return TNTModel(objective=objective, grad_and_nabla=grad_and_nabla,
                    hess_vp=hess_vp, precondition=precondition,
                    retract=retract, fused_stpcg=fused)


def _curvature_blocks(Q, nabla, kernel: bool):
    """K1's curvature blocks sym(Q_p nabla_p^T) in tall storage [N, nd, d]
    (the block products through kernel K3 where `kernel` holds)."""
    N, nd, d = Q.shape
    Sb = block_mm(Q.reshape(N, -1, d, d),
                  nabla.reshape(N, -1, d, d).transpose(-1, -2), kernel)
    return (0.5 * (Sb + Sb.transpose(-1, -2))).reshape(N, nd, d)


def stpcg_inputs(p: NodeProblem, st: MMState):
    """K1's operator and vector arguments (Hred, precon, grad, preconditioned
    grad, Q, S) for every node of problems `p` at the anchor of state `st`,
    built as the dense TNT model builds them; for holding the kernel against
    its plain version at a solver's shapes."""
    p._dense_only("stpcg_inputs")
    Q = p.to_tall(st.Z.R).contiguous()
    nabla = p.reduced_grad_tall(st.Z.t, Q, p.to_tall(st.g_R))
    grad = p.proj_tall(Q, nabla).contiguous()
    pgrad = p.precondition_tall(Q, grad).contiguous()
    return (p.Hred_d, p.precon_dense, grad, pgrad, Q,
            _curvature_blocks(Q, nabla, p.kernels))


def resolve_preconditioner(probs: NodeProblem, opts: MMOptions) -> str:
    """The STPCG preconditioner the options name; None is "dense" on the
    dense operator path and "jacobi" off it."""
    kind = opts.preconditioner
    if kind is None:
        return "dense" if probs.dense else "jacobi"
    if kind not in ("none", "jacobi", "dense"):
        raise ValueError(f"unknown preconditioner {kind!r}")
    if kind == "dense" and not probs.dense:
        raise ValueError("preconditioner='dense' needs the dense operator "
                         "path (raise dense_limit)")
    return kind


def _tnt_batch(probs: NodeProblem, t0, R0, g_t, g_R, params: TNTParams,
               t_anchor, anchor, precon: str = "dense",
               syncs: HostSyncs | None = None, lanes=None,
               record: bool = False):
    """Batched TNT with the model of the problems' regime (dense, coupled
    on the segment path, else R-space); returns (t, R, G value at result),
    plus the TNTHistory when `record=True`."""
    if probs.dense:
        anchor = (anchor[0], probs.to_tall(anchor[1]), anchor[2])
        model = _make_tnt_model_dense(probs, g_t, probs.to_tall(g_R),
                                      t_anchor, anchor, params, precon=precon,
                                      syncs=syncs)
        out = tnt_generic(model, (t0, probs.to_tall(R0)), params,
                          syncs=syncs, lanes=lanes, record=record)
        x = (out[0][0], probs.from_tall(out[0][1]))
    else:
        if probs.seg:
            model = _make_tnt_model_coupled(probs, g_t, g_R, anchor)
        else:
            model = _make_tnt_model(probs, g_t, g_R, None, t_anchor, precon,
                                    anchor=anchor, syncs=syncs)
        out = tnt_generic(model, (t0, R0), params, syncs=syncs, lanes=lanes,
                          record=record)
        x = out[0]
    return (x[0], x[1], out[1]) + ((out[4],) if record else ())


def _masked_tnt(probs, t0, R0, g_t, g_R, mask, params: TNTParams,
                fallback_G, syncs: HostSyncs, t_anchor, anchor,
                precon: str = "dense"):
    """Run batched TNT only if any node needs it (`device_cond`); select
    per node by mask. Returns (t, R, G value at result)."""
    if params.max_iterations <= 0 or params.max_iterations_accepted <= 0:
        return t0, R0, fallback_G

    def refine():
        tn, Rn, fx = _tnt_batch(probs, t0, R0, g_t, g_R, params, t_anchor,
                                anchor, precon=precon, syncs=syncs,
                                lanes=mask)
        return (sel(mask, tn, t0), sel(mask, Rn, R0),
                torch.where(mask, fx, fallback_G))

    return device_cond(mask.any(), refine, lambda: (t0, R0, fallback_G),
                       syncs=syncs)


def refine_probe(probs: NodeProblem, st: MMState, opts: MMOptions,
                 syncs: HostSyncs | None = None):
    """Re-run the AMM step's TNT refinement for the current state with
    per-outer-iteration recording (the reference's TNTResult series): the
    profiling window into the refined path's cost.

    Replays iterate_amm's extrapolation and proximal step to rebuild the
    TNT inputs of the next step, then runs the batched TNT with record=True
    for ALL nodes (ignoring the refinement gate, which is returned so the
    caller can mask). Returns (refined_mask [N] bool, TNTHistory with a
    leading node axis). Diagnostic only, not on the step's path."""
    syncs = syncs or HostSyncs()
    gamma = st.gamma

    def extrap(cur, prev):
        g = gamma.reshape((-1,) + (1,) * (cur.dim() - 1))
        return cur + g * (cur - prev)

    Y = NodeState(t=extrap(st.Z.t, st.Z_prev.t), R=extrap(st.Z.R, st.Z_prev.R),
                  th=extrap(st.Z.th, st.Z_prev.th),
                  Rh=extrap(st.Z.Rh, st.Z_prev.Rh))
    if probs.loss is Loss.TRIVIAL:
        g_t_ex = extrap(st.g_t, st.g_t_prev)
        g_R_ex = extrap(st.g_R, st.g_R_prev)
        Df_t_ex = extrap(st.Df_t, st.Df_t_prev)
        Df_R_ex = extrap(st.Df_R, st.Df_R_prev)
    else:
        g_t_ex, g_R_ex = probs.surrogate_g(Y)
        Df_t_ex, Df_R_ex = probs.euclidean_Df(Y, (g_t_ex, g_R_ex))

    refined = (((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
               | (st.num_osc >= opts.max_oscillations))
    _, th_R = probs.proximal(Y, (Df_t_ex, Df_R_ex))
    t_c = probs.recover_translations(th_R, g_t_ex, Y.t, syncs)

    params = opts.tnt
    if params.max_iterations <= 0:
        params = dataclasses.replace(params, max_iterations=10)
    *_, hist = _tnt_batch(probs, t_c, th_R, g_t_ex, g_R_ex, params,
                          t_anchor=Y.t, anchor=(st.Z.t, st.Z.R, st.fobj),
                          precon=resolve_preconditioner(probs, opts),
                          syncs=syncs, record=True)
    return refined, hist


# -------------------------------------------------------------------- iterate


def _anchor_residuals_batch(probs: NodeProblem, st: MMState):
    """Anchor residuals at Z, cached in the state by update_state (which
    evaluates the same Z at the end of the previous step)."""
    return ((st.z_rt, st.z_rR), (st.z_us, st.z_Es))


def _eval_G_batch(probs: NodeProblem, st: MMState, t, R, zres):
    """G(X|Z) for candidate own states X, in the f32-stable relative form
    anchored at the current state's (Z, fobj, g)."""
    return probs.evaluate_G_rel(st.Z.t, st.Z.R, t, R, (st.g_t, st.g_R),
                                st.fobj, zres=zres)


def _eval_G_pair_batch(probs: NodeProblem, st: MMState, t1, t2, R, zres):
    """(G(t1, R | Z), G(t2, R | Z)) with the rotation work shared."""
    return probs.evaluate_G_rel_pair(st.Z.t, st.Z.R, t1, t2, R,
                                     (st.g_t, st.g_R), st.fobj, zres)


def iterate_amm(probs: NodeProblem, st: MMState, opts: MMOptions, k: int,
                syncs: HostSyncs | None = None) -> MMState:
    """One AMM-PGO# iteration for all nodes (DPGOHash::amm_pgo). Under
    dynamic rescale `probs` are the reweighted problems
    (`reweighted_problems`)."""
    _check_supported(probs, opts)
    syncs = syncs or HostSyncs()
    gamma = st.gamma

    def extrap(cur, prev):
        g = gamma.reshape((-1,) + (1,) * (cur.dim() - 1))
        return cur + g * (cur - prev)

    # Nesterov extrapolation of the full Z; (g, Df) extrapolate linearly for
    # the trivial loss and are re-evaluated at Y for robust kernels
    # (DPGOHash.cpp:250-266).
    Y = NodeState(t=extrap(st.Z.t, st.Z_prev.t), R=extrap(st.Z.R, st.Z_prev.R),
                  th=extrap(st.Z.th, st.Z_prev.th),
                  Rh=extrap(st.Z.Rh, st.Z_prev.Rh))
    if probs.loss is Loss.TRIVIAL:
        g_t_ex = extrap(st.g_t, st.g_t_prev)
        g_R_ex = extrap(st.g_R, st.g_R_prev)
        Df_t_ex = extrap(st.Df_t, st.Df_t_prev)
        Df_R_ex = extrap(st.Df_R, st.Df_R_prev)
    else:
        g_t_ex, g_R_ex = probs.surrogate_g(Y)
        Df_t_ex, Df_R_ex = probs.euclidean_Df(Y, (g_t_ex, g_R_ex))

    tnt_off = (opts.tnt.max_iterations <= 0
               or opts.tnt.max_iterations_accepted <= 0)
    refined = (((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
               | (st.num_osc >= opts.max_oscillations))
    if tnt_off:
        refined = torch.zeros_like(refined)
    precon_kind = resolve_preconditioner(probs, opts)

    # Proximal step from the extrapolated point (Xakh).
    th_t, th_R = probs.proximal(Y, (Df_t_ex, Df_R_ex))
    zres = _anchor_residuals_batch(probs, st)

    diff_t = th_t - st.Z.t
    diff_R = th_R - st.Z.R
    minG = st.Fk0 - opts.psi * (_nsum(diff_t * diff_t)
                                + _nsum(diff_R * diff_R))

    # Candidate Xak: proximal rotations + translations re-solved with the
    # extrapolated g.
    t_c = probs.recover_translations(th_R, g_t_ex, Y.t, syncs)
    if tnt_off:
        # Xakh and Xak share rotations: one fused pair evaluation.
        Gkh, Gk = _eval_G_pair_batch(probs, st, th_t, t_c, th_R, zres)
        Xak_t, Xak_R = t_c, th_R
    else:
        Gkh = _eval_G_batch(probs, st, th_t, th_R, zres)
        Xak_t, Xak_R, _ = _masked_tnt(probs, t_c, th_R, g_t_ex, g_R_ex,
                                      refined, opts.tnt, Gkh, syncs,
                                      t_anchor=Y.t,
                                      anchor=(st.Z.t, st.Z.R, st.fobj),
                                      precon=precon_kind)
        Gk = _eval_G_batch(probs, st, Xak_t, Xak_R, zres)

    # Exceptional-path cascade (DPGOHash.cpp:386-441) in three stages (retry
    # / restart / phi-test), each skipped when no node fires it
    # (`device_cond`). A skipped stage equals the fired stage with all-false
    # flags.
    need_retry = Gkh > minG
    hard = Gk > st.Fk0
    soft = ((Gk > st.Fk1) & (st.hits0 >= opts.max_soft_restart_hits0)) | \
           ((Gk > st.fobj) & (st.hits1 > opts.max_soft_restart_hits1))
    restart = hard | soft

    # Retry the un-extrapolated proximal if Gkh is insufficient.
    def retry():
        tp_t, tp_R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
        Gkp = _eval_G_batch(probs, st, tp_t, tp_R, zres)
        return (sel(need_retry, tp_R, th_R),
                torch.where(need_retry, Gkp, Gkh))

    Xakh_R, Gkh2 = device_cond(need_retry.any(), retry,
                               lambda: (th_R, Gkh), syncs=syncs)

    def restarted():
        # Restart candidate: Xakh if good enough, else the un-extrapolated
        # proximal; translations from the non-extrapolated g.
        tp_t, tp_R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
        good = Gkh2 <= st.fobj
        r_R = sel(good, Xakh_R, tp_R)
        r_t = probs.recover_translations(r_R, st.g_t, st.Z.t, syncs)
        r_G = _eval_G_batch(probs, st, r_t, r_R, zres)
        # Nodes with restart & refined get TNT refinement; restart &
        # ~refined keep the evaluated proximal value.
        rt_t, rt_R, _ = _masked_tnt(
            probs, r_t, r_R, st.g_t, st.g_R, restart & refined, opts.tnt,
            r_G, syncs, t_anchor=st.Z.t, anchor=(st.Z.t, st.Z.R, st.fobj),
            precon=precon_kind)
        Gk_restart = _eval_G_batch(probs, st, rt_t, rt_R, zres)
        return (sel(restart, rt_t, Xak_t), sel(restart, rt_R, Xak_R),
                torch.where(restart, Gk_restart, Gk))

    Xk_t2, Xk_R2, Gk2 = device_cond(restart.any(), restarted,
                                    lambda: (Xak_t, Xak_R, Gk), syncs=syncs)

    # phi-test: fall back to the proximal iterate Xakh if the refined step
    # made insufficient progress relative to it.
    use_h = (st.Fk0 - Gk2) < opts.phi * (st.Fk0 - Gkh2)

    def phi_fallback():
        g_sel_t = sel(restart, st.g_t, g_t_ex)
        t_sel = sel(restart, st.Z.t, Y.t)
        phi_t = probs.recover_translations(Xakh_R, g_sel_t, t_sel, syncs)
        t2 = sel(use_h, phi_t, Xk_t2)
        R2 = sel(use_h, Xakh_R, Xk_R2)
        return t2, R2, torch.where(use_h, _eval_G_batch(probs, st, t2, R2,
                                                        zres), Gk2)

    Xak_t2, Xak_R2, Gk_f = device_cond(use_h.any(), phi_fallback,
                                       lambda: (Xk_t2, Xk_R2, Gk2),
                                       syncs=syncs)

    s_next = torch.where(hard, torch.clamp(0.5 * st.s_next, min=1.0),
                         st.s_next)
    hits0 = torch.where(restart, st.hits0 // 3, st.hits0)
    hits1 = torch.where(restart, 0, st.hits1).to(torch.int32)

    # Stamp: Z_prev <- Z, Z.own <- Xak (halo refreshed by communicate()).
    Z_new = NodeState(t=Xak_t2, R=Xak_R2, th=st.Z.th, Rh=st.Z.Rh)
    return st.replace(Z=Z_new, Z_prev=st.Z, Gk=Gk_f, s_next=s_next,
                      hits0=hits0, hits1=hits1)


def iterate_mm(probs: NodeProblem, st: MMState, opts: MMOptions, k: int,
               syncs: HostSyncs | None = None) -> MMState:
    """One plain MM-PGO iteration for all nodes (DPGOHash::mm_pgo): the
    proximal step from Z, translations re-solved, TNT refinement where the
    gradient gate asks for it."""
    _check_supported(probs, opts)
    syncs = syncs or HostSyncs()
    refined = ((st.gradFnorm * st.gradFnorm / st.fobj) > opts.accepted_delta)
    if opts.tnt.max_iterations <= 0 or opts.tnt.max_iterations_accepted <= 0:
        refined = torch.zeros_like(refined)

    th_t, th_R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
    t_c = probs.recover_translations(th_R, st.g_t, st.Z.t, syncs)
    zres = _anchor_residuals_batch(probs, st)
    G0 = _eval_G_batch(probs, st, t_c, th_R, zres)
    Xak_t, Xak_R, _ = _masked_tnt(probs, t_c, th_R, st.g_t, st.g_R, refined,
                                  opts.tnt, G0, syncs, t_anchor=st.Z.t,
                                  anchor=(st.Z.t, st.Z.R, st.fobj),
                                  precon=resolve_preconditioner(probs, opts))
    Gk = _eval_G_batch(probs, st, Xak_t, Xak_R, zres)

    Z_new = NodeState(t=Xak_t, R=Xak_R, th=st.Z.th, Rh=st.Z.Rh)
    return st.replace(Z=Z_new, Z_prev=st.Z, Gk=Gk)


def iterate_aa(probs: NodeProblem, st: MMState, opts: MMOptions, k: int,
               syncs: HostSyncs | None = None) -> MMState:
    """One safeguarded Anderson-accelerated MM iteration for all nodes.

    The MM loop is the fixed-point iteration X <- T(X), T = per-node
    closed-form surrogate minimization + halo exchange. Anderson
    acceleration (type II) keeps the last `aa_window` steps: with residuals
    r_j = T(X_j) - X_j it solves theta = argmin |r_k - dRhist theta| per
    node and extrapolates X+ = T(X_k) - (dXhist + dRhist) theta. No
    reference analog (the reference's only extrapolation is Nesterov,
    DPGOHash.cpp:258-266). The history is a fixed [m, D] ring buffer per
    node and the solve one m x m SPD system per node, factored with
    `cholesky_ex` (no error flag is read back).

    Safeguard ("monotone"): accept the Anderson candidate only where its
    surrogate value G(X_aa | Z) does not exceed the anchor objective
    F^a(Z) = G(Z|Z); otherwise keep the plain proximal step. Since
    sum_a G_a(X_a|Z) >= f(X), the accepted global objective decreases
    monotonically. The step reads nothing back to the host."""
    _check_supported(probs, opts)
    syncs = syncs or HostSyncs()
    # Plain MM candidate from the anchor: T(X_k) own block (iterate_mm's
    # proximal path, no TNT).
    _, th_R = probs.proximal(st.Z, (st.Df_t, st.Df_R))
    t_c = probs.recover_translations(th_R, st.g_t, st.Z.t, syncs)

    xT = _flat_own(t_c, th_R)
    x = _flat_own(st.Z.t, st.Z.R)
    r = xT - x

    # Push (x - x_prev, r - r_prev) into the ring buffers (newest last); the
    # slot is zero when there is no previous point yet.
    have = (st.aa_count > 0)[:, None]
    dx_new = torch.where(have, x - st.aa_x_prev, 0.0)
    dr_new = torch.where(have, r - st.aa_r_prev, 0.0)
    dX = torch.cat([st.aa_dX[:, 1:], dx_new[:, None]], dim=1)
    dR = torch.cat([st.aa_dR[:, 1:], dr_new[:, None]], dim=1)

    # Column-normalized regularized normal equations: empty slots have zero
    # norm -> unit scale, zero Gram row + lambda I diagonal -> theta_i = 0.
    nrm = torch.sqrt((dR * dR).sum(-1))                          # [N, m]
    scale = torch.where(nrm > 0, nrm, 1.0)
    dRn = dR / scale[..., None]
    gram = dRn @ dRn.transpose(-1, -2)
    rhs = (dRn @ r[..., None])                                   # [N, m, 1]
    m = gram.shape[-1]
    lam = opts.aa_reg + torch.finfo(gram.dtype).eps
    gram = gram + lam * torch.eye(m, dtype=gram.dtype, device=gram.device)
    chol, _ = torch.linalg.cholesky_ex(gram)
    # Two triangular solves (cholesky_solve's MAGMA route cannot be
    # captured in a CUDA graph).
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    theta = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0] \
        / scale

    x_aa = xT - (theta[:, None, :] @ (dX + dR))[:, 0]
    t_aa, R_raw = _unflat_own(x_aa, st.Z.t, st.Z.R)
    R_aa = project_sod(R_raw, probs.kernels)
    if opts.aa_resolve_t:
        t_aa = probs.recover_translations(R_aa, st.g_t, st.Z.t, syncs)

    zres = _anchor_residuals_batch(probs, st)
    G_aa = _eval_G_batch(probs, st, t_aa, R_aa, zres)
    if opts.aa_safeguard == "monotone":
        G_prox = _eval_G_batch(probs, st, t_c, th_R, zres)
        accept = G_aa <= st.fobj
    else:
        G_prox = G_aa
        accept = torch.ones_like(st.aa_count, dtype=torch.bool)

    Z_new = NodeState(t=sel(accept, t_aa, t_c), R=sel(accept, R_aa, th_R),
                      th=st.Z.th, Rh=st.Z.Rh)
    return st.replace(
        Z=Z_new, Z_prev=st.Z, Gk=torch.where(accept, G_aa, G_prox),
        aa_dX=dX, aa_dR=dR, aa_x_prev=x, aa_r_prev=r,
        aa_count=torch.clamp(st.aa_count + 1, max=2 ** 30).to(torch.int32))
