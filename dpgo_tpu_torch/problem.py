"""Per-node MM surrogate problem (torch port of dpgo_tpu/problem.py).

Every tensor carries a leading node axis N (the JAX package vmaps one node's
problem over a stack; here the batch dimension is written out). Edge-wise
operators are gather -> batched 3x3 products -> `index_add_` scatters.

Notation (see ARCHITECTURE.md): per inter-node edge e the residual splits as
r_e = A_self x_self + A_other x_other. The per-node surrogate around anchor Z:

    G^a(X|Z) = 1/2 <G X, X> + <g, X> + f
    <G X, X> = sum_intra |r_e(X)|^2 + 2 sum_inter |A_self x_self|^2 + xi |X|^2
    g        = sum_inter A_self^T (A_other z_other - A_self z_self) - xi z_a
    f        = 1/4 sum_inter |A_self z_self - A_other z_other|^2
               + xi/2 |z_a|^2

Rotations are stored as true rotation matrices [N, n, d, d]; the dense
operators act on tall Q-storage (Q = R^T blocks stacked, [N, n d, d]).

Three regimes by the size of the largest node block (n0 poses), chosen by
`build_node_problems` as the JAX package chooses them:

- dense (n0 d <= dense_limit, 4096): the G blocks and the reduced operator
  Hred are dense matrices, TNT runs in tall storage with the dense
  preconditioner, and kernel K1 streams Hred and its regularized inverse.
- edge-wise (n0 d above dense_limit, n0 <= segment_limit, 2048): no
  [n0 d, n0 d] array; the G operators are matrix-free, the translation
  solve keeps the eigen-split inverse `Minv_red`, TNT runs the R-space model
  with the block-Jacobi preconditioner.
- segment (n0 above segment_limit): no [n0, n0] array either. Translation
  solves run CG on `mG00_matvec` with a two-level additive-Schwarz
  preconditioner over contiguous segments of `seg_size` poses; TNT runs on
  the coupled (t, R) variable with segment-dense regularized mG11 inverses.

A field a regime does not build is a placeholder of shape [N, 1, 1] (or
[N, 1, 1, 1], [N, 1]), as in the JAX package; the methods that need it raise
on a problem without it. Every loss kernel and both rescale modes run in all
three regimes: `with_weights` rebuilds the dense images (and the Hred that
kernel K1 streams) only on the dense path, and on the segment path the CG
matvec reads the rescale weights directly (no Woodbury core).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpgo_tpu_torch.graph import MultiGraph, node_range
from dpgo_tpu_torch.losses import Loss, loss_value, loss_weight
from dpgo_tpu_torch.manifold import (block_mm, block_mv, proj_tangent,
                                     project_sod, sym_block_diag_product)
from dpgo_tpu_torch.ops import stpcg_cuda
from dpgo_tpu_torch.ops.stpcg import sel
from dpgo_tpu_torch.utils import (HostSyncs, bounded_while, resolve_device,
                                  span, sync)


def _nsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over everything but the leading node axis: [N, ...] -> [N]."""
    return x.reshape(x.shape[0], -1).sum(1)


def _edge_sq(u: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Per-edge |u|^2 + |E|_F^2: [N, m, d], [N, m, d, d] -> [N, m]."""
    return torch.sum(u * u, -1) + torch.sum(E * E, (-1, -2))


@dataclasses.dataclass
class NodeState:
    """Own + halo pose state of every node (leading node axis)."""

    t: torch.Tensor    # [N, n0, d] own translations
    R: torch.Tensor    # [N, n0, d, d] own rotations
    th: torch.Tensor   # [N, n1, d] halo translations
    Rh: torch.Tensor   # [N, n1, d, d] halo rotations

    def __sub__(self, other: "NodeState") -> "NodeState":
        return NodeState(t=self.t - other.t, R=self.R - other.R,
                         th=self.th - other.th, Rh=self.Rh - other.Rh)

    def own(self):
        return self.t, self.R

    def with_own(self, t, R) -> "NodeState":
        return NodeState(t=t, R=R, th=self.th, Rh=self.Rh)


# Array fields of NodeProblem, in the JAX package's names.
ARRAY_FIELDS = (
    "pose_mask", "diagT_inv", "nvec", "W", "Minv_red", "null_V",
    "precon_inv", "mG00_d",
    "mG01_d", "mG11_d", "Hred_d", "precon_dense",
    "scale_w", "ipose", "imask", "SU", "wood_C",
    "a_i", "a_j", "a_R", "a_t", "a_kap", "a_tau",
    "e_self", "e_slot", "e_self_is_i", "e_R", "e_t", "e_kap", "e_tau",
    "seg_t_inv", "seg_c_inv", "seg_R_inv", "seg_diag", "seg_blk", "seg_row",
    "seg_col")
INDEX_FIELDS = ("a_i", "a_j", "e_self", "e_slot", "ipose", "seg_row",
                "seg_col")
BOOL_FIELDS = ("pose_mask", "e_self_is_i", "imask")


@dataclasses.dataclass
class NodeProblem:
    """Precomputed problem data of all N nodes (leading node axis)."""

    d: int
    xi: float
    loss: Loss
    loss_reg: float
    dense: bool
    # Dynamic rescale: the problem carries persisted surrogate weights
    # scale_w != 1 (set by with_weights). False: scale_w is all ones.
    dynamic: bool

    pose_mask: torch.Tensor   # [N, n0] bool
    diagT_inv: torch.Tensor   # [N, n0] T = 1/DiagT
    nvec: torch.Tensor        # [N, n0, d]
    W: torch.Tensor           # [N, n0, d, d] aux rotation blocks (right-mult)
    # Split inverse of the translation block mG00 = L + xi I:
    # mG00^{-1} rhs = Minv_red rhs + null_V (null_V^T rhs) / xi.
    Minv_red: torch.Tensor    # [N, n0, n0]
    null_V: torch.Tensor      # [N, n0, kmax]
    # Regularized block-Jacobi preconditioner: per-pose inverses of the
    # mG11 diagonal blocks + (lambda_max(mG11) / precon_cond) I.
    precon_inv: torch.Tensor  # [N, n0, d, d]
    mG00_d: torch.Tensor      # [N, n0, n0]
    mG01_d: torch.Tensor      # [N, n0, n0 d]
    mG11_d: torch.Tensor      # [N, n0 d, n0 d]
    # Reduced (t-eliminated) rotation operator
    # Hred = mG11 - mG10 mG00^{-1} mG01, and the dense regularized
    # preconditioner (Hred + (lambda_max/cond) I)^{-1}: the two operators
    # kernel K1 streams.
    Hred_d: torch.Tensor        # [N, n0 d, n0 d]
    precon_dense: torch.Tensor  # [N, n0 d, n0 d]

    # Dynamic rescale: per-inter-edge surrogate weights w_bar (the
    # quadratic surrogate's inter terms scale by w_bar, residuals keep unit
    # measurement weights), and the Woodbury correction of the translation
    # solve for the diagonal weight delta at the poses with inter edges.
    scale_w: torch.Tensor     # [N, m1] in [min_rescale, 1]
    ipose: torch.Tensor       # [N, kmax] poses with inter edges (pad 0)
    imask: torch.Tensor       # [N, kmax] bool
    SU: torch.Tensor          # [N, n0, kmax] base-inverse columns at ipose
    wood_C: torch.Tensor      # [N, kmax, kmax] Woodbury core (with_weights)

    # Intra edges.
    a_i: torch.Tensor
    a_j: torch.Tensor
    a_R: torch.Tensor
    a_t: torch.Tensor
    a_kap: torch.Tensor
    a_tau: torch.Tensor

    # Inter edges.
    e_self: torch.Tensor
    e_slot: torch.Tensor
    e_self_is_i: torch.Tensor
    e_R: torch.Tensor
    e_t: torch.Tensor
    e_kap: torch.Tensor
    e_tau: torch.Tensor

    # Segment path (blocks above segment_limit poses; [N, 1, ...]
    # placeholders otherwise): dense factors over contiguous segments of
    # S = seg_size poses, n_seg = ceil(n0 / S) per node.
    seg_t_inv: torch.Tensor   # [N, n_seg, S, S] clamped inverses of mG00's
    #                           segment-diagonal blocks
    seg_c_inv: torch.Tensor   # [N, n_seg, n_seg] coarse Galerkin inverse
    seg_R_inv: torch.Tensor   # [N, n_seg, S d, S d] regularized inverses of
    #                           mG11's segment-diagonal blocks
    # Block image of mG00 for the CG matvec: the segment-diagonal blocks
    # (before inversion) and the off-diagonal segment-pair blocks with their
    # block row and column.
    seg_diag: torch.Tensor    # [N, n_seg, S, S]
    seg_blk: torch.Tensor     # [N, npair, S, S]
    seg_row: torch.Tensor     # [N, npair]
    seg_col: torch.Tensor     # [N, npair]

    # Route the SO(3) projections, the fused STPCG and the d x d block
    # products through the CUDA kernels; False runs their plain torch
    # versions on any device (the kernel-vs-plain comparison on the card).
    kernels: bool = True

    seg: bool = False
    seg_size: int = 128
    # Cap and relative tolerance (against |rhs|) of the translation CG.
    seg_cg_iters: int = 20
    seg_cg_tol: float = 1e-7

    def __post_init__(self):
        N = self.pose_mask.shape[0]
        dev = self.pose_mask.device
        self._b = torch.arange(N, device=dev)[:, None]
        n0 = self._n0()
        # Flat scatter targets for index_add_ over [N * n0] pose rows.
        self._fi = (self.a_i + self._b * n0).reshape(-1)
        self._fj = (self.a_j + self._b * n0).reshape(-1)
        self._fs = (self.e_self + self._b * n0).reshape(-1)
        self._sel = self.e_self_is_i[..., None]
        self._selm = self.e_self_is_i[..., None, None]
        # Flat block rows of the segment matvec's scatter.
        self._frow = (self.seg_row
                      + self._b * self.seg_diag.shape[1]).reshape(-1)

    # ---------------------------------------------------------------- helpers

    def _n0(self):
        return self.pose_mask.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.pose_mask.shape[0]

    def fused_stpcg_supported(self) -> bool:
        """The Hopper gate of kernel K1 (replacing the TPU's fits_vmem):
        dense path, d = 2 or 3, float32, on a CUDA device."""
        return self.dense and stpcg_cuda.supported(
            self.d, self.Hred_d.dtype, self.Hred_d.device)

    def _dense_only(self, what: str):
        if not self.dense:
            raise ValueError(f"{what} needs the dense operator images, which "
                             "this problem (edge-wise or segment path) does "
                             "not build")

    def _g(self, x, idx):
        """Per-node gather x[a, idx[a]]: [N, n, ...], [N, m] -> [N, m, ...]"""
        return x[self._b, idx]

    def _mm(self, A, B):
        """Per-block A_i B_i of [N, m, d, d] stacks (kernel K3 where
        `kernels` holds)."""
        return block_mm(A, B, self.kernels)

    def _mv(self, A, v):
        """Per-block A_i v_i: [N, m, d, d] x [N, m, d] -> [N, m, d]."""
        return block_mv(A, v, self.kernels)

    def _scatter(self, flat_idx, vals):
        """Per-node scatter-add of vals [N, m, ...] into [N, n0, ...]."""
        N, n0 = self.num_nodes, self._n0()
        tail = vals.shape[2:]
        out = vals.new_zeros((N * n0,) + tail)
        out.index_add_(0, flat_idx, vals.reshape((-1,) + tail))
        return out.reshape((N, n0) + tail)

    def intra_residuals(self, t, R):
        """Intra-edge residuals (sqrt-weighted): r_t [N, m0, d],
        r_R [N, m0, d, d]."""
        Ri = self._g(R, self.a_i)
        rt = self._g(t, self.a_i) + self._mv(Ri, self.a_t) \
            - self._g(t, self.a_j)
        rR = self._mm(Ri, self.a_R) - self._g(R, self.a_j)
        return (torch.sqrt(self.a_tau)[..., None] * rt,
                torch.sqrt(self.a_kap)[..., None, None] * rR)

    def inter_halves(self, state: NodeState):
        """Per inter-edge (A_self x_self) and (A_other x_other) residual
        halves, each a (u [N, m1, d], E [N, m1, d, d]) pair."""
        st = torch.sqrt(self.e_tau)[..., None]
        sk = torch.sqrt(self.e_kap)[..., None, None]
        to = self._g(state.th, self.e_slot)
        Ro = self._g(state.Rh, self.e_slot)
        u_s, E_s = self._self_half(state.t, state.R)
        u_o = torch.where(self._sel, -st * to,
                          st * (to + self._mv(Ro, self.e_t)))
        E_o = torch.where(self._selm, -sk * Ro, sk * self._mm(Ro, self.e_R))
        return (u_s, E_s), (u_o, E_o)

    def apply_A_self_T(self, u, E):
        """Scatter A_self^T (u, E) into own (t, R) gradient space."""
        st = torch.sqrt(self.e_tau)[..., None]
        sk = torch.sqrt(self.e_kap)[..., None, None]
        # tail: dt = st u ; dR = st u t~^T + sk E R~^T
        # head: dt = -st u ; dR = -sk E
        dt = torch.where(self._sel, st * u, -st * u)
        dR = torch.where(
            self._selm,
            st[..., None] * u[..., :, None] * self.e_t[..., None, :]
            + sk * self._mm(E, self.e_R.transpose(-1, -2)),
            -sk * E)
        return self._scatter(self._fs, dt), self._scatter(self._fs, dR)

    def _self_half(self, t, R):
        """(A_self x_self) per inter edge:
        self = tail(i): u = st (t_s + R_s t~), E = sk R_s R~;
        self = head(j): u = -st t_s,          E = -sk R_s."""
        st = torch.sqrt(self.e_tau)[..., None]
        sk = torch.sqrt(self.e_kap)[..., None, None]
        ts = self._g(t, self.e_self)
        Rs = self._g(R, self.e_self)
        u_s = torch.where(self._sel, st * (ts + self._mv(Rs, self.e_t)),
                          -st * ts)
        E_s = torch.where(self._selm, sk * self._mm(Rs, self.e_R), -sk * Rs)
        return u_s, E_s

    def _sw(self, x: torch.Tensor) -> torch.Tensor:
        """Per-inter-edge x [N, m1] scaled by the dynamic-rescale weights
        (all ones unless `dynamic`)."""
        return x * self.scale_w if self.dynamic else x

    def inter_weights(self, state: NodeState):
        """Per inter-edge robust IRLS weights and squared residuals at the
        state: (w, s) [N, m1]."""
        (u_s, E_s), (u_o, E_o) = self.inter_halves(state)
        s = _edge_sq(u_s + u_o, E_s + E_o)
        return loss_weight(self.loss, s, self.loss_reg), s

    # ------------------------------------------------------------ evaluations

    def local_fobj(self, state: NodeState) -> torch.Tensor:
        """Node objective F^a(Z) = 1/2 sum_intra |r|^2 + 1/4 sum_inter
        rho(|r|^2) (inter edges shared half-half between endpoints): [N]."""
        rt, rR = self.intra_residuals(state.t, state.R)
        (u_s, E_s), (u_o, E_o) = self.inter_halves(state)
        s = _edge_sq(u_s + u_o, E_s + E_o)
        return 0.5 * (_nsum(rt * rt) + _nsum(rR * rR)) \
            + 0.25 * _nsum(loss_value(self.loss, s, self.loss_reg))

    def surrogate_g_f_fobj(self, state: NodeState):
        g, f, fobj, _ = self.surrogate_g_f_fobj_res(state)
        return g, f, fobj

    def surrogate_g_f_fobj_res(self, state: NodeState):
        """(g, f, fobj, zres) with the residual halves computed once; zres =
        ((rt, rR), (u_s, E_s)) are the anchor residuals the next iterate's
        evaluate_G_rel calls reuse."""
        halves = self.inter_halves(state)
        (u_s, E_s), (u_o, E_o) = halves
        rt, rR = self.intra_residuals(state.t, state.R)
        s = _edge_sq(u_s + u_o, E_s + E_o)
        f_intra = 0.5 * (_nsum(rt * rt) + _nsum(rR * rR))
        zres = ((rt, rR), (u_s, E_s))
        if self.loss is Loss.TRIVIAL:
            g, f = self._g_f(state, halves)
            return g, f, f_intra + 0.25 * _nsum(s), zres
        g = self._robust_g(state, halves, s)
        fobj = f_intra + 0.25 * _nsum(loss_value(self.loss, s, self.loss_reg))
        # f makes the surrogate touch the node objective at the anchor:
        # F^a - 1/2 <G z, z> - <g, z>.
        f = fobj - 0.5 * self.G_quad(state.t, state.R) \
            - _nsum(g[0] * state.t) - _nsum(g[1] * state.R)
        return g, f, fobj, zres

    def surrogate_g_f(self, state: NodeState):
        """Linear term g = (g_t, g_R) and constant f of G^a(.|Z).

        g = A_self^T (w r - 2 w_bar A_self z_self) - xi z_a with w the IRLS
        weight at the anchor and w_bar the rescale weight; for the trivial
        loss (w = w_bar = 1) that is A_self^T (A_o z_o - A_s z_s) - xi z_a."""
        if self.loss is Loss.TRIVIAL:
            return self._g_f(state, self.inter_halves(state))
        g, f, _, _ = self.surrogate_g_f_fobj_res(state)
        return g, f

    def surrogate_g(self, state: NodeState):
        """The linear term g of G^a(.|Z) alone."""
        halves = self.inter_halves(state)
        if self.loss is Loss.TRIVIAL:
            return self._g_f(state, halves)[0]
        (u_s, E_s), (u_o, E_o) = halves
        return self._robust_g(state, halves, _edge_sq(u_s + u_o, E_s + E_o))

    def _robust_g(self, state: NodeState, halves, s):
        (u_s, E_s), (u_o, E_o) = halves
        w = loss_weight(self.loss, s, self.loss_reg)
        sw2 = 2.0 * self.scale_w
        g_t, g_R = self.apply_A_self_T(
            w[..., None] * (u_s + u_o) - sw2[..., None] * u_s,
            w[..., None, None] * (E_s + E_o) - sw2[..., None, None] * E_s)
        return g_t - self.xi * state.t, g_R - self.xi * state.R

    def G_quad(self, t, R):
        """<G X, X> for X = (t, R), the SPD surrogate quadratic form: [N]."""
        rt, rR = self.intra_residuals(t, R)
        u_s, E_s = self._self_half(t, R)
        return (_nsum(rt * rt) + _nsum(rR * rR)
                + 2.0 * _nsum(self.scale_w * _edge_sq(u_s, E_s))
                + self.xi * (_nsum(t * t) + _nsum(R * R)))

    def _g_f(self, state: NodeState, halves):
        (u_s, E_s), (u_o, E_o) = halves
        g_t, g_R = self.apply_A_self_T(u_o - u_s, E_o - E_s)
        g_t = g_t - self.xi * state.t
        g_R = g_R - self.xi * state.R
        du = u_s - u_o
        dE = E_s - E_o
        f = 0.25 * (_nsum(du * du) + _nsum(dE * dE)) \
            + 0.5 * self.xi * (_nsum(state.t * state.t)
                               + _nsum(state.R * state.R))
        return (g_t, g_R), f

    def anchor_residuals(self, zt, zR):
        """Residual halves at the anchor state, for reuse across the several
        evaluate_G_rel calls an iteration makes against the same Z."""
        return self.intra_residuals(zt, zR), self._self_half(zt, zR)

    def evaluate_G_rel(self, zt, zR, xt, xR, g, fobj,
                       zres=None) -> torch.Tensor:
        """Surrogate value G(X|Z) in RELATIVE form, anchored at the node
        objective: G(X|Z) = F^a(Z) + 1/2(<GX,X> - <GZ,Z>) + <g, X-Z>, with
        the quadratic difference expanded per edge as
        (q_e(X)-q_e(Z))(q_e(X)+q_e(Z)) (f32-stable: rounding scales with
        |X - Z|, not with the objective). `zres` = anchor_residuals(zt,
        zR), computed here when None."""
        def sq_diff(aX, aZ):
            return _nsum((aX - aZ) * (aX + aZ))

        if zres is None:
            zres = self.anchor_residuals(zt, zR)
        (rtZ, rRZ), (usZ, EsZ) = zres
        rtX, rRX = self.intra_residuals(xt, xR)
        dq = sq_diff(rtX, rtZ) + sq_diff(rRX, rRZ)
        usX, EsX = self._self_half(xt, xR)
        dq = dq + 2.0 * torch.sum(self._sw(
            torch.sum((usX - usZ) * (usX + usZ), -1)
            + torch.sum((EsX - EsZ) * (EsX + EsZ), (-1, -2))), -1)
        dq = dq + self.xi * (sq_diff(xt, zt) + sq_diff(xR, zR))
        g_t, g_R = g
        lin = _nsum(g_t * (xt - zt)) + _nsum(g_R * (xR - zR))
        return fobj + 0.5 * dq + lin

    def evaluate_G_rel_pair(self, zt, zR, t1, t2, xR, g, fobj, zres):
        """Two evaluate_G_rel values for candidates sharing the SAME
        rotations (the rotation-dependent residual work is computed once)."""
        def sq_diff(aX, aZ):
            return _nsum((aX - aZ) * (aX + aZ))

        (rtZ, rRZ), (usZ, EsZ) = zres
        Ri = self._g(xR, self.a_i)
        Ri_at = self._mv(Ri, self.a_t)
        rRX = torch.sqrt(self.a_kap)[..., None, None] * (
            self._mm(Ri, self.a_R) - self._g(xR, self.a_j))
        st = torch.sqrt(self.e_tau)[..., None]
        sk = torch.sqrt(self.e_kap)[..., None, None]
        Rs = self._g(xR, self.e_self)
        EsX = torch.where(self._selm, sk * self._mm(Rs, self.e_R), -sk * Rs)
        Rs_et = self._mv(Rs, self.e_t)
        dqR = sq_diff(rRX, rRZ) + self.xi * sq_diff(xR, zR) + 2.0 * torch.sum(
            self._sw(torch.sum((EsX - EsZ) * (EsX + EsZ), (-1, -2))), -1)
        g_t, g_R = g
        linR = _nsum(g_R * (xR - zR))
        sqrt_tau_a = torch.sqrt(self.a_tau)[..., None]

        def t_part(xt):
            rtX = sqrt_tau_a * (self._g(xt, self.a_i) + Ri_at
                                - self._g(xt, self.a_j))
            ts = self._g(xt, self.e_self)
            usX = torch.where(self._sel, st * (ts + Rs_et), -st * ts)
            dq = sq_diff(rtX, rtZ) + self.xi * sq_diff(xt, zt) \
                + 2.0 * torch.sum(
                    self._sw(torch.sum((usX - usZ) * (usX + usZ), -1)), -1)
            return dq + 2.0 * _nsum(g_t * (xt - zt))

        base = fobj + 0.5 * dqR + linR
        return base + 0.5 * t_part(t1), base + 0.5 * t_part(t2)

    def euclidean_Df(self, state: NodeState, g):
        """Local Euclidean gradient Df = G z_a + g (= nabla_a F(Z) for the
        trivial loss): through the dense operator images on the dense path,
        edge-wise (G_apply) otherwise."""
        if self.dense:
            Q = self.to_tall(state.R)
            Gt = self.mG00_d @ state.t + self.mG01_d @ Q
            GR = self.from_tall(self.mG01_d.transpose(-1, -2) @ state.t
                                + self.mG11_d @ Q)
        else:
            Gt, GR = self.G_apply(state.t, state.R)
        return Gt + g[0], GR + g[1]

    def riemannian_grad(self, state: NodeState, Df=None):
        """(grad_t, grad_R): Df with its rotation part projected onto the
        tangent space at the own rotations; Df defaults to the Euclidean
        gradient at `state`."""
        if Df is None:
            Df = self.euclidean_Df(state, self.surrogate_g(state))
        return Df[0], proj_tangent(state.R, Df[1], self.kernels)

    def q_gap(self, dstate: NodeState) -> torch.Tensor:
        """1/2 <Q dZ, dZ> = -1/4 sum_inter |A_tail dZ_tail - A_head dZ_head|^2
        - xi/2 |dZ_a|^2: the exact telescoping gap F^a(Z') - G^a(X'|Z) for
        the trivial loss."""
        (u_s, E_s), (u_o, E_o) = self.inter_halves(dstate)
        u = u_s - u_o
        E = E_s - E_o
        s = _nsum(u * u) + _nsum(E * E)
        return (-0.25 * s - 0.5 * self.xi *
                (_nsum(dstate.t * dstate.t) + _nsum(dstate.R * dstate.R)))

    def p_form(self, state: NodeState) -> torch.Tensor:
        """1/2 <P Z, Z> = -1/2 sum_intra |r|^2 - sum_inter <A_s z_s, A_o z_o>
        + xi/2 |z_a|^2: converts the telescoped fobj into the surrogate
        constant f = fobj + 1/2 <P Z, Z>."""
        rt, rR = self.intra_residuals(state.t, state.R)
        (u_s, E_s), (u_o, E_o) = self.inter_halves(state)
        cross = _nsum(u_s * u_o) + _nsum(E_s * E_o)
        return (-0.5 * (_nsum(rt * rt) + _nsum(rR * rR)) - cross
                + 0.5 * self.xi * (_nsum(state.t * state.t)
                                   + _nsum(state.R * state.R)))

    # ------------------------------------------------------------ proximal

    def proximal(self, state: NodeState, Df):
        """Closed-form minimizer of the auxiliary surrogate H^a(.|Z).

        C = Df_R - (N^T T) Df_t - W z_R ;  R+ = project(-C)
        t+ = z_t - T [nvec cross (R+ - z_R)] - T Df_t
        """
        Df_t, Df_R = Df
        z_t, z_R = state.t, state.R
        Tv = self.diagT_inv[..., None]
        # (N^T v)[p] = v_p nvec_p^T (outer product into R-space).
        NTv = (Tv * Df_t)[..., :, None] * self.nvec[..., None, :]
        C = Df_R - NTv - self._mm(z_R, self.W)
        R_new = project_sod(-C, self.kernels)
        dR = R_new - z_R
        t_new = z_t - Tv * self._mv(dR, self.nvec) - Tv * Df_t
        return t_new, R_new

    # ----------------------------------------- segment translation solves

    def _segments(self, x, width: int):
        """[N, n0 * width, c] -> [N, n_seg, S * width, c], zero-padded to
        whole segments."""
        N, rows = x.shape[0], self.seg_t_inv.shape[1] * self.seg_size * width
        if x.shape[1] < rows:
            x = torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))
        return x.reshape(N, -1, self.seg_size * width, x.shape[-1])

    def mG00_matvec(self, v):
        """The translation block mG00 applied to v [N, n0, d] through its
        segment-block image: batched [S, S] products with the diagonal
        blocks and the off-diagonal segment pairs, one `index_add_` over
        block rows, and under dynamic rescale the inter diagonal delta
        2 (w_bar - 1) tau edge-wise. Equal to the dense build's mG00 (intra
        Laplacian, inter diagonal 2 w_bar tau, xi on real poses and 1 on
        padded ones)."""
        N, n0 = v.shape[:2]
        vb = self._segments(v, 1)
        out = self.seg_diag @ vb
        contrib = self.seg_blk @ self._g(vb, self.seg_col)
        out.view((-1,) + out.shape[2:]).index_add_(
            0, self._frow, contrib.reshape((-1,) + contrib.shape[2:]))
        out = out.reshape(N, -1, v.shape[-1])[:, :n0]
        if self.dynamic:
            dl = 2.0 * (self.scale_w - 1.0) * self.e_tau
            out = out + self._scatter(
                self._fs, dl[..., None] * self._g(v, self.e_self))
        return out

    def _deflate_null(self, v):
        return v - self.null_V @ (self.null_V.transpose(-1, -2) @ v)

    def _precondition_t_seg(self, r):
        """Two-level additive-Schwarz preconditioner of mG00: dense
        segment-diagonal inverses plus the segment-aggregated coarse
        inverse (Galerkin P^T mG00 P over piecewise-constant indicators),
        null components deflated so CG stays in the range space."""
        N, n0 = r.shape[:2]
        rb = self._segments(r, 1)
        z = self.seg_t_inv @ rb
        c = self.seg_c_inv @ rb.sum(2)
        z = (z + c[:, :, None, :]).reshape(N, -1, r.shape[-1])[:, :n0]
        return self._deflate_null(z)

    def _solve_mG00_seg(self, rhs, x0=None, syncs: HostSyncs | None = None):
        """Preconditioned CG on mG00_matvec. The d right-hand-side columns
        of each node run as independent CGs sharing iterations (scalars
        [N, d]); a node iterates while any of its columns has |r|^2 above
        tol^2 |rhs|^2 and keeps its state once none has, and the loop ends
        when no node iterates or at `seg_cg_iters` trips: what the JAX
        package's vmapped while_loop computes (`utils.bounded_while`: on
        the host route the continuation flag is read once per trip,
        counted in `syncs`). The null response is
        dropped, as in the dense split inverse (solve_mG00 adds it).

        `x0` warm-starts the iteration; convergence is measured against
        |rhs|, not the warm-started initial residual."""
        syncs = syncs or HostSyncs()
        r_full = self._deflate_null(rhs)
        rr_ref = (r_full * r_full).sum(1)
        if x0 is None:
            x, r = torch.zeros_like(rhs), r_full
        else:
            x = self._deflate_null(x0)
            r = r_full - self._deflate_null(self.mG00_matvec(x))
        z = self._precondition_t_seg(r)
        p, rz = z, (r * z).sum(1)
        tol2 = self.seg_cg_tol * self.seg_cg_tol

        def running_lanes(c):
            r = c[1]
            return ((r * r).sum(1) > tol2 * rr_ref).any(1)

        def trip(c, running):
            x, r, p, rz = c
            Ap = self._deflate_null(self.mG00_matvec(p))
            pAp = (p * Ap).sum(1)
            alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0),
                                0.0)
            x_new = x + alpha[:, None, :] * p
            r_new = r - alpha[:, None, :] * Ap
            z_new = self._precondition_t_seg(r_new)
            rz_new = (r_new * z_new).sum(1)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            p_new = z_new + beta[:, None, :] * p
            return (sel(running, x_new, x), sel(running, r_new, r),
                    sel(running, p_new, p), sel(running, rz_new, rz))

        x, _, _, _ = bounded_while(self.seg_cg_iters, running_lanes, trip,
                                   (x, r, p, rz), syncs=syncs, name="seg_cg")
        return x

    def precondition_R_seg(self, V):
        """Segment-dense regularized mG11 inverse applied to an R-storage
        tangent [N, n0, d, d]: the segment analog of precondition_tall."""
        N, n0, d = V.shape[:3]
        Pb = self.seg_R_inv @ self._segments(self.to_tall(V), d)
        return self.from_tall(Pb.reshape(N, -1, d)[:, :n0 * d])

    # ------------------------------------------------- translation solves

    def solve_mG00(self, rhs, t_anchor=None, syncs: HostSyncs | None = None):
        """Apply the inverse of the translation block to rhs [N, n0, d]
        through the split inverse. The null response (near-singular on
        components without inter edges, where dividing by xi would amplify
        rounding by 1/xi) equals the gauge of the anchor state whose
        surrogate produced rhs: -null_V null_V^T t_anchor (t_anchor=None
        divides by xi instead). Under dynamic rescale the Woodbury core
        corrects the base inverse for the diagonal weight delta at the
        poses with inter edges.

        Segment path: the split inverse is replaced by segment-Schwarz CG
        (_solve_mG00_seg, flag reads counted in `syncs`), whose matvec
        carries the current rescale weights, so no Woodbury core. The CG
        warm-starts from -t_anchor: the solve's output is minus a
        translation state near the anchor, so the initial residual scales
        with the MM step, not with the state."""
        if self.seg:
            out = self._solve_mG00_seg(
                rhs, None if t_anchor is None else -t_anchor, syncs)
        else:
            out = self.Minv_red @ rhs
        if t_anchor is None:
            c = (self.null_V.transpose(-1, -2) @ rhs) / self.xi
        else:
            c = -(self.null_V.transpose(-1, -2) @ t_anchor)
        out = out + self.null_V @ c
        if self.dynamic and not self.seg:
            out = out - self.SU @ (self.wood_C @ self._g(out, self.ipose))
        return out

    def recover_translations(self, R, g_t, t_anchor=None,
                             syncs: HostSyncs | None = None):
        """t = -mG00^{-1} (g_t + mG01 R) (edge-wise coupling block)."""
        return -self.solve_mG00(g_t + self.mG01_apply(R), t_anchor, syncs)

    def mG01_apply(self, M):
        """t-space result of the G translation-rotation coupling block.

        intra e: row t_i += tau M_i t~ ; row t_j -= tau M_i t~
        inter self-tail e: row t_self += 2 tau M_self t~
        """
        v = self.a_tau[..., None] * self._mv(self._g(M, self.a_i), self.a_t)
        out = self._scatter(self._fi, v) + self._scatter(self._fj, -v)
        w = torch.where(self._sel,
                        (2.0 * self._sw(self.e_tau))[..., None]
                        * self._mv(self._g(M, self.e_self), self.e_t),
                        0.0)
        return out + self._scatter(self._fs, w)

    def mG10_apply(self, v):
        """R-space result of the transpose coupling block.

        intra e: block R_i += tau (v_i - v_j) t~^T
        inter self-tail e: block R_self += 2 tau v_self t~^T
        """
        dv = self._g(v, self.a_i) - self._g(v, self.a_j)
        blk = self.a_tau[..., None, None] * dv[..., :, None] \
            * self.a_t[..., None, :]
        blk2 = torch.where(
            self._selm,
            (2.0 * self._sw(self.e_tau))[..., None, None]
            * self._g(v, self.e_self)[..., :, None] * self.e_t[..., None, :],
            0.0)
        return self._scatter(self._fi, blk) + self._scatter(self._fs, blk2)

    def mG11_apply(self, M):
        """R-space rotation block of G applied to ambient M [N, n0, d, d].

        intra e: R_i += kappa (M_i R~ - M_j) R~^T + tau (M_i t~) t~^T
                 R_j += -kappa (M_i R~ - M_j)
        inter self-tail: R_s += 2 kappa M_s + 2 tau (M_s t~) t~^T
        inter self-head: R_s += 2 kappa M_s
        plus xi M.
        """
        Mi = self._g(M, self.a_i)
        rR = self._mm(Mi, self.a_R) - self._g(M, self.a_j)
        blk_i = self.a_kap[..., None, None] \
            * self._mm(rR, self.a_R.transpose(-1, -2)) \
            + self.a_tau[..., None, None] \
            * self._mv(Mi, self.a_t)[..., :, None] * self.a_t[..., None, :]
        blk_j = -self.a_kap[..., None, None] * rR
        Ms = self._g(M, self.e_self)
        tail_extra = torch.where(
            self._selm,
            (2.0 * self._sw(self.e_tau))[..., None, None]
            * self._mv(Ms, self.e_t)[..., :, None] * self.e_t[..., None, :],
            0.0)
        out = self._scatter(self._fi, blk_i) + self._scatter(self._fj, blk_j)
        out = out + self._scatter(
            self._fs, (2.0 * self._sw(self.e_kap))[..., None, None] * Ms
            + tail_extra)
        return out + self.xi * M

    def G_apply(self, t, R):
        """G X as (d/dt, d/dR): the gradient of 1/2 <G X, X>."""
        rt, rR = self.intra_residuals(t, R)
        u = torch.sqrt(self.a_tau)[..., None] * rt
        E = torch.sqrt(self.a_kap)[..., None, None] * rR
        Gi = u[..., :, None] * self.a_t[..., None, :] \
            + self._mm(E, self.a_R.transpose(-1, -2))
        Df_t = self._scatter(self._fi, u) - self._scatter(self._fj, u)
        Df_R = self._scatter(self._fi, Gi) - self._scatter(self._fj, E)
        # inter: 2 w_bar A_self^T A_self x_self.
        u_s, E_s = self._self_half(t, R)
        g2t, g2R = self.apply_A_self_T(
            2.0 * self.scale_w[..., None] * u_s,
            2.0 * self.scale_w[..., None, None] * E_s)
        return Df_t + g2t + self.xi * t, Df_R + g2R + self.xi * R

    # ---------------------------------------------------- TNT building blocks

    def evaluate_G(self, t, R, g, f) -> torch.Tensor:
        """G^a value 1/2 <G X, X> + <g, X> + f: through the dense operator
        images on the dense path, edge-wise (G_quad) otherwise."""
        g_t, g_R = g
        if self.dense:
            return self.evaluate_G_tall(t, self.to_tall(R), g_t,
                                        self.to_tall(g_R), f)
        return 0.5 * self.G_quad(t, R) + _nsum(g_t * t) + _nsum(g_R * R) + f

    def reduced_euclidean_grad(self, t, R, g_R):
        """nabla_R G(X) = g_R + mG10 t + mG11 R."""
        return g_R + self.mG10_apply(t) + self.mG11_apply(R)

    def reduced_hessian_vp(self, R, nablaR, Rdot):
        """Riemannian Hessian-vector product of the reduced (t-eliminated)
        surrogate, edge-wise. The rhs has exactly zero null component, so
        the null response is dropped (see solve_mG00)."""
        rhs = self.mG01_apply(Rdot)
        tdot = -self.solve_mG00(rhs, t_anchor=torch.zeros_like(rhs))
        E = self.mG10_apply(tdot) + self.mG11_apply(Rdot)
        E = E - sym_block_diag_product(Rdot, R, nablaR, self.kernels)
        return proj_tangent(R, E, self.kernels)

    def precondition(self, R, V):
        """Block-Jacobi preconditioner + tangent projection."""
        return proj_tangent(R, self._mm(V, self.precon_inv), self.kernels)

    # ------------------------------------------------ dense operators

    def to_tall(self, R):
        """[N, n, d, d] true-rotation blocks -> tall Q-storage [N, n d, d]."""
        return R.transpose(-1, -2).reshape(R.shape[0], -1, self.d)

    def from_tall(self, Q):
        return Q.reshape(Q.shape[0], -1, self.d, self.d).transpose(-1, -2)

    def sym_block_tall(self, A, B, C):
        """A_i sym(B_i C_i^T) per [d, d] block in tall storage."""
        N, d = A.shape[0], self.d
        Ab = A.reshape(N, -1, d, d)
        Bb = B.reshape(N, -1, d, d)
        Cb = C.reshape(N, -1, d, d)
        S = self._mm(Bb, Cb.transpose(-1, -2))
        S = 0.5 * (S + S.transpose(-1, -2))
        return self._mm(S, Ab).reshape(A.shape)

    def proj_tall(self, Q, V):
        return V - self.sym_block_tall(Q, Q, V)

    def evaluate_G_tall_rel(self, t, Q, zt, zQ, g_t, g_Q, fobj):
        """f32-stable relative surrogate value in tall storage:
        G(X) = fobj + 1/2 <G (X+Z), X-Z> + <g, X-Z>."""
        self._dense_only("evaluate_G_tall_rel")
        dt, dQ = t - zt, Q - zQ
        st_, sQ = t + zt, Q + zQ
        Gt = self.mG00_d @ st_ + self.mG01_d @ sQ
        GQ = self.mG01_d.transpose(-1, -2) @ st_ + self.mG11_d @ sQ
        return (fobj + 0.5 * (_nsum(Gt * dt) + _nsum(GQ * dQ))
                + _nsum(g_t * dt) + _nsum(g_Q * dQ))

    def evaluate_G_tall(self, t, Q, g_t, g_Q, f):
        """Dense surrogate value in tall storage: 1/2 <G X, X> + <g, X> + f."""
        self._dense_only("evaluate_G_tall")
        quad = _nsum(t * (self.mG00_d @ t)) \
            + 2.0 * _nsum(t * (self.mG01_d @ Q)) \
            + _nsum(Q * (self.mG11_d @ Q))
        return 0.5 * quad + _nsum(g_t * t) + _nsum(g_Q * Q) + f

    def reduced_grad_tall(self, t, Q, g_Q):
        self._dense_only("reduced_grad_tall")
        return g_Q + self.mG01_d.transpose(-1, -2) @ t + self.mG11_d @ Q

    def hessian_vp_tall(self, Q, nablaQ, Qdot):
        """Hessian-vector product of the reduced surrogate: one matmul with
        Hred, plus the point-dependent curvature correction and the tangent
        projection."""
        self._dense_only("hessian_vp_tall")
        E = self.Hred_d @ Qdot - self.sym_block_tall(Qdot, Q, nablaQ)
        return self.proj_tall(Q, E)

    def precondition_tall(self, Q, V):
        self._dense_only("precondition_tall")
        return self.proj_tall(Q, self.precon_dense @ V)

    def precondition_tall_jacobi(self, Q, V):
        """Block-Jacobi preconditioner in tall Q-storage: the per-pose
        blocks act on R-storage from the right, which in Q = R^T storage is
        a left-multiply by the (symmetric) block."""
        N, d = V.shape[0], self.d
        P = self._mm(self.precon_inv, V.reshape(N, -1, d, d)).reshape(V.shape)
        return self.proj_tall(Q, P)

    def recover_translations_tall(self, Q, g_t, t_anchor=None):
        self._dense_only("recover_translations_tall")
        return -self.solve_mG00(g_t + self.mG01_d @ Q, t_anchor)


def with_weights(base: NodeProblem, w_bar: torch.Tensor) -> NodeProblem:
    """The problem reweighted for dynamic rescale, batched over the node
    axis (dpgo_tpu/problem.py::with_weights).

    `base` must be the problem as built (scale_w = 1); w_bar [N, m1] are the
    new persisted surrogate weights. Recomputes the proximal constants
    (diagT, nvec, W), the Woodbury core of the translation solve (not on the
    segment path, whose CG matvec reads scale_w) and, on the dense path only,
    the operator images mG00, mG01, mG11 and Hred; kernel K1 reads the new
    Hred directly. precon_dense stays the base one: w <= 1 only shrinks the
    operator, so the base inverse remains an SPD preconditioner.
    """
    N, n0, d = base.num_nodes, base._n0(), base.d
    nd = n0 * d
    dt, dev = base.diagT_inv.dtype, base.diagT_inv.device
    eye = torch.eye(d, dtype=dt, device=dev)
    b = base._b

    def acc(out, *terms):
        """out [N, n0, ...] += each (flat pose index, values) in turn."""
        flat = out.reshape((N * n0,) + out.shape[2:])
        for idx, vals in terms:
            flat.index_add_(0, idx, vals.reshape((-1,) + vals.shape[2:]))
        return out

    # Pose-level auxiliary quantities, rebuilt from the edge arrays.
    a_t2 = 2.0 * base.a_tau
    e_t2 = 2.0 * w_bar * base.e_tau
    diagT = acc(torch.full((N, n0), 1.5 * base.xi, dtype=dt, device=dev),
                (base._fi, a_t2), (base._fj, a_t2), (base._fs, e_t2))
    nvec = acc(torch.zeros((N, n0, d), dtype=dt, device=dev),
               (base._fi, a_t2[..., None] * base.a_t),
               (base._fs, torch.where(base._sel, e_t2[..., None] * base.e_t,
                                      0.0)))
    a_k2 = 2.0 * base.a_kap
    e_k2 = 2.0 * w_bar * base.e_kap
    outer_a = base.a_t[..., :, None] * base.a_t[..., None, :]
    outer_e = base.e_t[..., :, None] * base.e_t[..., None, :]
    S = acc((1.5 * base.xi) * eye.expand(N, n0, d, d).clone(),
            (base._fi, a_k2[..., None, None] * eye
             + a_t2[..., None, None] * outer_a),
            (base._fj, a_k2[..., None, None] * eye),
            (base._fs, e_k2[..., None, None] * eye
             + torch.where(base._selm, e_t2[..., None, None] * outer_e,
                           0.0)))
    Tinv = 1.0 / diagT
    W = S - Tinv[..., None, None] * nvec[..., :, None] * nvec[..., None, :]

    repl = dict(dynamic=True, scale_w=w_bar, diagT_inv=Tinv, nvec=nvec, W=W)
    if base.seg:
        return dataclasses.replace(base, **repl)

    # Woodbury core for the translation solve: the weight delta is diagonal
    # and lives at the inter poses only.
    delta = acc(torch.zeros((N, n0), dtype=dt, device=dev),
                (base._fs, 2.0 * base.e_tau * (w_bar - 1.0)))
    D = base._g(delta, base.ipose) * base.imask
    UtSU = base.SU[b, base.ipose]  # [N, k, k]
    k = D.shape[1]
    A = torch.eye(k, dtype=dt, device=dev) + UtSU * D[:, None, :]
    wood_C = D[..., None] * torch.linalg.inv_ex(A)[0]
    repl.update(wood_C=wood_C)
    if not base.dense:
        return dataclasses.replace(base, **repl)

    # Dense operator deltas relative to the base's unit weights.
    dw = w_bar - base.scale_w
    es = base.e_self
    ar = torch.arange(d, device=dev)
    v11 = (2.0 * dw * base.e_kap)[..., None, None] * eye + torch.where(
        base._selm, (2.0 * dw * base.e_tau)[..., None, None] * outer_e, 0.0)
    rc = (es * d)[..., None] + ar  # [N, m1, d] rows/cols of the self block
    idx11 = ((b[..., None, None] * nd + rc[..., :, None]) * nd
             + rc[..., None, :])
    mG11_d = base.mG11_d.clone()
    mG11_d.view(-1).index_add_(0, idx11.reshape(-1), v11.reshape(-1))
    v01 = torch.where(base._sel, (2.0 * dw * base.e_tau)[..., None]
                      * base.e_t, 0.0)
    idx01 = (b[..., None] * n0 + es[..., None]) * nd + rc
    mG01_d = base.mG01_d.clone()
    mG01_d.view(-1).index_add_(0, idx01.reshape(-1), v01.reshape(-1))
    idx00 = (b * n0 + es) * n0 + es
    mG00_d = base.mG00_d.clone()
    mG00_d.view(-1).index_add_(0, idx00.reshape(-1),
                               (2.0 * dw * base.e_tau).reshape(-1))
    # Hred = mG11 - mG10 X with X = mG00^{-1} mG01 through the base split
    # inverse and the new Woodbury core (the null response is dropped, as
    # at build time).
    X = base.Minv_red @ mG01_d
    X = X - base.SU @ (wood_C @ base._g(X, base.ipose))
    Hred_d = mG11_d - mG01_d.transpose(-1, -2) @ X
    return dataclasses.replace(base, mG11_d=mG11_d, mG01_d=mG01_d,
                               mG00_d=mG00_d, Hred_d=Hred_d, **repl)


def make_problem(arrays: dict, *, d: int, xi: float, loss: Loss,
                 loss_reg: float, dense: bool, device, dtype,
                 dynamic: bool = False, **seg) -> NodeProblem:
    """NodeProblem from numpy arrays keyed by field name (host -> device);
    `seg` are the segment path's settings (seg, seg_size, seg_cg_iters,
    seg_cg_tol) where the problem is on it."""
    def conv(name):
        x = np.asarray(arrays[name])
        if not x.flags.writeable:  # e.g. a view of a JAX array
            x = x.copy()
        if name in INDEX_FIELDS:
            return torch.as_tensor(x.astype(np.int64), device=device)
        if name in BOOL_FIELDS:
            return torch.as_tensor(x.astype(bool), device=device)
        return torch.as_tensor(x, dtype=dtype, device=device)

    return NodeProblem(d=d, xi=xi, loss=loss, loss_reg=loss_reg, dense=dense,
                       dynamic=dynamic, **seg,
                       **{name: conv(name) for name in ARRAY_FIELDS})


# ------------------------------------------------------------------ builders


def _accum_cross_blocks(blk_map: dict, n_seg: int, S: int, r_arr, c_arr,
                        lr, lc, vals):
    """Accumulate edge couplings into per-(row, col)-segment-pair [S, S]
    dense blocks (host-side block assembly)."""
    if len(r_arr) == 0:
        return
    key = r_arr.astype(np.int64) * n_seg + c_arr
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    bounds = np.append(starts, len(key_s))
    for u, s0, s1 in zip(uniq, bounds[:-1], bounds[1:]):
        r, c = divmod(int(u), n_seg)
        blk = blk_map.setdefault((r, c), np.zeros((S, S)))
        pick = order[s0:s1]
        np.add.at(blk, (lr[pick], lc[pick]), vals[pick])


def _clamped_spd_inv(A: np.ndarray, rel_clip: float = 1e-9) -> np.ndarray:
    """Batched SPD (pseudo-)inverse with the near-null spectrum clamped to
    zero weight, the segment analog of the eigen-split inverse: modes the
    block cannot see (segment constants, global gauge) are the coarse
    level's and the null deflation's job, and keeping their 1/xi-scale
    responses would destroy the float32 cast of everything else."""
    lam, V = np.linalg.eigh(A)
    lmax = np.maximum(lam[..., -1:], 1e-30)
    w = np.where(lam < rel_clip * lmax, 0.0, 1.0 / np.maximum(lam, 1e-300))
    return np.einsum("...pk,...k,...qk->...pq", V, w, V)


def _build_segment_factors(mg: MultiGraph, xi: float, S: int,
                           reg: np.ndarray):
    """Dense contiguous-segment factors for the segment path (host numpy,
    float64).

    Returns (seg_t_inv [N, n_seg, S, S], seg_c_inv [N, n_seg, n_seg],
    seg_R_inv [N, n_seg, S d, S d], seg_diag, seg_blk, seg_row, seg_col):
    - seg_t_inv: clamped inverses of mG00's segment-diagonal blocks (edges
      crossing segments contribute only their diagonal entries);
    - seg_c_inv: clamped inverse of the Galerkin coarse operator
      P^T mG00 P over piecewise-constant segment indicators;
    - seg_R_inv: plain inverses of mG11's segment-diagonal blocks (tall
      Q-storage convention, matching the dense-path mG11_d layout) +
      reg[a] I, the preconditioner of the coupled TNT model;
    - seg_diag [N, n_seg, S, S] (mG00's segment-diagonal blocks before
      inversion) and the off-diagonal segment-pair blocks seg_blk
      [N, npair, S, S] with seg_row / seg_col [N, npair]: the block image
      the CG matvec multiplies by.
    Padded poses carry diagonal 1, real poses xi. `reg` is the per-node
    lam_max / precon_cond regularizer."""
    N, n0m, d = mg.num_nodes, mg.n0_max, mg.d
    n_seg = -(-n0m // S)
    n_pad = n_seg * S
    pidx = np.arange(n_pad)
    seg_of = (pidx // S).astype(np.int32)
    loc_of = (pidx % S).astype(np.int32)
    ar = np.arange(d)

    seg_t = np.zeros((N, n_seg, S, S))
    seg_c = np.zeros((N, n_seg, n_seg))
    seg_R = np.zeros((N, n_seg, S * d, S * d))
    blk_maps = [dict() for _ in range(N)]  # (r, c) -> [S, S] off-diag block

    def add_R(a, sp_, lp, lq, vals):
        """seg_R[a][sp_, lp*d:+d, lq*d:+d] += vals ([m, d, d])."""
        r = lp[:, None, None] * d + ar[None, :, None]
        c = lq[:, None, None] * d + ar[None, None, :]
        np.add.at(seg_R[a], (sp_[:, None, None], r, c), vals)

    eye = np.eye(d)
    for a in range(N):
        realp = np.zeros(n_pad, bool)
        realp[:n0m] = mg.pose_mask[a]
        dval = np.where(realp, xi, 1.0)
        np.add.at(seg_t[a], (seg_of, loc_of, loc_of), dval)
        np.add.at(seg_c[a], (seg_of, seg_of), dval)
        for k in range(d):
            np.add.at(seg_R[a], (seg_of, loc_of * d + k, loc_of * d + k),
                      dval)

        ii, jj = mg.a_i[a], mg.a_j[a]
        msk = mg.a_mask[a]
        w = mg.a_tau[a] * msk
        kap = mg.a_kap[a] * msk
        tt = mg.a_t[a]
        Rm = mg.a_R[a]
        si, li = seg_of[ii], loc_of[ii]
        sj, lj = seg_of[jj], loc_of[jj]
        np.add.at(seg_t[a], (si, li, li), w)
        np.add.at(seg_t[a], (sj, lj, lj), w)
        same = si == sj
        np.add.at(seg_t[a], (si[same], li[same], lj[same]), -w[same])
        np.add.at(seg_t[a], (si[same], lj[same], li[same]), -w[same])
        # Crossing edges: the off-diagonal segment-pair couplings of the
        # block matvec (both directions of the symmetric coupling).
        cross = ~same
        _accum_cross_blocks(blk_maps[a], n_seg, S,
                            np.concatenate([si[cross], sj[cross]]),
                            np.concatenate([sj[cross], si[cross]]),
                            np.concatenate([li[cross], lj[cross]]),
                            np.concatenate([lj[cross], li[cross]]),
                            np.concatenate([-w[cross], -w[cross]]))
        np.add.at(seg_c[a], (si, si), w)
        np.add.at(seg_c[a], (sj, sj), w)
        np.add.at(seg_c[a], (si, sj), -w)
        np.add.at(seg_c[a], (sj, si), -w)

        ttT = tt[:, :, None] * tt[:, None, :]
        add_R(a, si, li, li, kap[:, None, None] * eye
              + w[:, None, None] * ttT)
        add_R(a, sj, lj, lj, kap[:, None, None] * eye)
        add_R(a, si[same], li[same], lj[same],
              (-kap[same])[:, None, None] * Rm[same])
        add_R(a, sj[same], lj[same], li[same],
              (-kap[same])[:, None, None]
              * np.swapaxes(Rm[same], -1, -2))

        es = mg.e_self[a]
        et2 = 2.0 * mg.e_tau[a] * mg.e_mask[a]
        ek2 = 2.0 * mg.e_kap[a] * mg.e_mask[a]
        ett = mg.e_t[a]
        is_tail = mg.e_self_is_i[a]
        se, le = seg_of[es], loc_of[es]
        np.add.at(seg_t[a], (se, le, le), et2)
        np.add.at(seg_c[a], (se, se), et2)
        ettT = ett[:, :, None] * ett[:, None, :]
        add_R(a, se, le, le, ek2[:, None, None] * eye
              + (et2 * is_tail)[:, None, None] * ettT)

    # Pack the off-diagonal blocks, padded to the largest pair count with
    # zero blocks on row and column 0 (they add exact zeros).
    npair = max([len(m) for m in blk_maps] + [1])
    seg_blk = np.zeros((N, npair, S, S))
    seg_row = np.zeros((N, npair), np.int64)
    seg_col = np.zeros((N, npair), np.int64)
    for a in range(N):
        for k, ((r, c), blk) in enumerate(sorted(blk_maps[a].items())):
            seg_blk[a, k] = blk
            seg_row[a, k] = r
            seg_col[a, k] = c

    seg_t_inv = _clamped_spd_inv(seg_t)
    seg_c_inv = _clamped_spd_inv(seg_c)
    seg_R += reg[:, None, None, None] * np.eye(S * d)
    seg_R_inv = np.linalg.inv(seg_R)
    return (seg_t_inv, seg_c_inv, seg_R_inv, seg_t, seg_blk, seg_row,
            seg_col)


def _component_null_space(mg: MultiGraph) -> np.ndarray:
    """null_V [N, n0, kmax] of the segment path: the (near-)null space of
    mG00 = L + xi I is one constant vector per connected component of the
    intra graph that carries no inter edge (what the eigen-split finds
    numerically), so connected components replace the O(n0^3)
    eigendecomposition. Columns are normalized indicators, zero-padded."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    N, n0m = mg.num_nodes, mg.n0_max
    comp_cols = []
    for a in range(N):
        n_real = int(mg.pose_mask[a].sum())
        am = mg.a_mask[a]
        ii, jj = mg.a_i[a][am], mg.a_j[a][am]
        A = sp.coo_matrix((np.ones(len(ii)), (ii, jj)),
                          shape=(n_real, n_real))
        ncomp, labels = csgraph.connected_components(A, directed=False)
        has_inter = np.zeros(ncomp, bool)
        has_inter[labels[mg.e_self[a][mg.e_mask[a]]]] = True
        cols = []
        for cidx in np.flatnonzero(~has_inter):
            v = np.zeros(n0m)
            pick = labels == cidx
            v[:n_real][pick] = 1.0 / np.sqrt(pick.sum())
            cols.append(v)
        comp_cols.append(cols)
    kmax = max([len(c) for c in comp_cols] + [1])
    null_V = np.zeros((N, n0m, kmax))
    for a in range(N):
        for k, v in enumerate(comp_cols[a]):
            null_V[a][:, k] = v
    return null_V


def _dense_images(mg: MultiGraph, mG00: np.ndarray, xi: float):
    """The dense operator images (tall Q-storage) of the dense path, host
    float64: (mG00 + xi on the real poses, mG01 [N, n0, n0 d], mG11
    [N, n0 d, n0 d])."""
    N, n0m, d = mg.num_nodes, mg.n0_max, mg.d
    nd = n0m * d
    mG01_d = np.zeros((N, n0m, nd))
    mG11_d = np.zeros((N, nd, nd))
    eye = np.eye(d)
    ar = np.arange(d)

    def add_blocks(M, rows, cols, vals):
        """M[rows*d:+d, cols*d:+d] += vals, vectorized over edges."""
        r = rows[:, None, None] * d + ar[None, :, None]
        c = cols[:, None, None] * d + ar[None, None, :]
        np.add.at(M, (r, c), vals)

    for a in range(N):
        ii, jj = mg.a_i[a], mg.a_j[a]
        tau = mg.a_tau[a] * mg.a_mask[a]
        kap = mg.a_kap[a] * mg.a_mask[a]
        tt = mg.a_t[a]
        Rm = mg.a_R[a]
        ttT = tt[:, :, None] * tt[:, None, :]
        add_blocks(mG11_d[a], ii, ii,
                   kap[:, None, None] * eye + tau[:, None, None] * ttT)
        add_blocks(mG11_d[a], jj, jj, kap[:, None, None] * eye)
        add_blocks(mG11_d[a], ii, jj, -kap[:, None, None] * Rm)
        add_blocks(mG11_d[a], jj, ii,
                   -kap[:, None, None] * np.swapaxes(Rm, -1, -2))
        # mG01: row t_i += tau t~^T in Q_i cols; row t_j -= same.
        c01 = ii[:, None] * d + ar[None, :]
        np.add.at(mG01_d[a], (ii[:, None], c01), tau[:, None] * tt)
        np.add.at(mG01_d[a], (jj[:, None], c01), -tau[:, None] * tt)

        es = mg.e_self[a]
        etau = mg.e_tau[a] * mg.e_mask[a]
        ekap = mg.e_kap[a] * mg.e_mask[a]
        ett = mg.e_t[a]
        is_tail = mg.e_self_is_i[a]
        ettT = ett[:, :, None] * ett[:, None, :]
        add_blocks(mG11_d[a], es, es,
                   2 * ekap[:, None, None] * eye
                   + 2 * (etau * is_tail)[:, None, None] * ettT)
        ce = es[:, None] * d + ar[None, :]
        np.add.at(mG01_d[a], (es[:, None], ce),
                  2 * (etau * is_tail)[:, None] * ett)
        mG11_d[a][np.diag_indices(nd)] += xi
    mG00_full = mG00 + xi * np.where(
        mg.pose_mask, 1.0, 0.0)[:, :, None] * np.eye(n0m)
    return mG00_full, mG01_d, mG11_d


def build_node_problems(mg: MultiGraph, xi: float = 1e-11,
                        loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
                        precon_cond: float = 1e6,
                        dense_limit: int = 4096,
                        segment_limit: int = 2048,
                        seg_size: int = 128,
                        seg_cg_iters: int = 20,
                        seg_cg_tol: float | None = None,
                        dtype=torch.float64, device=None,
                        nodes: tuple[int, int] | None = None) -> NodeProblem:
    """Build a stacked NodeProblem (leading node axis) from a MultiGraph:
    dpgo_tpu/problem.py::build_node_problems as the same host numpy in
    float64, then moved to `device` in `dtype` (the CUDA card unless
    `device` names another).

    Blocks of more than `segment_limit` poses take the segment path (no
    [n0, n0] array is formed; `seg_cg_tol` None = 1e-7 in float64, 3e-6 in
    float32), blocks with n0 d above `dense_limit` the edge-wise path (no
    [n0 d, n0 d] array), the others the dense path; see the module
    docstring.

    `nodes=(lo, hi)` builds nodes [lo, hi) only (one rank of a sharded
    solver): the same arrays as rows lo..hi-1 of the whole build, except
    that the widths padded to a maximum over nodes (null-space and
    inter-pose columns, segment pairs) are this range's maxima."""
    device = resolve_device(device)
    node0 = 0
    if nodes is not None:
        node0 = nodes[0]
        mg = node_range(mg, *nodes)
    N, n0m, d = mg.num_nodes, mg.n0_max, mg.d
    seg = n0m > segment_limit
    dense = n0m * d <= dense_limit and not seg
    if seg_cg_tol is None:
        seg_cg_tol = 1e-7 if dtype == torch.float64 else 3e-6
    with span("build.assemble", setup=True):
        diagT = np.full((N, n0m), 1.5 * xi)
        nvec = np.zeros((N, n0m, d))
        S = np.tile(1.5 * xi * np.eye(d), (N, n0m, 1, 1))
        mG00 = np.zeros((N, 1, 1) if seg else (N, n0m, n0m))
        jac = np.tile(xi * np.eye(d), (N, n0m, 1, 1))  # mG11 block-diagonal

        for a in range(N):
            ii, jj = mg.a_i[a], mg.a_j[a]
            tau = mg.a_tau[a]
            kap = mg.a_kap[a]
            tt = mg.a_t[a]
            msk = mg.a_mask[a]
            np.add.at(diagT[a], ii, 2 * tau * msk)
            np.add.at(diagT[a], jj, 2 * tau * msk)
            np.add.at(nvec[a], ii, 2 * tau[:, None] * tt * msk[:, None])
            np.add.at(S[a], ii, (2 * kap * msk)[:, None, None] * np.eye(d)
                      + (2 * tau * msk)[:, None, None]
                      * tt[:, :, None] * tt[:, None, :])
            np.add.at(S[a], jj, (2 * kap * msk)[:, None, None] * np.eye(d))
            # mG00 intra Laplacian.
            w = tau * msk
            if not seg:
                np.add.at(mG00[a], (ii, ii), w)
                np.add.at(mG00[a], (jj, jj), w)
                np.add.at(mG00[a], (ii, jj), -w)
                np.add.at(mG00[a], (jj, ii), -w)
            # mG11 block diagonal (Jacobi preconditioner).
            np.add.at(jac[a], ii, (kap * msk)[:, None, None] * np.eye(d)
                      + (tau * msk)[:, None, None]
                      * tt[:, :, None] * tt[:, None, :])
            np.add.at(jac[a], jj, (kap * msk)[:, None, None] * np.eye(d))

            es = mg.e_self[a]
            et = mg.e_tau[a] * mg.e_mask[a]
            ek = mg.e_kap[a] * mg.e_mask[a]
            ett = mg.e_t[a]
            is_tail = mg.e_self_is_i[a]
            np.add.at(diagT[a], es, 2 * et)
            np.add.at(nvec[a], es, (2 * et * is_tail)[:, None] * ett)
            np.add.at(S[a], es, (2 * ek)[:, None, None] * np.eye(d)
                      + (2 * et * is_tail)[:, None, None]
                      * ett[:, :, None] * ett[:, None, :])
            np.add.at(jac[a], es, (2 * ek)[:, None, None] * np.eye(d)
                      + (2 * et * is_tail)[:, None, None]
                      * ett[:, :, None] * ett[:, None, :])
            if not seg:
                np.add.at(mG00[a], (es, es), 2 * et)
                # Padded poses get an identity diagonal (decoupled,
                # well-conditioned).
                real = mg.pose_mask[a]
                mG00[a][np.diag_indices(n0m)] += np.where(real, 0.0, 1.0)

        Tinv = 1.0 / diagT
        W = S - (Tinv[:, :, None, None] * nvec[:, :, :, None]
                 * nvec[:, :, None, :])
        if dense:
            mG00_full, mG01_d, mG11_d = _dense_images(mg, mG00, xi)
        else:
            mG00_full = mG01_d = mG11_d = np.zeros((N, 1, 1))

    with span("build.linalg", setup=True):
        if seg:
            null_V = _component_null_space(mg)
            Minv_red = np.zeros((N, 1, 1))
        else:
            # Split inverse of mG00 = L + xi I per node: eigendecompose the
            # PSD L, clamp the spectrum at zero, and separate the (near-)null
            # eigenspace so the reduced inverse has bounded entries.
            lam, V = np.linalg.eigh(mG00)  # L without xi
            lam = np.maximum(lam, 0.0)
            scale = lam.max(axis=1, keepdims=True)
            null_mask = lam < 1e-10 * np.maximum(scale, 1.0)  # [N, n0m]
            kmax = max(int(null_mask.sum(axis=1).max()), 1)
            Minv_red = np.zeros((N, n0m, n0m))
            null_V = np.zeros((N, n0m, kmax))
            for a in range(N):
                nm = null_mask[a]
                w = np.where(nm, 0.0, 1.0 / (lam[a] + xi))
                Minv_red[a] = (V[a] * w[None, :]) @ V[a].T
                k = int(nm.sum())
                null_V[a][:, :k] = V[a][:, nm]

        # lambda_max of the rotational block for the regularized
        # preconditioners: the largest Gershgorin bound of the block
        # diagonal, refined by Lanczos on the dense mG11 where that is built.
        lam_max = np.abs(jac).sum(axis=(-1, -2)).max(axis=-1)  # [N]

        if dense:
            nd = n0m * d
            # Reduced (t-eliminated) rotation operator
            # Hred = mG11 - mG10 mG00^+ mG01 (null response dropped:
            # null_V^T mG01 = 0 exactly), computed once in f64 on the host.
            Hred_d = np.zeros((N, nd, nd))
            for a in range(N):
                X = Minv_red[a] @ mG01_d[a]
                Hred_d[a] = mG11_d[a] - mG01_d[a].T @ X
                Hred_d[a] = 0.5 * (Hred_d[a] + Hred_d[a].T)

            from dpgo_tpu_torch.ops.eigen import lambda_max_lanczos
            for a in range(N):
                lam_max[a] = lambda_max_lanczos(mG11_d[a], seed=node0 + a)

            # Dense regularized inverse of the full reduced Hessian (the
            # reference's RegularizedCholesky role, lambda_max by Lanczos as
            # Spectra does there; seeds as in the JAX package): applied as
            # one matmul per STPCG iteration, so CG only corrects for the
            # curvature term and the tangent projection.
            precon_dense = np.zeros((N, nd, nd))
            for a in range(N):
                lam_h = lambda_max_lanczos(Hred_d[a], seed=1000 + node0 + a)
                precon_dense[a] = np.linalg.inv(
                    Hred_d[a] + (lam_h / precon_cond) * np.eye(nd))
        else:
            Hred_d = precon_dense = np.zeros((N, 1, 1))

        # Regularized block-Jacobi preconditioner: per-pose inverses of the
        # mG11 diagonal blocks + (lambda_max(mG11) / precon_cond) I.
        reg = lam_max / precon_cond
        precon_inv = np.linalg.inv(jac + reg[:, None, None, None] * np.eye(d))

        # Inter-pose selector + base-inverse columns for the dynamic-rescale
        # Woodbury translation solve.
        ipose_list = [np.unique(mg.e_self[a][mg.e_mask[a]]) for a in range(N)]
        kmax = max([len(v) for v in ipose_list] + [1])
        ipose = np.zeros((N, kmax), np.int64)
        imask = np.zeros((N, kmax), bool)
        SU = np.zeros((N, 1, 1) if seg else (N, n0m, kmax))
        for a in range(N):
            cols = ipose_list[a]
            k = len(cols)
            ipose[a, :k] = cols
            imask[a, :k] = True
            if k and not seg:
                SU[a][:, :k] = Minv_red[a][:, cols] \
                    + null_V[a] @ null_V[a][cols, :].T / xi

        if seg:
            (seg_t_inv, seg_c_inv, seg_R_inv, seg_diag, seg_blk, seg_row,
             seg_col) = _build_segment_factors(mg, xi, seg_size, reg)
        else:
            seg_t_inv = seg_R_inv = seg_diag = seg_blk = np.zeros((N, 1, 1, 1))
            seg_c_inv = np.zeros((N, 1, 1))
            seg_row = seg_col = np.zeros((N, 1), np.int64)

    arrays = dict(
        pose_mask=mg.pose_mask, diagT_inv=Tinv, nvec=nvec, W=W,
        Minv_red=Minv_red, null_V=null_V, precon_inv=precon_inv,
        mG00_d=mG00_full, mG01_d=mG01_d, mG11_d=mG11_d, Hred_d=Hred_d,
        precon_dense=precon_dense,
        scale_w=np.ones((N, mg.m1_max)), ipose=ipose, imask=imask, SU=SU,
        wood_C=np.zeros((N, kmax, kmax)),
        a_i=mg.a_i, a_j=mg.a_j, a_R=mg.a_R, a_t=mg.a_t, a_kap=mg.a_kap,
        a_tau=mg.a_tau, e_self=mg.e_self, e_slot=mg.e_slot,
        e_self_is_i=mg.e_self_is_i, e_R=mg.e_R, e_t=mg.e_t, e_kap=mg.e_kap,
        e_tau=mg.e_tau,
        seg_t_inv=seg_t_inv, seg_c_inv=seg_c_inv, seg_R_inv=seg_R_inv,
        seg_diag=seg_diag, seg_blk=seg_blk, seg_row=seg_row,
        seg_col=seg_col)
    with span("build.upload", setup=True):
        probs = make_problem(arrays, d=d, xi=xi, loss=loss,
                             loss_reg=loss_reg, dense=dense, device=device,
                             dtype=dtype, seg=seg, seg_size=seg_size,
                             seg_cg_iters=seg_cg_iters, seg_cg_tol=seg_cg_tol)
        sync(device)
    return probs
