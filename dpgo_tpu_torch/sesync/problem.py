"""SE-Sync simplified (translation-eliminated) problem, matrix-free (torch
port of dpgo_tpu/sesync/problem.py).

The rank-r relaxation minimizes F(Y) = 1/2 <Q Y, Y> over the product of
Stiefel blocks, where Q = L_Grho + Q_tau:

  L_Grho  rotation connection Laplacian (kappa weights)
  Q_tau   = V~^T Om^1/2 Pi Om^1/2 V~ with Pi the orthogonal projector onto
            ker(A_bar Om^1/2) (A_bar = reduced incidence), applied through a
            dense inverse of the reduced translation Laplacian on the device
            up to `dense_limit` poses, above it through a host SuperLU
            factorization (one device -> host -> device round trip per
            application, counted in the problem's `syncs` as "lred_host").

State layout: tall Q-storage Y [n d, r] with block rows Y_i in R^{d x r},
Y_i Y_i^T = I_d (at r = d, Y_i = R_i^T). Every application is an edge-wise
gather, batched products and an `index_add_`, on the problem's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dpgo_tpu_torch.io.g2o import Measurements
from dpgo_tpu_torch.manifold import project_sod
from dpgo_tpu_torch.ops import linalg
from dpgo_tpu_torch.solvers.tnt import TNTModel
from dpgo_tpu_torch.utils import HostSyncs, resolve_device


@dataclasses.dataclass
class SESyncProblem:
    d: int
    n: int
    m: int
    ei: torch.Tensor      # [m] int64
    ej: torch.Tensor      # [m] int64
    eR: torch.Tensor      # [m, d, d]
    et: torch.Tensor      # [m, d]
    kappa: torch.Tensor   # [m]
    tau: torch.Tensor     # [m]
    Lred_inv: torch.Tensor  # [n-1, n-1] inverse reduced translation Laplacian
    jac_inv: torch.Tensor   # [n, d, d] block-Jacobi preconditioner blocks
    # Host sparse-direct solve of the reduced translation Laplacian, used
    # instead of the dense Lred_inv above `dense_limit` poses: numpy
    # [n-1, r] -> numpy [n-1, r].
    lred_host: Callable | None = None
    # "simplified" (translation-eliminated, the default) or "sosync"
    # (rotation-only synchronization; Q = L_Grho).
    formulation: str = "simplified"
    # Route round_solution's SO(3) projection through kernel K2 (False: its
    # plain version on any device).
    kernels: bool = True
    # project_blocks' eigendecompositions by ops/linalg.py's Jacobi sweeps,
    # which read nothing on the host (torch.linalg.eigh on a card reads
    # its status): the staircase TNT captured on a card.
    capturable: bool = False
    syncs: HostSyncs = dataclasses.field(default_factory=HostSyncs)

    # ------------------------------------------------------- Q application

    def _blocks(self, Y):
        return Y.reshape(self.n, self.d, -1)

    def apply_LGrho(self, Y):
        """Rotation connection Laplacian in Q-storage tall layout."""
        B = self._blocks(Y)
        Bi = B[self.ei]
        Bj = B[self.ej]
        k = self.kappa[:, None, None]
        # (i,i): kappa B_i ; (i,j): -kappa R~ B_j ; etc.
        ci = k * (Bi - self.eR @ Bj)
        cj = k * (Bj - self.eR.transpose(-1, -2) @ Bi)
        out = torch.zeros_like(B).index_add_(0, self.ei, ci)
        out.index_add_(0, self.ej, cj)
        return out.reshape(Y.shape)

    def _lred_solve(self, u):
        """[n-1, r] reduced-Laplacian solve: dense inverse on the device,
        or the host sparse factorization above dense_limit."""
        if self.lred_host is not None:
            self.syncs.note("lred_host", 1)
            x = self.lred_host(u.cpu().numpy())
            return torch.as_tensor(x, dtype=u.dtype, device=u.device)
        return self.Lred_inv @ u

    def apply_Qtau(self, Y):
        """Translation-elimination term V~^T Om^1/2 Pi Om^1/2 V~ Y."""
        B = self._blocks(Y)
        st = torch.sqrt(self.tau)
        # w = Om^1/2 V~ Y : [m, r]
        w = st[:, None] * torch.einsum("ea,ear->er", self.et, B[self.ei])
        # u = A_bar Om^1/2 w (incidence: +1 at i, -1 at j; drop pose 0)
        sw = st[:, None] * w
        u_full = Y.new_zeros((self.n, w.shape[1])).index_add_(0, self.ei, sw)
        u_full.index_add_(0, self.ej, -sw)
        v = self._lred_solve(u_full[1:])
        v_full = torch.cat([Y.new_zeros((1, w.shape[1])), v], dim=0)
        w2 = w - st[:, None] * (v_full[self.ei] - v_full[self.ej])
        # back: V~^T Om^1/2 w2
        out = torch.zeros_like(B).index_add_(
            0, self.ei, self.et[:, :, None] * (st[:, None] * w2)[:, None, :])
        return out.reshape(Y.shape)

    def apply_Q(self, Y):
        if self.formulation == "sosync":
            return self.apply_LGrho(Y)
        return self.apply_LGrho(Y) + self.apply_Qtau(Y)

    def objective(self, Y):
        return 0.5 * torch.sum(Y * self.apply_Q(Y))

    # ------------------------------------------------------- manifold ops

    def sym_block_product(self, A, B, C):
        """A_i sym(B_i C_i^T) per block (tall layout; SOdProduct::
        SymBlockDiagProduct in Q-storage)."""
        Ab, Bb, Cb = self._blocks(A), self._blocks(B), self._blocks(C)
        S = Bb @ Cb.transpose(-1, -2)
        S = 0.5 * (S + S.transpose(-1, -2))
        return (S @ Ab).reshape(A.shape)

    def proj_tangent(self, Y, V):
        return V - self.sym_block_product(Y, Y, V)

    def project_blocks(self, A):
        """Per-block projection onto the Stiefel manifold: row-orthonormalize
        each [d, r] block via (B B^T)^(-1/2) B (a batched eigh of the
        [n, d, d] Gram matrices; Jacobi sweeps with `capturable`)."""
        B = self._blocks(A)
        G = B @ B.transpose(-1, -2)
        lam, V = linalg.eigh(G, self.capturable)
        inv_sqrt = (V * (1.0 / torch.sqrt(torch.clamp(lam, min=1e-12)))
                    [:, None, :]) @ V.transpose(-1, -2)
        return (inv_sqrt @ B).reshape(A.shape)

    def retract(self, Y, V):
        return self.project_blocks(Y + V)

    def riemannian_grad(self, Y):
        return self.proj_tangent(Y, self.apply_Q(Y))

    def hess_vp(self, Y, nabla, V):
        """Proj(Q V - SymBlockDiag correction) (eq. (44) of the SE-Sync
        tech report)."""
        E = self.apply_Q(V) - self.sym_block_product(V, Y, nabla)
        return self.proj_tangent(Y, E)

    def precondition(self, Y, V):
        P = (self.jac_inv @ self._blocks(V)).reshape(V.shape)
        return self.proj_tangent(Y, P)

    def tnt_model(self) -> TNTModel:
        """The rank-r problem as a one-problem TNTModel (run with
        solvers.tnt.tnt_one)."""
        def grad_and_nabla(Y):
            QY = self.apply_Q(Y)
            return self.proj_tangent(Y, QY), QY

        return TNTModel(objective=self.objective,
                        grad_and_nabla=grad_and_nabla,
                        hess_vp=self.hess_vp,
                        precondition=self.precondition,
                        retract=self.retract)

    # ------------------------------------------------------- certification

    def Lambda_blocks(self, Y):
        """Dual certificate blocks: Lambda_i = sym((Q Y)_i Y_i^T)."""
        QY = self._blocks(self.apply_Q(Y))
        L = QY @ self._blocks(Y).transpose(-1, -2)
        return 0.5 * (L + L.transpose(-1, -2))

    def apply_S(self, Lam, V):
        """S v = Q v - Lambda v with Lambda block-diagonal."""
        return self.apply_Q(V) - (Lam @ self._blocks(V)).reshape(V.shape)

    # ------------------------------------------------------- solution IO

    def round_solution(self, Y):
        """Rank-d rounding: global SVD to the top-d subspace, then per-block
        SO(d) projection (kernel K2 at d = 3) with det alignment."""
        U, s, _ = torch.linalg.svd(Y, full_matrices=False)
        Yd = U[:, :self.d] * s[:self.d]  # [nd, d]
        Q = Yd.reshape(self.n, self.d, self.d)
        # Align the global reflection: majority determinant vote.
        dets = torch.linalg.det(Q.transpose(-1, -2))
        flip = torch.where(torch.sum(torch.sign(dets)) < 0, -1.0, 1.0).to(
            Q.dtype)
        Q = torch.cat([Q[..., :, :-1], Q[..., :, -1:] * flip], dim=-1)
        return project_sod(Q.transpose(-1, -2).contiguous(), self.kernels)

    def recover_translations(self, R):
        """Optimal translations given rotations, t[0] = 0."""
        c = (R[self.ei] @ self.et[:, :, None])[..., 0]
        tw = self.tau[:, None] * c
        b = R.new_zeros((self.n, self.d)).index_add_(0, self.ei, -tw)
        b.index_add_(0, self.ej, tw)
        t1 = self._lred_solve(b[1:])
        return torch.cat([R.new_zeros((1, self.d)), t1], dim=0)


@dataclasses.dataclass
class SESyncExplicit:
    """Explicit formulation: joint minimization over (t [n, r], Y [n d, r]).

    Translations stay explicit variables (the reference's
    Formulation::Explicit); the rank-r lift places both the translations and
    the Stiefel blocks in R^r:

        F(t, Y) = 1/2 sum_e  tau_e |t_i + Y_i^T t~_e - t_j|^2
                           + kappa_e |R~_e^T Y_i - Y_j|_F^2

    F is a homogeneous quadratic in (t, Y), so its Euclidean gradient is
    linear and is its own Hessian-vector product (analytic, below); the
    Riemannian Hessian adds the Stiefel curvature correction on the Y part.
    """

    base: SESyncProblem
    Ldiag_inv: torch.Tensor  # [n] Jacobi inverse of the tau-Laplacian diagonal

    def _residuals(self, t, Y):
        b = self.base
        B = b._blocks(Y)
        Bi = B[b.ei]
        rt = t[b.ei] + torch.einsum("ear,ea->er", Bi, b.et) - t[b.ej]
        rR = b.eR.transpose(-1, -2) @ Bi - B[b.ej]
        return B, rt, rR

    def objective(self, x):
        b = self.base
        _, rt, rR = self._residuals(*x)
        return 0.5 * (torch.sum(b.tau * torch.sum(rt * rt, -1))
                      + torch.sum(b.kappa * torch.sum(rR * rR, (-1, -2))))

    def _eucl_grad(self, x):
        """(dF/dt, dF/dY): u = tau r_t scattered +/- onto t_i / t_j;
        t~ u^T + R~ kappa r_R onto B_i and -kappa r_R onto B_j."""
        b = self.base
        t, Y = x
        B, rt, rR = self._residuals(t, Y)
        u = b.tau[:, None] * rt
        E = b.kappa[:, None, None] * rR
        gt = torch.zeros_like(t).index_add_(0, b.ei, u)
        gt.index_add_(0, b.ej, -u)
        Gi = b.et[:, :, None] * u[:, None, :] + b.eR @ E
        gB = torch.zeros_like(B).index_add_(0, b.ei, Gi)
        gB.index_add_(0, b.ej, -E)
        return gt, gB.reshape(Y.shape)

    def proj_tangent(self, x, v):
        return (v[0], self.base.proj_tangent(x[1], v[1]))

    def riemannian_grad(self, x, nabla=None):
        if nabla is None:
            nabla = self._eucl_grad(x)
        return self.proj_tangent(x, nabla)

    def hess_vp(self, x, nabla, v):
        Hv = self._eucl_grad(v)
        HvY = Hv[1] - self.base.sym_block_product(v[1], x[1], nabla[1])
        return self.proj_tangent(x, (Hv[0], HvY))

    def precondition(self, x, v):
        pt = self.Ldiag_inv[:, None] * v[0]
        pY = self.base.precondition(x[1], v[1])
        return (pt, pY)

    def retract(self, x, v):
        return (x[0] + v[0], self.base.project_blocks(x[1] + v[1]))

    def tnt_model(self) -> TNTModel:
        def grad_and_nabla(x):
            nabla = self._eucl_grad(x)
            return self.proj_tangent(x, nabla), nabla

        return TNTModel(objective=self.objective,
                        grad_and_nabla=grad_and_nabla,
                        hess_vp=self.hess_vp,
                        precondition=self.precondition,
                        retract=self.retract)


def build_sesync_explicit(meas: Measurements, dtype=torch.float64,
                          device=None) -> SESyncExplicit:
    base = build_sesync_problem(meas, dtype=dtype, device=device)
    Ldiag = np.zeros((meas.num_poses,))
    np.add.at(Ldiag, meas.i, meas.tau)
    np.add.at(Ldiag, meas.j, meas.tau)
    # The tau-Laplacian is singular along the all-ones gauge direction; the
    # Jacobi diagonal is strictly positive on connected graphs.
    return SESyncExplicit(base=base, Ldiag_inv=torch.as_tensor(
        1.0 / Ldiag, dtype=dtype, device=base.tau.device))


def build_sesync_problem(meas: Measurements, dtype=torch.float64,
                         formulation: str = "simplified",
                         dense_limit: int = 4096,
                         device=None) -> SESyncProblem:
    """The SE-Sync problem of `meas` on the CUDA card unless `device` names
    another (`device="cpu"`)."""
    dev = resolve_device(device)
    P, d, m = meas.num_poses, meas.d, len(meas)
    tau, i, j = meas.tau, meas.i, meas.j
    lred_host = None
    if P > dense_limit:
        # Sparse-direct reduced-Laplacian solve on the host: the dense
        # inverse is O(P^3) time and O(P^2) memory, one SuperLU
        # factorization of the (very sparse) graph Laplacian takes seconds.
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        Lsp = sp.coo_matrix(
            (np.concatenate([tau, tau, -tau, -tau]),
             (np.concatenate([i, j, i, j]), np.concatenate([i, j, j, i]))),
            shape=(P, P)).tocsc()
        lu = spla.splu(Lsp[1:, 1:].tocsc())

        def lred_host(u):
            return lu.solve(np.asarray(u, np.float64)).astype(u.dtype)

        Lred_inv = np.zeros((1, 1))
    else:
        L = np.zeros((P, P))
        np.add.at(L, (i, i), tau)
        np.add.at(L, (j, j), tau)
        np.add.at(L, (i, j), -tau)
        np.add.at(L, (j, i), -tau)
        Lred_inv = np.linalg.inv(L[1:, 1:])

    jac = np.zeros((P, d, d))
    eye = np.eye(d)
    np.add.at(jac, i, meas.kappa[:, None, None] * eye)
    np.add.at(jac, j, meas.kappa[:, None, None] * eye)
    lam_max = np.abs(jac).sum(axis=(1, 2)).max()
    jac += (lam_max / 1e6) * eye
    jac_inv = np.linalg.inv(jac)

    def cast(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def ix(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    return SESyncProblem(
        d=d, n=P, m=m, ei=ix(i), ej=ix(j), eR=cast(meas.R), et=cast(meas.t),
        kappa=cast(meas.kappa), tau=cast(meas.tau),
        Lred_inv=cast(Lred_inv), jac_inv=cast(jac_inv),
        formulation=formulation, lred_host=lred_host)
