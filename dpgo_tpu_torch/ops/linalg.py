"""Small dense linear algebra that reads nothing on the host and captures
inside a conditional node's body: a fixed-sweep parallel Jacobi
eigensolver and a Gram-Schmidt QR, in torch operations.

`torch.linalg.eigh` on a CUDA card checks the solver's `info` with a read
on the host, so it cannot run inside a captured CUDA graph (nor under
`torch.cuda.set_sync_debug_mode("error")`). cuSOLVER's QR reads nothing,
but a captured LOBPCG with it in a WHILE body failed at the end of its
capture on the card in one process (`cudaErrorInvalidValue`) after
passing in another, so the captured programs keep cuSOLVER out of their
bodies. Those that need these (LOBPCG's Rayleigh-Ritz step and basis,
SE-Sync's per-block Stiefel projection) use the versions here
(`capturable=True`).

Jacobi: cyclic, with the round-robin ordering. A sweep is n - 1 rounds
(n rounded up to even); the n / 2 pairs (p, q) of a round are disjoint, so
their rotations commute and one product A <- J^T A J applies them all.
Each rotation zeroes a_pq (Golub and Van Loan, sym.schur2): theta = a_qq -
a_pp, t = sign(theta) 2 a_pq / (|theta| + hypot(theta, 2 a_pq)), c = 1 /
sqrt(1 + t^2), s = t c. Convergence is quadratic, so a fixed number of
sweeps (`SWEEPS`) takes the off-diagonal part to rounding for the sizes
used here (up to 12 x 12); a pair with a_pq = 0 gets the identity. The eigenvalues come sorted ascending with their
eigenvectors, as `eigh` gives them (eigenvectors agree up to sign, and
within a cluster of equal eigenvalues up to a rotation).

Gram-Schmidt: classical, each column orthogonalized twice (CGS2), so the
columns of Q are orthonormal to rounding where the basis has full rank; a
column with no content of its own beyond sqrt(eps) of the largest
diagonal so far gets a zero column of Q (Householder QR would give an
arbitrary unit vector there, which LOBPCG's basis truncation masks out in
either case)."""

from __future__ import annotations

import torch

SWEEPS = 8


def _schedule(m: int, device):
    """The round-robin schedule of an m x m Jacobi sweep (m even), made on
    the device from `arange` (no copy from the host, so it may be made
    inside a capture): per round r, the pairs (0, r + 1) and
    ((r + i) mod (m - 1) + 1, (r - i) mod (m - 1) + 1), i = 1 .. m/2 - 1,
    as flat positions in the [m * m] matrix: gathered a_pp, a_qq, a_pq
    [m - 1, 3 m/2] and scattered J_pp, J_qq, J_pq, J_qp [m - 1, 2 m]."""
    r = torch.arange(m - 1, device=device)[:, None]
    i = torch.arange(m // 2, device=device)[None, :]
    a = torch.where(i == 0, 0, torch.remainder(r + i, m - 1) + 1)
    b = torch.remainder(r - i, m - 1) + 1
    p, q = torch.minimum(a, b), torch.maximum(a, b)
    pp, qq, pq, qp = p * m + p, q * m + q, p * m + q, q * m + p
    return (torch.cat([pp, qq, pq], dim=1),
            torch.cat([pp, qq, pq, qp], dim=1))


def jacobi_eigh(A: torch.Tensor, sweeps: int = SWEEPS):
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n] as
    columns) of the symmetric [..., n, n] `A` (symmetrized first), by
    `sweeps` parallel Jacobi sweeps. An odd n is padded with a zero row
    and column, which no rotation touches (its a_pq are 0). Only device
    operations: no host read."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    A = 0.5 * (A + A.transpose(-1, -2))
    m = n + (n % 2)
    if m != n:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()
    if m > 1:
        gather_ix, scatter_ix = _schedule(m, A.device)
        k = m // 2
        flat = eye.expand(A.shape).reshape(lead + (m * m,))
        for _ in range(sweeps):
            for rnd in range(m - 1):
                app, aqq, apq = A.reshape(lead + (m * m,))[
                    ..., gather_ix[rnd]].split(k, dim=-1)
                theta = aqq - app
                g = 2.0 * apq
                den = theta.abs() + torch.hypot(theta, g)
                sg = torch.where(theta >= 0, g, -g)
                t = torch.where(den > 0, sg / torch.clamp(den, min=1e-300),
                                torch.zeros_like(den))
                c = torch.rsqrt(1.0 + t * t)
                s = t * c
                J = flat.index_copy(-1, scatter_ix[rnd],
                                    torch.cat([c, c, s, -s], dim=-1))
                J = J.reshape(A.shape)
                A = J.transpose(-1, -2) @ A @ J
                V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)[..., :n]
    V = V[..., :n, :n]
    w, order = torch.sort(w, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w, V


def gram_schmidt_qr(V: torch.Tensor):
    """(Q, R) of the tall [m, k] `V` by CGS2 (module docstring): Q [m, k]
    with orthonormal (or zero) columns, R [k, k] upper triangular with a
    non-negative diagonal, V = Q R up to rounding where V has full rank.
    Only device operations: no host read."""
    m, k = V.shape
    drop = torch.finfo(V.dtype).eps ** 0.5
    Q = torch.zeros_like(V)
    R = V.new_zeros((k, k))
    top = V.new_zeros(())
    for j in range(k):
        v = V[:, j]
        h = V.new_zeros((j,))
        for _ in range(2):
            g = Q[:, :j].T @ v
            v = v - Q[:, :j] @ g
            h = h + g
        r = torch.linalg.norm(v)
        top = torch.maximum(top, r)
        keep = r > drop * top
        Q[:, j] = torch.where(keep, v / torch.where(keep, r, 1.0), 0.0)
        R[:j, j] = h
        R[j, j] = r
    return Q, R


def eigh(A: torch.Tensor, capturable: bool = False):
    """torch.linalg.eigh(A), or with `capturable` `jacobi_eigh`."""
    return jacobi_eigh(A) if capturable else torch.linalg.eigh(A)


def qr(V: torch.Tensor, capturable: bool = False):
    """torch.linalg.qr(V) (reduced), or with `capturable`
    `gram_schmidt_qr`."""
    return gram_schmidt_qr(V) if capturable else torch.linalg.qr(V)
