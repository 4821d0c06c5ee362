"""Pairwise consistency maximization (PCM) outlier rejection (torch port of
dpgo_tpu/pcm.py).

For each node pair, build the pairwise-consistency graph of its inter-node
measurements (edge (p, q) when the composed loop

    T_p(i0<-j0) o T_est(j0<-j1) o T_q^{-1}(j1<-i1) o T_est(i1<-i0)

is within tolerance of the identity: error = sqrt(kappa |R_loop - I|^2 +
tau |t_loop|^2), reference PCM.cpp:226-230), then keep the maximum mutually
consistent subset by max clique.

The loop-error matrix of a node pair is one group of batched products on
the device (`loop_errors`), followed by one read of its boolean mask,
counted in `HostSyncs`; the max-clique search runs on the host, in the
native C++ solver (`io/native.py`) when it builds, else in Python
(`CliqueRoutes` records which ran). The order of node pairs, the
orientation flips, the `<=` comparison and the incremental solver's
adjacency layout follow the JAX package exactly, including where its batch
and incremental pipelines disagree (the loop error is not symmetric in
p and q, and `PCMSolver.update` mirrors the cross block).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpgo_tpu_torch.graph import make_partition
from dpgo_tpu_torch.io.g2o import Measurements
from dpgo_tpu_torch.utils import HostSyncs, resolve_device


@dataclasses.dataclass(frozen=True)
class PCMOptions:
    tolerance: float = 0.2
    weighted: bool = False
    exact: bool = True
    exact_limit: int = 64  # fall back to the heuristic above this size
    # Use the native C++ branch-and-bound (native/max_clique.cpp) when it
    # builds; the Python bitset solver below is the fallback. With the
    # native solver the exact path stays fast well past exact_limit.
    native: bool = True


class CliqueRoutes:
    """Clique solves by route since the last `reset()`: "native" (the C++
    solver), "python" (`max_clique_exact`) and "heuristic"
    (`max_clique_heuristic`)."""

    counts = {"native": 0, "python": 0, "heuristic": 0}

    @classmethod
    def reset(cls) -> None:
        cls.counts = dict.fromkeys(cls.counts, 0)


def loop_errors(P, Q) -> torch.Tensor:
    """Cross loop-error matrix between two sets of oriented measurements.

    P and Q are tuples of tensors on one device and of one type (meas_R
    [m,d,d], meas_t [m,d], kappa [m], tau [m], ti [m,d], Ri [m,d,d], tj
    [m,d], Rj [m,d,d]): alpha->beta oriented measurements with the current
    endpoint pose estimates. Returns err [mP, mQ] with err[p, q] the
    composed-loop deviation

        e = sqrt(kap |R_loop - I|^2 + ta |t_loop|^2)

    (reference evaluate_consistency, PCM.cpp:226-230). err[p, q] and
    err[q, p] close the same loop from different base frames: the rotation
    part agrees, the translation part does not."""
    R_p, t_p, kap_p, tau_p, ti_p, Ri_p, tj_p, Rj_p = P
    R_q, t_q, kap_q, tau_q, ti_q, Ri_q, tj_q, Rj_q = Q
    d = t_p.shape[-1]
    es = torch.einsum

    # B[p,q] = R_jp^T R_jq ; D[q,p] = R_iq^T R_ip
    B = es("pba,qbc->pqac", Rj_p, Rj_q)
    tB = es("pba,qb->pqa", Rj_p, tj_q) - es("pba,pb->pa", Rj_p,
                                             tj_p)[:, None, :]
    # chain: A = T_p ; AB ; ABC with C = T_q^{-1} ; ABCD with D = T(i1<-i0)
    AB_R = es("pab,pqbc->pqac", R_p, B)
    AB_t = t_p[:, None, :] + es("pab,pqb->pqa", R_p, tB)
    C_R = R_q.transpose(-1, -2)
    C_t = -es("qba,qb->qa", R_q, t_q)
    ABC_R = es("pqab,qbc->pqac", AB_R, C_R)
    ABC_t = AB_t + es("pqab,qb->pqa", AB_R, C_t)
    D_R = es("qba,pbc->qpac", Ri_q, Ri_p)
    D_t = es("qba,pb->qpa", Ri_q, ti_p) - es("qba,qb->qa", Ri_q,
                                              ti_q)[:, None, :]
    R_loop = es("pqab,qpbc->pqac", ABC_R, D_R)
    t_loop = ABC_t + es("pqab,qpb->pqa", ABC_R, D_t)

    kap = 0.5 * (kap_p[:, None] + kap_q[None, :])
    ta = 0.5 * (tau_p[:, None] + tau_q[None, :])
    eye = torch.eye(d, dtype=R_loop.dtype, device=R_loop.device)
    return torch.sqrt(kap * ((R_loop - eye) ** 2).sum((-1, -2))
                      + ta * (t_loop ** 2).sum(-1))


def _on(arrays, device, dtype) -> tuple:
    return tuple(torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
                 for x in arrays)


def pairwise_consistency(meas_R, meas_t, kappa, tau, ti, Ri, tj, Rj,
                         tolerance: float, weighted: bool, device=None,
                         dtype=torch.float64,
                         syncs: HostSyncs | None = None) -> np.ndarray:
    """Boolean consistency matrix for one node pair (host numpy).

    Inputs are alpha->beta oriented measurements (R [m,d,d], t [m,d]) and
    the current estimates of their endpoint poses (ti/Ri in alpha, tj/Rj in
    beta), host arrays; the loop errors run on `device` in `dtype`, and the
    mask is read back once."""
    device = resolve_device(device)
    syncs = syncs or HostSyncs()
    m = np.shape(meas_t)[0]
    if not weighted:
        kappa = np.ones((m,))
        tau = np.ones((m,))
    A = _on((meas_R, meas_t, kappa, tau, ti, Ri, tj, Rj), device, dtype)
    adj = syncs.read(loop_errors(A, A) <= tolerance)
    np.fill_diagonal(adj, False)
    return adj


def max_clique_exact(adj: np.ndarray) -> np.ndarray:
    """Exact max clique by bitset branch-and-bound with greedy-coloring
    bound (Pattabiraman-style; fmc/findClique.h)."""
    n = adj.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    nb = [0] * n
    for v in range(n):
        mask = 0
        for u in np.nonzero(adj[v])[0]:
            mask |= 1 << int(u)
        nb[v] = mask

    best = [0, 0]  # size, mask

    def popcount(x):
        return bin(x).count("1")

    def expand(cand_mask, cur_mask, cur_size):
        if cand_mask == 0:
            if cur_size > best[0]:
                best[0] = cur_size
                best[1] = cur_mask
            return
        if cur_size + popcount(cand_mask) <= best[0]:
            return
        # Pick candidates in order.
        m = cand_mask
        while m:
            v = (m & -m).bit_length() - 1
            m &= m - 1
            if cur_size + popcount(cand_mask) <= best[0]:
                return
            expand(cand_mask & nb[v], cur_mask | (1 << v), cur_size + 1)
            cand_mask &= ~(1 << v)

    expand((1 << n) - 1, 0, 0)
    out = np.zeros(n, dtype=bool)
    for v in range(n):
        if best[1] >> v & 1:
            out[v] = True
    return out


def max_clique_heuristic(adj: np.ndarray) -> np.ndarray:
    """Greedy heuristic: repeatedly add the highest-degree compatible vertex
    (fmc maxCliqueHeu)."""
    n = adj.shape[0]
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    deg = adj.sum(axis=1)
    cand = np.ones(n, dtype=bool)
    while cand.any():
        scores = np.where(cand, deg, -1)
        v = int(np.argmax(scores))
        out[v] = True
        cand &= adj[v]
        cand[v] = False
    return out


def _max_clique(adj: np.ndarray, exact: bool, native: bool) -> np.ndarray:
    """The clique of one adjacency by the route the options allow, recorded
    in CliqueRoutes: the native solver, else the Python exact solver or the
    heuristic."""
    if native:
        from dpgo_tpu_torch.io.native import max_clique_native
        mask = max_clique_native(adj, exact=exact)
        if mask is not None:
            CliqueRoutes.counts["native"] += 1
            return mask
    CliqueRoutes.counts["python" if exact else "heuristic"] += 1
    return max_clique_exact(adj) if exact else max_clique_heuristic(adj)


def _oriented_pairs(meas: Measurements, num_nodes: int):
    """Per node pair (a < b) with at least two inter-node edges, in the order
    the pairs are first met along the edge list: (edge indices, alpha->beta
    oriented R [m,d,d] and t [m,d], pose ids gi in alpha, gj in beta)."""
    part = make_partition(meas.num_poses, num_nodes)
    ni = part.node_of[meas.i]
    nj = part.node_of[meas.j]
    pairs: dict = {}
    for e in np.nonzero(ni != nj)[0]:
        a, b = sorted((int(ni[e]), int(nj[e])))
        pairs.setdefault((a, b), []).append(int(e))
    for (a, _), es in pairs.items():
        es = np.asarray(es)
        if len(es) < 2:
            continue
        flip = ni[es] != a
        Rm = meas.R[es].copy()
        tm = meas.t[es].copy()
        Rm[flip] = np.swapaxes(Rm[flip], -1, -2)
        tm[flip] = -np.einsum("eab,eb->ea", Rm[flip], meas.t[es][flip])
        gi = np.where(flip, meas.j[es], meas.i[es])
        gj = np.where(flip, meas.i[es], meas.j[es])
        yield es, Rm, tm, gi, gj


def pcm_filter(meas: Measurements, num_nodes: int, t: np.ndarray,
               R: np.ndarray, opts: PCMOptions = PCMOptions(), device=None,
               dtype=torch.float64, syncs: HostSyncs | None = None
               ) -> tuple[Measurements, np.ndarray]:
    """Run PCM on every node pair's inter edges against the estimate (t, R)
    (global host arrays), the loop errors on `device` in `dtype`.

    Returns (filtered measurements, keep mask over the original edges).
    Intra-node edges are always kept (the reference wires PCM on inter-node
    loop closures only)."""
    device = resolve_device(device)
    keep = np.ones(len(meas), dtype=bool)
    for es, Rm, tm, gi, gj in _oriented_pairs(meas, num_nodes):
        adj = pairwise_consistency(
            Rm, tm, meas.kappa[es], meas.tau[es], t[gi], R[gi], t[gj],
            R[gj], opts.tolerance, opts.weighted, device, dtype, syncs)
        exact = opts.exact and (len(es) <= opts.exact_limit or opts.native)
        keep[es[~_max_clique(adj, exact, opts.native)]] = False
    return meas.select(keep), keep


class PCMSolver:
    """Incremental PCM pipeline for one node pair.

    The reference's streaming interface (PCM::PCMSolver<MCS, Evaluator>,
    PCM/PCM.hpp:99-191, and DPGO::PCM::update, DPGO/PCM.h:43-52):
    measurements arrive in batches; each `update` scores only the NEW
    measurements' loop errors against all prior ones and extends the
    adjacency matrix; `solve_exact` / `solve_heuristic` re-run max clique on
    the accumulated adjacency. The accumulated measurements stay on
    `device`; each update reads its new rows of the mask back once.

    As in the JAX package, the new-vs-old block is scored in the new
    measurements' frames (`loop_errors(new, old)`) and mirrored into the
    old rows, so the adjacency is symmetric where the batch filter's is
    not."""

    def __init__(self, opts: PCMOptions = PCMOptions(), device=None,
                 dtype=torch.float64, syncs: HostSyncs | None = None):
        self.opts = opts
        self.device = resolve_device(device)
        self.dtype = dtype
        self.syncs = syncs or HostSyncs()
        self._data = None        # accumulated oriented tensors (tuple)
        self.adj = np.zeros((0, 0), dtype=bool)
        self._results = None

    @property
    def num_measurements(self) -> int:
        return self.adj.shape[0]

    def update(self, meas_R, meas_t, kappa, tau, ti, Ri, tj, Rj) -> int:
        """Add a batch of alpha->beta oriented measurements with their
        current endpoint pose estimates (host arrays); extends the
        consistency adjacency by the new rows/columns only. Returns the new
        measurement count."""
        m_new = np.shape(meas_t)[0]
        if m_new == 0:
            return self.num_measurements
        if not self.opts.weighted:
            kappa, tau = np.ones(m_new), np.ones(m_new)
        new = _on((meas_R, meas_t, kappa, tau, ti, Ri, tj, Rj), self.device,
                  self.dtype)
        tol = self.opts.tolerance
        if self._data is None:
            adj = self.syncs.read(loop_errors(new, new) <= tol)
            np.fill_diagonal(adj, False)
            self.adj = adj
            self._data = new
        else:
            old = self._data
            m_old = self.adj.shape[0]
            rows = self.syncs.read(torch.cat(
                [loop_errors(new, old), loop_errors(new, new)], dim=1) <= tol)
            cross, inner = rows[:, :m_old], rows[:, m_old:]
            np.fill_diagonal(inner, False)
            adj = np.zeros((m_old + m_new, m_old + m_new), dtype=bool)
            adj[:m_old, :m_old] = self.adj
            adj[m_old:, :m_old] = cross
            adj[:m_old, m_old:] = cross.T
            adj[m_old:, m_old:] = inner
            self.adj = adj
            self._data = tuple(torch.cat([o, n], dim=0)
                               for o, n in zip(old, new))
        self._results = None
        return self.num_measurements

    def _solve(self, exact: bool) -> np.ndarray:
        if self.num_measurements == 0:
            return np.zeros(0, dtype=bool)
        self._results = _max_clique(self.adj, exact, self.opts.native)
        return self._results

    def solve_exact(self) -> np.ndarray:
        """Inlier mask over all measurements seen so far (exact clique)."""
        return self._solve(True)

    def solve_heuristic(self) -> np.ndarray:
        return self._solve(False)

    @property
    def results(self) -> np.ndarray | None:
        return self._results


def pcm_filter_incremental(meas: Measurements, num_nodes: int, t: np.ndarray,
                           R: np.ndarray, opts: PCMOptions = PCMOptions(),
                           batch: int = 1, device=None, dtype=torch.float64,
                           syncs: HostSyncs | None = None
                           ) -> tuple[Measurements, np.ndarray]:
    """pcm_filter through the incremental PCMSolver pipeline: each node
    pair's inter edges stream in batches of `batch` (the reference's
    add_measurements/update flow), then one clique solve per pair.

    It keeps the same edges as `pcm_filter` when the loop errors are
    symmetric (as on the ground truth); on an estimate they are not, the
    mirrored cross block makes the consistency graph differ, and the two
    filters may keep different edges (as in the JAX package)."""
    device = resolve_device(device)
    keep = np.ones(len(meas), dtype=bool)
    step = max(batch, 1)
    for es, Rm, tm, gi, gj in _oriented_pairs(meas, num_nodes):
        solver = PCMSolver(opts, device, dtype, syncs)
        m = len(es)
        for pos in range(0, m, step):
            sl = slice(pos, min(pos + step, m))
            solver.update(Rm[sl], tm[sl], meas.kappa[es][sl],
                          meas.tau[es][sl], t[gi[sl]], R[gi[sl]],
                          t[gj[sl]], R[gj[sl]])
        exact = opts.exact and (m <= opts.exact_limit or opts.native)
        mask = solver.solve_exact() if exact else solver.solve_heuristic()
        keep[es[~mask]] = False
    return meas.select(keep), keep
