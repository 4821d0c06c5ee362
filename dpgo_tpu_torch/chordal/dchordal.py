"""Distributed chordal initialization (DChordal): four Nesterov-accelerated
Jacobi-MM linear stages, batched over the node axis (torch port of
dpgo_tpu/chordal/dchordal.py).

  stage 0  per-node solve of the intra-edge subgraph (chordal init + TNT
           refinement with the block-Jacobi preconditioner)
  stage 1  reduced rotation: one d x d unknown per NODE aligning the local
           solutions, cost kappa |S_a nR_e - S_b|^2 with
           nR_e = R_tail^loc R~ (R_head^loc)^T
  stage 2  full per-pose rotation: linear least squares in ambient d x d
           blocks, per-node exact solves
  stage 3  reduced translation: one offset per node
  stage 4  full per-pose translation

Every stage is the main MM solver's pattern restricted to a linear block:
per-node quadratic G = (intra part) + 2 x (inter self part) + xi, and an
exact per-node solve of G x = -g(Y) at the Nesterov-extrapolated point
Y = (1 + gamma) X_k - gamma X_{k-1}. All nodes update simultaneously
(Jacobi); the 2x inter majorization guarantees descent.

Instead of pinning node 0 as a gauge anchor, the near-null gauge modes go
through the same eigendecomposition-split inverse as the translation
solves; the result differs only by a global gauge transform.

A run is a host set-up (`_setup`: the multigraph, both problem sets, the
per-node chordal seeds, and stage 2's rotation system and split inverse,
built in float64 numpy on the host as in the JAX package, then every copy
to the device) followed by the stages (`_stages`), which run on `device`
in `dtype` and read nothing from the host. On a CUDA card the stages run
as one captured program replayed once (`graph_nodes.run_once`): stage 0's
TNT and its CG are WHILE nodes, and each Nesterov stage is one
`utils.fixed_loop`, the counterpart of the JAX package's `lax.fori_loop`.
Elsewhere, or with `graph=False`, they run on the host-read route, where
only stage 0's TNT reads its flags. The SO(3) projections of stages 0 and
2 and of stage 0's retraction go through kernel K2 on a CUDA device
(`kernels=False`: the plain version).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from dpgo_tpu_torch.graph import MultiGraph, build_multigraph
from dpgo_tpu_torch.io.g2o import Measurements
from dpgo_tpu_torch.manifold import project_sod
from dpgo_tpu_torch.objective import EdgeData, evaluate_f
from dpgo_tpu_torch.problem import NodeState, build_node_problems
from dpgo_tpu_torch.sesync.init import chordal_initialization
from dpgo_tpu_torch.solvers.mm import _make_tnt_model
from dpgo_tpu_torch.solvers.tnt import TNTParams, tnt
from dpgo_tpu_torch.utils import HostSyncs, fixed_loop, resolve_device


@dataclasses.dataclass(frozen=True)
class DChordalConfig:
    """Stage iteration counts of the reference driver."""

    iters_reduced_R: int = 100
    iters_full_R: int = 400
    iters_reduced_t: int = 150
    iters_full_t: int = 250
    reg: float = 1e-12
    refine_stage0: bool = True
    stage0_tnt_iters: int = 20


def chordal_objective(meas: Measurements, t, R) -> float:
    """Objective monitor for the chordal pipeline (logging only): the PGO
    cost at the current (possibly non-SO(d)) iterate, the linear
    least-squares cost the chordal stages minimize."""
    t, R = torch.as_tensor(t), torch.as_tensor(R)
    edges = EdgeData.from_measurements(meas, dtype=t.dtype, device=t.device)
    return float(evaluate_f(edges, t, R))


def _intra_only_multigraph(mg: MultiGraph) -> MultiGraph:
    return dataclasses.replace(mg, e_kap=np.zeros_like(mg.e_kap),
                               e_tau=np.zeros_like(mg.e_tau))


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a 0-d tensor, as numpy's and
    the JAX package's. The card's `torch.sqrt` is one; the CPU's goes
    through MKL's vector library, which is up to one unit in the last
    place off, so on the CPU numpy takes the root."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _nesterov_scan(step_fn, X0: torch.Tensor, num_iters: int, name: str):
    """X_{k+1} = step_fn(Y_k) with Y = (1 + gamma) X_k - gamma X_{k-1}, a
    fixed number of times (`utils.fixed_loop`, counted as `name`). The
    carry is (X, X_prev, s) with s a 0-d tensor of X0's type, as the JAX
    package's `lax.fori_loop` carry; each operation of the scalar
    recurrence is its own op, so no fused multiply-add changes its
    rounding."""

    def body(carry):
        X, X_prev, s = carry
        s1 = 0.5 + 0.5 * _sqrt0(4.0 * s * s + 1.0)
        gamma = (s - 1.0) / s1
        Y = (1.0 + gamma) * X - gamma * X_prev
        return step_fn(Y), X, s1

    s0 = torch.ones((), dtype=X0.dtype, device=X0.device)
    X, _, _ = fixed_loop(num_iters, body, (X0, X0, s0), name=name)
    return X


def _split_inverse(mats: np.ndarray, reg: float):
    """Eigen-split inverse of a stack of PSD matrices + reg I (same treatment
    as the translation solver in problem.py)."""
    lam, V = np.linalg.eigh(mats)
    lam = np.maximum(lam, 0.0)
    scale = np.maximum(lam.max(axis=1, keepdims=True), 1.0)
    null = lam < 1e-10 * scale
    kmax = max(int(null.sum(axis=1).max()), 1)
    N, n = mats.shape[0], mats.shape[1]
    red = np.zeros_like(mats)
    nullV = np.zeros((N, n, kmax))
    for a in range(N):
        w = np.where(null[a], 0.0, 1.0 / (lam[a] + reg))
        red[a] = (V[a] * w[None, :]) @ V[a].T
        k = int(null[a].sum())
        nullV[a][:, :k] = V[a][:, null[a]]
    return red, nullV


def _apply_split(red, nullV, reg, rhs):
    out = red @ rhs
    c = (nullV.transpose(-1, -2) @ rhs) / reg
    return out + nullV @ c


def _rotation_system(mg: MultiGraph) -> np.ndarray:
    """Stage 2's per-node rotation operator G_R [N, n0 d, n0 d] (float64):
    the intra chordal Laplacian blocks plus 2 kappa I per inter edge at its
    own pose."""
    N, n0m, d = mg.num_nodes, mg.n0_max, mg.d
    GR = np.zeros((N, n0m * d, n0m * d))
    eye = np.eye(d)
    ar = np.arange(d)

    def add_blocks(M, rows, cols, vals):
        r = rows[:, None, None] * d + ar[None, :, None]
        c = cols[:, None, None] * d + ar[None, None, :]
        np.add.at(M, (r, c), vals)

    for a in range(N):
        ii, jj = mg.a_i[a], mg.a_j[a]
        kap = (mg.a_kap[a] * mg.a_mask[a])[:, None, None]
        add_blocks(GR[a], ii, ii, kap * eye)
        add_blocks(GR[a], jj, jj, kap * eye)
        add_blocks(GR[a], ii, jj, -kap * mg.a_R[a])
        add_blocks(GR[a], jj, ii, -kap * np.swapaxes(mg.a_R[a], -1, -2))
        ek = (mg.e_kap[a] * mg.e_mask[a])[:, None, None]
        add_blocks(GR[a], mg.e_self[a], mg.e_self[a], 2 * ek * eye)
    return GR


def graph_route(graph, device: torch.device) -> bool:
    """Whether DChordal's stages run as one captured program: `graph` as
    asked, None for "on a CUDA card". Asking for it on another device
    raises (a CUDA graph exists only on the card)."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("DChordal's captured route runs on a CUDA card; "
                         f"got {device}: pass graph=False or None")
    return bool(graph)


@dataclasses.dataclass
class _Setup:
    """Everything DChordal's stages read, made on the host and copied to
    the device before they start (no host-to-device copy inside the
    stages): the two problem sets, the halo maps, stage 0's seeds, stage
    2's split inverse, the global row map, and the seconds by part."""

    cfg: DChordalConfig
    probs: object          # NodeProblem of the full multigraph
    probs0: object         # NodeProblem of the intra-only multigraph
    halo_owner: torch.Tensor
    halo_lpose: torch.Tensor
    R_seed: torch.Tensor   # [N, n0, d, d] per-node chordal seeds
    GR_red: torch.Tensor   # stage 2's split inverse
    GR_null: torch.Tensor
    node_of: torch.Tensor
    local_of: torch.Tensor
    zeros_t: torch.Tensor  # [N, n0, d]
    zeros_h: torch.Tensor  # [N, n1, d]
    eye_h: torch.Tensor    # [N, n1, d, d]
    S0: torch.Tensor       # [N, d, d] identities
    u0: torch.Tensor       # [N, d] zeros
    seconds: dict

    def with_kernels(self, kernels: bool) -> "_Setup":
        """This set-up with K2 on or off (the plain versions) in both
        problem sets."""
        if kernels:
            return self
        return dataclasses.replace(
            self, probs=dataclasses.replace(self.probs, kernels=False),
            probs0=dataclasses.replace(self.probs0, kernels=False))


def _setup(meas: Measurements, num_nodes: int, cfg: DChordalConfig,
           dtype, device: torch.device) -> _Setup:
    """The host part of DChordal: the multigraph, both problem sets, the
    per-node chordal seeds, stage 2's rotation system and split inverse
    (float64 numpy), and every copy to `device` the stages read."""
    clock = time.perf_counter
    t0 = clock()
    part, nodes, mg = build_multigraph(meas, num_nodes)
    d, N, n0m, n1m = mg.d, mg.num_nodes, mg.n0_max, mg.n1_max
    xi = cfg.reg
    probs = build_node_problems(mg, xi=max(xi, 1e-12), dtype=dtype,
                                device=device)
    probs0 = build_node_problems(_intra_only_multigraph(mg),
                                 xi=max(xi, 1e-12), dtype=dtype,
                                 device=device)
    t1 = clock()
    R_seed = np.tile(np.eye(d), (N, n0m, 1, 1))
    for a, g in enumerate(nodes):
        if len(g.intra) == 0:
            continue
        sub = Measurements(
            i=g.intra.i, j=g.intra.j, R=g.intra.R, t=g.intra.t,
            kappa=g.intra.kappa, tau=g.intra.tau, num_poses=g.n0, d=d)
        try:
            R_seed[a, :g.n0] = chordal_initialization(sub)
        except RuntimeError:
            pass  # disconnected intra graph (singular factor): identity seed
    t2 = clock()
    GR_red, GR_null = _split_inverse(_rotation_system(mg), xi)
    t3 = clock()

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(d, dtype=dtype, device=device)
    s = _Setup(cfg=cfg, probs=probs, probs0=probs0,
               halo_owner=dev(mg.halo_owner, torch.int64),
               halo_lpose=dev(mg.halo_lpose, torch.int64),
               R_seed=dev(R_seed), GR_red=dev(GR_red), GR_null=dev(GR_null),
               node_of=dev(part.node_of, torch.int64),
               local_of=dev(part.local_of, torch.int64),
               zeros_t=zeros(N, n0m, d), zeros_h=zeros(N, n1m, d),
               eye_h=eye.expand(N, n1m, d, d), S0=eye.repeat(N, 1, 1),
               u0=zeros(N, d), seconds={})
    s.seconds.update(problems=t1 - t0, seeds=t2 - t1, rotation_system=t3 - t2,
                     copies=clock() - t3)
    return s


def _stages(s: _Setup, syncs: HostSyncs):
    """Stage 0's translation recovery and TNT, stages 1-4 and the gather
    into global rows, all on the device: global (t [P, d], R [P, d, d]) as
    device tensors. Reads nothing on the host but the TNT's and CG's flags
    on the host route (counted in `syncs`); the stage loops are
    `fixed_loop`s ("dchordal.reduced_R", "dchordal.full_R",
    "dchordal.reduced_t", "dchordal.full_t")."""
    cfg, probs, probs0 = s.cfg, s.probs, s.probs0
    kernels = probs.kernels
    N, n0m, d = s.zeros_t.shape
    xi = cfg.reg
    zeros_t, zeros_h = s.zeros_t, s.zeros_h
    halo_owner, halo_lpose = s.halo_owner, s.halo_lpose

    def exchange(arr):
        return arr[halo_owner, halo_lpose]

    # ---------------- stage 0: per-node local solutions -------------------
    R_loc = s.R_seed
    # Pure-coupling rhs (g = 0): anchor the null response at zero.
    t_loc = probs0.recover_translations(R_loc, zeros_t, t_anchor=zeros_t,
                                        syncs=syncs)

    if cfg.refine_stage0:
        # Per-node Riemannian refinement of the intra-only problem (the
        # reference runs full SE-Sync per node), all nodes as TNT lanes.
        params = TNTParams(max_iterations=cfg.stage0_tnt_iters,
                           max_iterations_accepted=cfg.stage0_tnt_iters)
        g, f = probs0.surrogate_g_f(NodeState(t=t_loc, R=R_loc, th=zeros_h,
                                              Rh=s.eye_h))
        # Intra-only problems are all null-space (no inter edges): anchor
        # the translation solves at the start (see solve_mG00).
        model = _make_tnt_model(probs0, g[0], g[1], f, t_anchor=t_loc,
                                syncs=syncs)
        t_loc, R_loc, _, _, _ = tnt(model, t_loc, R_loc, params, syncs=syncs)

    # ---------------- stage 1: reduced rotation ---------------------------
    b = probs._b
    e_self, e_slot = probs.e_self, probs.e_slot
    sel = probs.e_self_is_i
    sel_m = sel[..., None, None]
    ekap, etau = probs.e_kap, probs.e_tau
    Rh = exchange(R_loc)
    # Per-edge alignment nR = R_tail R~ R_head^T (tail/head may be halo).
    R_self, R_other = R_loc[b, e_self], Rh[b, e_slot]
    R_tail = torch.where(sel_m, R_self, R_other)
    R_head = torch.where(sel_m, R_other, R_self)
    nR = R_tail @ probs.e_R @ R_head.transpose(-1, -2)

    # The neighbor node of each inter edge.
    nb_node = halo_owner[b, e_slot]
    sum_kap = ekap.sum(1)
    denomR = 2.0 * sum_kap + xi

    def stage1_step(S):
        S_nb = S[nb_node]  # [N, m1, d, d]
        T = torch.where(sel_m, S_nb @ nR.transpose(-1, -2), S_nb @ nR)
        pull = (ekap[..., None, None] * T).sum(1)
        num = (sum_kap + xi)[:, None, None] * S + pull
        # Padded edges (kappa = 0) add nothing; denom >= xi > 0.
        return num / denomR[:, None, None]

    S = _nesterov_scan(stage1_step, s.S0, cfg.iters_reduced_R,
                       "dchordal.reduced_R")
    S = project_sod(S, kernels)
    R1 = S[:, None] @ R_loc

    # ---------------- stage 2: full rotation ------------------------------
    # Q-storage tall systems: columns decouple; per-node dense split inverse.
    GR_red, GR_null = s.GR_red, s.GR_null

    # Nodes without inter edges are uncoupled BCD blocks: their exact
    # solution is the stage-0 local solve, so stage 2 leaves them untouched
    # (a 1-node run is the extreme case).
    has_inter = (sum_kap > 0)[:, None, None, None]
    target = math.sqrt(n0m * d)

    def stage2_step(Rcur):
        # Rotation-only surrogate linear term (inter edges): translations
        # set to 0 kill the translation rows of the halves.
        (_, E_s), (_, E_o) = probs.inter_halves(
            NodeState(t=zeros_t, R=Rcur, th=zeros_h, Rh=exchange(Rcur)))
        _, gR = probs.apply_A_self_T(torch.zeros_like(E_s[..., 0]),
                                     E_o - E_s)
        gR = gR - probs.xi * Rcur
        # Solve G_R Q = -g in Q (transposed) tall storage.
        gQ = gR.transpose(-1, -2).reshape(N, n0m * d, d)
        Q = -_apply_split(GR_red, GR_null, xi, gQ)
        Rn = Q.reshape(N, n0m, d, d).transpose(-1, -2)
        # The rotation stage is homogeneous: a node with no inter-edge
        # pulls iterates a pure contraction whose magnitude decays. Scale
        # is irrelevant to the final per-block projection, so renormalize
        # only when the iterate shrinks (a no-op for coupled nodes).
        nrm = torch.sqrt(torch.sum(Rn * Rn, (1, 2, 3)))
        scale = torch.clamp(torch.where(
            nrm < 0.5 * target, target / torch.clamp(nrm, min=1e-300),
            1.0), max=1e15)
        return torch.where(has_inter, Rn * scale[:, None, None, None], R1)

    R2 = _nesterov_scan(stage2_step, R1, cfg.iters_full_R,
                        "dchordal.full_R")
    R2 = project_sod(R2, kernels)

    # ---------------- stage 3: reduced translation ------------------------
    t_loc2 = probs0.recover_translations(R2, zeros_t, t_anchor=zeros_t,
                                         syncs=syncs)
    th2, Rh2 = exchange(t_loc2), exchange(R2)
    t_self, t_other = t_loc2[b, e_self], th2[b, e_slot]
    t_tail = torch.where(sel[..., None], t_self, t_other)
    t_head = torch.where(sel[..., None], t_other, t_self)
    R_tail2 = torch.where(sel_m, R2[b, e_self], Rh2[b, e_slot])
    w = t_tail + (R_tail2 @ probs.e_t[..., None])[..., 0] - t_head
    sum_tau = etau.sum(1)
    denomT = 2.0 * sum_tau + xi

    def stage3_step(u):
        u_nb = u[nb_node]  # [N, m1, d]
        pull = torch.where(sel[..., None], u_nb - w, u_nb + w)
        num = (sum_tau + xi)[:, None] * u + (etau[..., None] * pull).sum(1)
        return num / denomT[:, None]

    u = _nesterov_scan(stage3_step, s.u0, cfg.iters_reduced_t,
                       "dchordal.reduced_t")
    t3 = t_loc2 + u[:, None, :]

    # ---------------- stage 4: full translation ---------------------------
    ett = probs.e_tau[..., None]
    Ri_at = (R2[b, probs.a_i] @ probs.a_t[..., None])[..., 0]
    # Intra constant offsets (rotations frozen): b_i += tau c_e,
    # b_j -= tau c_e.
    off = probs.a_tau[..., None] * Ri_at
    b_intra = probs._scatter(probs._fi, off) + probs._scatter(probs._fj,
                                                              -off)
    R_tail4 = torch.where(sel_m, R2[b, e_self], Rh2[b, e_slot])
    Rt_et = (R_tail4 @ probs.e_t[..., None])[..., 0]

    def stage4_step(tcur):
        # Translation-only surrogate linear term with rotations frozen: the
        # t-only residual operator is A_s^t: t -> +/- sqrt(tau) t_self and
        # the offset R_tail t~ is a constant, so g = A_s^t^T (r - 2 A_s^t
        # z_t) - xi z_t with r the full residual.
        ts, to = tcur[b, e_self], exchange(tcur)[b, e_slot]
        rr = torch.where(sel[..., None], ts, to) + Rt_et \
            - torch.where(sel[..., None], to, ts)
        contrib = torch.where(sel[..., None], ett * (rr - 2.0 * ts),
                              -ett * rr - 2.0 * ett * ts)
        g = probs._scatter(probs._fs, contrib) + b_intra - probs.xi * tcur
        # g carries -xi tcur: anchor the null response at tcur.
        return -probs.solve_mG00(g, t_anchor=tcur, syncs=syncs)

    t4 = _nesterov_scan(stage4_step, t3, cfg.iters_full_t,
                        "dchordal.full_t")

    # ---------------- assemble global -------------------------------------
    return t4[s.node_of, s.local_of], R2[s.node_of, s.local_of]


def _run(s: _Setup, kernels: bool, graph: bool, stats: dict | None = None):
    """DChordal's stages from set-up `s`, with K2 or its plain version, on
    the graph route (one captured program replayed once,
    `graph_nodes.run_once`: no host read) or the host-read route; then one
    copy of the global (t, R) to the host, as numpy. `stats` gets the
    route, the host flag reads and loop notes, the stages' seconds (to the
    copy's end) and, on the graph route, the warm-up, capture and replay
    seconds and the capture's pool in MiB."""
    sk = s.with_kernels(kernels)
    syncs = HostSyncs()
    t0 = time.perf_counter()
    if graph:
        from dpgo_tpu_torch.ops import graph_nodes
        (t, R), cap = graph_nodes.run_once(s.zeros_t.device,
                                           lambda: _stages(sk, syncs))
    else:
        t, R = _stages(sk, syncs)
    t, R = t.cpu().numpy(), R.cpu().numpy()
    info = dict(route="graph" if graph else "host", host_syncs=syncs.count,
                loops={k: list(v) for k, v in syncs.loops.items()},
                stages_s=time.perf_counter() - t0)
    if graph:
        info.update(warmup_s=cap.warmup_s, capture_s=cap.capture_s,
                    replay_s=cap.replay_s(),
                    pool_mib=cap.pool_bytes / 2**20)
    if stats is not None:
        stats.update(info)
    return t, R


def distributed_chordal_init(meas: Measurements, num_nodes: int,
                             cfg: DChordalConfig = DChordalConfig(),
                             dtype=torch.float64, device=None,
                             kernels: bool = True, graph=None,
                             stats: dict | None = None):
    """Run the 4-stage pipeline on `device` (the CUDA card unless named);
    returns global (t [P, d], R [P, d, d]) as numpy arrays.

    The host set-up (problem builds, seeds, stage 2's split inverse, the
    copies) comes first; then the stages, on a CUDA card as one captured
    program replayed once (`graph=None`; `graph=False`: the host-read
    route, the CPU's only one). `stats` gets the route, host flag reads,
    the set-up seconds by part (`setup_s`) and the stages' seconds (`_run`).
    """
    device = resolve_device(device)
    graph = graph_route(graph, device)
    s = _setup(meas, num_nodes, cfg, dtype, device)
    if stats is not None:
        stats["setup_s"] = dict(s.seconds)
    return _run(s, kernels, graph, stats)
