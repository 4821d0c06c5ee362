"""End-to-end distributed PGO driver on one device (torch port of
dpgo_tpu/driver.py): DPGOSolver runs MM-PGO, AMM-PGO# and Anderson-
accelerated MM (`MMOptions(scheme="aa")`), DPGOStarSolver AMM-PGO*.

Single-process simulation: the node axis is a batch dimension;
communication is a gather on the stacked node states. One solver iteration
= iterate -> communicate -> update.

Two routes for the same step (utils.py, "control flow"):

- the graph route, `run_steps` / `run_steps_history` on a CUDA card: the
  step is captured once as a CUDA graph (`_StepGraph`) whose branches and
  bounded loops are conditional nodes, and replayed once per iteration;
  between a call's start and its end the host reads nothing (the JAX
  package's one-dispatch `lax.scan`, dpgo_tpu/driver.py::_multi_step_impl);
- the host-read route, `run_steps_eager` / `run_steps_history_eager` (and
  `run_steps` on the CPU): the step runs eagerly and its loop and branch
  flags are read on the host (`syncs`): the plain version of the control
  flow.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpgo_tpu_torch.chordal import distributed_chordal_init
from dpgo_tpu_torch.graph import build_multigraph
from dpgo_tpu_torch.io.g2o import Measurements
from dpgo_tpu_torch.losses import Loss
from dpgo_tpu_torch.manifold import block_mm, proj_tangent
from dpgo_tpu_torch.objective import (EdgeData, SplitEdges, evaluate_f,
                                      grad_norm)
from dpgo_tpu_torch.problem import NodeProblem, NodeState, build_node_problems
from dpgo_tpu_torch.sesync import (chordal_initialization,
                                   recover_translations_global)
from dpgo_tpu_torch.solvers import mm as mm_mod
from dpgo_tpu_torch.solvers import polish as polish_mod
from dpgo_tpu_torch.solvers import star as star_mod
from dpgo_tpu_torch.solvers.mm import MMOptions, MMState, init_state
from dpgo_tpu_torch.solvers.tnt import tnt_one
from dpgo_tpu_torch.utils import (HostSyncs, Spans, _copy_into, flatten,
                                  open_device, resolve_device, span, sync)


def communicate(st: MMState, halo_owner, halo_lpose, halo_dc=None) -> MMState:
    """Refresh every node's halo from the owners' current own state.

    `halo_dc` [N, n1_max, d] re-expresses the owner's locally-centered
    translations in the reader's frame (local gauge centering)."""
    return st.replace(Z=communicate_star(st.Z, halo_owner, halo_lpose,
                                         halo_dc))


class DPGOSolver:
    """Distributed PGO on one device: batched node axis, eager step.

    Ported scope: MM-PGO, AMM-PGO# and Anderson-accelerated MM, node
    blocks of any size (n0 d up to `dense_limit` on the dense operator
    path, up to `segment_limit` poses edge-wise, above that the segment
    path with segments of `seg_size` poses; see problem.py), d = 2 and 3,
    every loss kernel with static or dynamic rescale, the three STPCG
    preconditioners, centralized chordal or distributed (DChordal)
    initialization. Runs on the CUDA card unless `device` names another
    (`device="cpu"`). A problem copy with
    `dataclasses.replace(solver.probs, kernels=False)` runs the plain torch
    versions of the two CUDA kernels on any device."""

    def __init__(self, meas: Measurements, num_nodes: int,
                 opts: MMOptions | None = None,
                 loss: Loss = Loss.TRIVIAL, loss_reg: float = 1.0,
                 dtype=torch.float64, device=None,
                 dense_limit: int = 4096, segment_limit: int = 2048,
                 seg_size: int = 128):
        self.meas = meas
        self.num_nodes = num_nodes
        self.opts = opts or MMOptions()
        self.dtype = dtype
        self.device = resolve_device(device)
        with span("build", setup=True):
            with span("build.multigraph", setup=True):
                self.part, self.nodes, self.mg = build_multigraph(
                    meas, num_nodes)
            with span("device.open", setup=True):
                open_device(self.device)
            precon_cond = self.opts.precon_cond
            if precon_cond is None:
                precon_cond = 1e6 if dtype == torch.float64 else 1e5
            self._build_kw = dict(
                xi=self.opts.regularizer, loss=loss, loss_reg=loss_reg,
                precon_cond=precon_cond, dense_limit=dense_limit,
                segment_limit=segment_limit, seg_size=seg_size, dtype=dtype,
                device=self.device)
            self.probs = self._build_problems()
            with span("build.upload", setup=True):
                self.edges = EdgeData.from_measurements(
                    meas, node_of=self.part.node_of, dtype=dtype,
                    device=self.device)

                def ix(x):
                    return torch.as_tensor(np.asarray(x, np.int64),
                                           device=self.device)

                self.halo_owner = ix(self.mg.halo_owner)
                self.halo_lpose = ix(self.mg.halo_lpose)
                self.node_of = ix(self.part.node_of)
                self.local_of = ix(self.part.local_of)
                sync(self.device)
        self.loss = loss
        self.loss_reg = loss_reg
        # Local gauge centering: store each node's translations relative to
        # its own block centroid (fixed at first initialize). Every cost is
        # difference-based, so only f32 cancellation error changes: it drops
        # from graph-diameter to block-diameter scale. None = on for f32.
        lg = self.opts.local_gauge
        self.local_gauge = (dtype == torch.float32) if lg is None else lg
        self._c = None  # [N, d] block centroids, set at first initialize
        self.halo_dc = None
        # Device-to-host flag reads of the iterate (see HostSyncs).
        self.syncs = HostSyncs()
        # Outer / CG iterations and TNT history of the last polish.
        self.polish_stats = None
        # Route, seconds and host syncs of the last DChordal start.
        self.dchordal_stats = None
        # (scale_w, problems) of the last update: under dynamic rescale the
        # update builds the reweighted problems once per step and the next
        # iterate runs on them.
        self._reweighted = (None, self.probs)
        # The captured step of the graph route (_StepGraph), made at the
        # first run_steps on the card.
        self._graph = None

    # ------------------------------------------------------------ hooks
    # The single-process solver holds every node. The sharded solvers
    # (parallel/spmd.py) hold a node range and override these.

    def _build_problems(self, **kw) -> NodeProblem:
        """The problems of the nodes this solver holds (`kw`: extra
        arguments of build_node_problems)."""
        return build_node_problems(self.mg, **self._build_kw, **kw)

    def _exchange_halos(self, Z: NodeState) -> NodeState:
        """Refresh every held node's halo from the owners' own state."""
        return communicate_star(Z, self.halo_owner, self.halo_lpose,
                                self.halo_dc)

    def _sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the processes that share the node axis."""
        return x

    def _agree(self, flag: bool) -> bool:
        """The flag every process takes (the first process's)."""
        return flag

    # ----------------------------------------------------------- init

    def _set_gauge(self, t: np.ndarray) -> None:
        """Fix the per-node gauge centroids from a global t (first call
        only: the frame stays fixed for the solver's lifetime)."""
        if not self.local_gauge or self._c is not None:
            return
        mg = self.mg
        c = np.zeros((mg.num_nodes, mg.d))
        for a in range(mg.num_nodes):
            s, n0 = int(mg.start[a]), int(mg.n0[a])
            c[a] = np.asarray(t[s:s + n0], np.float64).mean(axis=0)
        self.set_gauge(c)

    def set_gauge(self, c: np.ndarray) -> None:
        """Install explicit gauge centroids (checkpoint resume path)."""
        # Round to the working precision so host/device adds are exact.
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        c = np.asarray(c, np_dtype).astype(np.float64)
        self._c = c
        self._c_dev = torch.as_tensor(c, dtype=self.dtype, device=self.device)
        self.halo_dc = torch.as_tensor(
            c[self.mg.halo_owner] - c[:, None, :], dtype=self.dtype,
            device=self.device)

    def pack_global(self, t: np.ndarray, R: np.ndarray) -> NodeState:
        """Distribute a global (t [P,d], R [P,d,d]) into padded node states
        (halo filled by communicate), applying the local gauge offsets."""
        mg = self.mg
        t = np.asarray(t, np.float64)
        tn = np.zeros((mg.num_nodes, mg.n0_max, mg.d))
        Rn = np.tile(np.eye(mg.d), (mg.num_nodes, mg.n0_max, 1, 1))
        for a in range(mg.num_nodes):
            n0 = int(mg.n0[a])
            s = int(mg.start[a])
            tn[a, :n0] = t[s:s + n0]
            Rn[a, :n0] = R[s:s + n0]
        gidx = mg.start[mg.halo_owner] + mg.halo_lpose
        th = t[gidx]
        if self._c is not None:
            tn = tn - self._c[:, None, :]
            th = th - self._c[:, None, :]

        def dev(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        return NodeState(t=dev(tn), R=dev(Rn), th=dev(th), Rh=dev(R[gidx]))

    def gather_global(self, st: MMState):
        """Assemble the global (t, R) from per-node own blocks (undoing the
        local gauge offsets)."""
        with span("gather", self.device):
            t = st.Z.t[self.node_of, self.local_of]
            if self._c is not None:
                t = t + self._c_dev[self.node_of]
            R = st.Z.R[self.node_of, self.local_of]
        return t, R

    def _start(self, t, R, dist_init: bool) -> tuple:
        """The global start (t, R): as given, else centralized chordal
        (host numpy/scipy) or, with dist_init, the distributed DChordal
        pipeline on this solver's device, type, kernel setting and route
        (its stages captured whole where the step is; the run's routes,
        seconds and syncs in `dchordal_stats`)."""
        with span("init.chordal", setup=True):
            if R is None and dist_init:
                self.dchordal_stats = {}
                t, R = distributed_chordal_init(
                    self.meas, self.num_nodes, dtype=self.dtype,
                    device=self.device, kernels=self.probs.kernels,
                    graph=self._graph_route(), stats=self.dchordal_stats)
            if R is None:
                R = chordal_initialization(self.meas)
            if t is None:
                t = recover_translations_global(self.meas, R)
        return t, R

    def _pack_start(self, t, R) -> NodeState:
        """The initial node states from the global start, its translation
        gauge centered (pure gauge freedom; keeps |t| small, which matters
        in f32)."""
        t = t - np.asarray(t).mean(axis=0, keepdims=True)
        self._set_gauge(t)
        return self.pack_global(t, R)

    def initialize(self, t: np.ndarray | None = None,
                   R: np.ndarray | None = None,
                   dist_init: bool = False) -> MMState:
        """Initialization (centralized chordal by default, DChordal with
        dist_init=True), then the first update."""
        with span("init", setup=True):
            t, R = self._start(t, R, dist_init)
            with span("init.update", setup=True):
                st = init_state(self.probs, self._pack_start(t, R),
                                self.opts)
                st = st.replace(Z=self._exchange_halos(st.Z))
                st = st.replace(Z_prev=st.Z)
                st, probs = self._update(st, 0, first=True)
                self._reweighted = (st.scale_w, probs)
                sync(self.device)
        return st

    # ----------------------------------------------------------- stepping

    def _update(self, st: MMState, k, first: bool):
        """Dynamic-rescale trigger, then the update on the problems
        reweighted by the new weights (the base problems when static);
        returns (state, those problems: the next iterate runs on them)."""
        st = mm_mod.rescale(self.probs, st, self.opts)
        probs = mm_mod.reweighted_problems(self.probs, st, self.opts)
        return mm_mod.update_state(probs, st, self.opts, k,
                                   first=first), probs

    def problems(self, st: MMState):
        """The problems the next iterate runs on: the base problems, or
        under dynamic rescale those reweighted by the state's weights
        (reused from the update that produced `st`)."""
        scale_w, probs = self._reweighted
        if scale_w is st.scale_w:
            return probs
        return mm_mod.reweighted_problems(self.probs, st, self.opts)

    def _advance(self, probs: NodeProblem, st: MMState, k):
        """One step (iterate -> communicate -> update) whose iterate runs on
        `probs`; returns (state, the problems the next iterate runs on).
        `k`: a Python int, or on the graph route the device counter."""
        iterate = {"amm": mm_mod.iterate_amm, "aa": mm_mod.iterate_aa}.get(
            mm_mod.resolve_scheme(self.opts), mm_mod.iterate_mm)
        st = iterate(probs, st, self.opts, k, self.syncs)
        st = st.replace(Z=self._exchange_halos(st.Z))
        # Z_prev (stamped inside iterate) is the previous anchor including
        # the halo of the previous round's communicate.
        return self._update(st, k + 1, first=False)

    def _step(self, st: MMState, k: int) -> MMState:
        st, probs = self._advance(self.problems(st), st, k)
        self._reweighted = (st.scale_w, probs)
        return st

    def run_steps_eager(self, st: MMState, k0: int, num_steps: int):
        """`num_steps` iterations on the host-read route (each loop and
        branch flag read on the host, `syncs`); returns (state,
        k0 + num_steps). The plain version of the graph route's control
        flow."""
        for i in range(num_steps):
            st = self._step(st, k0 + i)
        return st, k0 + num_steps

    def run_steps_history_eager(self, st: MMState, k0: int, num_steps: int):
        """run_steps_history on the host-read route."""
        pairs = []
        for i in range(num_steps):
            st = self._step(st, k0 + i)
            pairs.append(torch.stack([torch.sum(st.fobj),
                                      torch.sum(st.gradFnorm
                                                * st.gradFnorm)]))
        if not pairs:
            return st, k0, self._history(None)
        return st, k0 + num_steps, self._history(torch.stack(pairs))

    def _history(self, pairs):
        """(2f [S], 2|grad| [S]) from this process's per-step pairs
        [S, 2] = (sum fobj, sum gradFnorm^2) over its nodes (None: no
        step), summed over the ranks in one collective (either route)."""
        if pairs is None:
            empty = torch.zeros(0, dtype=self.dtype, device=self.device)
            return empty, empty
        h = self._sum_over_ranks(pairs)
        return 2.0 * h[:, 0], 2.0 * torch.sqrt(h[:, 1])

    def _graph_route(self) -> bool:
        """Whether run_steps / run_steps_history and the polish take the
        graph route: on a CUDA card."""
        return self.device.type == "cuda"

    def run_steps(self, st: MMState, k0: int, num_steps: int):
        """`num_steps` solver iterations; returns (state, k0 + num_steps).
        On a CUDA card the graph route: the captured step replayed
        `num_steps` times, no host read in between (the returned state is a
        copy, never overwritten by a later call); on the CPU the host-read
        route (`run_steps_eager`)."""
        if not self._graph_route():
            return self.run_steps_eager(st, k0, num_steps)
        if num_steps <= 0:
            return st, k0
        Spans.next_solve()
        with span("solve", self.device) as rec:
            rec.steps = num_steps
            with span("solve.load"):
                g = self._step_graph(st, k0)
            rec.mark_start()
            for _ in range(num_steps):
                g.replay()
            rec.mark_end()
            with span("solve.result"):
                out = g.result()
        return out, k0 + num_steps

    def run_steps_history(self, st: MMState, k0: int, num_steps: int):
        """`num_steps` iterations recording (2f, 2|grad|) per step on the
        device: node objectives sum to the global objective (inter edges are
        split half/half between endpoints) and the global gradient norm is
        the rms over nodes. Returns (state, k, (f [num_steps],
        g [num_steps])). On a CUDA card the graph route (the captured step
        writes each step's pair at its device step index); on the CPU the
        host-read route (`run_steps_history_eager`). The sharded solvers
        sum the history over the ranks once per call, after the replays."""
        if not self._graph_route():
            return self.run_steps_history_eager(st, k0, num_steps)
        if num_steps <= 0:
            return st, k0, self._history(None)
        g = self._step_graph(st, k0)
        cap = g.hist.shape[0]
        chunks = []
        for i in range(num_steps):
            g.replay()
            if (i + 1) % cap == 0 or i + 1 == num_steps:
                chunks.append(g.hist[:i % cap + 1].clone())
        return g.result(), k0 + num_steps, self._history(torch.cat(chunks))

    def _graph_key(self, st) -> tuple:
        """What a captured step depends on besides the state's values, as
        (objects held by identity, values held by equality): the problems,
        gauge tensors and edges it reads; the options and the state's
        shapes (the sharded solvers add their halo strategy)."""
        return ((self.probs, self.halo_dc, self.edges),
                (self.opts, tuple((tuple(x.shape), x.dtype)
                                  for x in flatten(st)[0])))

    def _step_graph(self, st, k0: int) -> "_StepGraph":
        """The captured step (captured now when there is none or its key
        changed), loaded with state `st` at step index k0. A capture that
        fails raises; there is no fallback to the host-read route."""
        key = self._graph_key(st)
        g = self._graph
        if g is None or not g.matches(key):
            self._graph = None
            g = _StepGraph(self, st, k0, key)
            g.capture(self)
            self._graph = g
        g.load(self, st, k0)
        self._reweighted = (None, self.probs)
        return g

    def graph_stats(self) -> dict | None:
        """Of the captured step: capture seconds (warm-up included), bytes
        its two memory pools hold on the card, None before a capture."""
        if self._graph is None:
            return None
        c = self._graph.captured
        return {"capture_s": c.capture_s, "warmup_s": c.warmup_s,
                "pool_bytes": c.pool_bytes}

    def _metrics(self, st: MMState):
        """Exact global (2 f, 2 |grad|) at the current own estimates."""
        t, R = self.gather_global(st)
        f = evaluate_f(self.edges, t, R, self.loss, self.loss_reg)
        g = grad_norm(self.edges, t, R, self.loss, self.loss_reg,
                      self.probs.kernels)
        return 2.0 * f, 2.0 * g

    def fused_stpcg_engaged(self) -> bool:
        """True iff the TNT refinement's trust-region subproblem runs in the
        fused single-launch STPCG (kernel K1): the Hopper gate (dense path,
        d = 2 or 3, float32, CUDA device), the dense preconditioner and
        refinement enabled (Anderson acceleration runs no refinement).
        Mirrors mm._make_tnt_model_dense."""
        tnt = self.opts.tnt
        return (mm_mod.resolve_scheme(self.opts) != "aa"
                and self.probs.fused_stpcg_supported()
                and mm_mod.resolve_preconditioner(self.probs,
                                                  self.opts) == "dense"
                and tnt.max_iterations > 0
                and tnt.max_iterations_accepted > 0)

    def _node_block_precondition(self, share: SplitEdges):
        """Node-block preconditioner for the global polish: per node, the
        exact mG00 solve for translations (split inverse, or segment-Schwarz
        CG on the segment path) and for rotations the dense regularized
        mG11 inverse (dense path), its segment-dense analog (segment path)
        or the block-Jacobi blocks (edge-wise path). Block-diagonal over
        nodes, so SPD; it collapses intra-node conditioning exactly and
        leaves CG only the inter-node coupling.

        It acts on the own rows of `share` (the poses of a range of nodes),
        with this solver's problems, which are those nodes'."""
        probs = self.probs
        gidx, mask = share.node_rows, share.node_mask
        node_of, local_of = share.row_node, share.row_pose

        def precondition(x, v):
            vt, vR = v
            tn = torch.where(mask[..., None], vt[gidx], 0.0)
            Rn = torch.where(mask[..., None, None], vR[gidx], 0.0)
            if probs.dense:
                Rp = probs.from_tall(probs.precon_dense @ probs.to_tall(Rn))
            elif probs.seg:
                Rp = probs.precondition_R_seg(Rn)
            else:
                Rp = block_mm(Rn, probs.precon_inv, probs.kernels)
            tp = probs.solve_mG00(tn, t_anchor=torch.zeros_like(tn),
                                  syncs=self.syncs)
            out_t = tp[node_of, local_of]
            out_R = Rp[node_of, local_of]
            return out_t, proj_tangent(x[1], out_R, probs.kernels)

        return precondition

    def polish(self, st: MMState, outer: int = 20, tcg: int = 500,
               node_precon: bool = True, coarse: bool = False,
               coarse_segments: tuple = (), params=None,
               eager: bool = False):
        """Global second-order tail polish: gather the full pose state, run
        Riemannian TNT on the coupled problem (solvers/polish.py) on this
        solver's device and type, and re-initialize the solver at the
        result. Returns (state, 2 f_value).

        `coarse=True` adds the block-rigid coarse correction to the
        preconditioner (cross-node lever-arm conditioning); non-empty
        `coarse_segments` (e.g. (64, 256)) adds finer contiguous-segment
        rigid levels on top (the additive multilevel hierarchy; see
        polish.multilevel_rigid_preconditioner) and implies the coarse
        path, which needs the node preconditioner as its base level. The
        retraction's SO(3) projection follows `self.probs.kernels` (K2).
        `params` (TNTParams) replaces polish_params(outer, tcg).
        `polish_stats` then holds the run's outer and CG iterations, its
        TNT history and its route.

        On a CUDA card the TNT runs as one captured program (its outer loop
        and STPCG WHILE nodes), replayed once, and the host reads nothing
        until its result; `eager=True`, or the CPU, takes the host-read
        route (each loop flag read on the host, `syncs`)."""
        if params is None:
            params = polish_mod.polish_params(outer=outer, tcg=tcg)
        coarse_segments = tuple(coarse_segments)
        if coarse_segments and not coarse:
            coarse = True  # segments imply the multilevel hierarchy
        if coarse and not node_precon:
            raise ValueError(
                "polish(coarse=True / coarse_segments=...) needs the "
                "node-block preconditioner as the hierarchy's base level; "
                "pass node_precon=True")
        t2, R2, fx, stats = self._polish_tnt(
            st, params, node_precon, coarse, coarse_segments,
            graph=not eager and self._graph_route())
        self.polish_stats = stats
        st2 = self.initialize(t2.cpu().numpy(), R2.cpu().numpy())
        return st2, 2.0 * float(fx)

    def _polish_tnt(self, st: MMState, params, node_precon: bool,
                    coarse: bool, coarse_segments: tuple, graph: bool):
        """The polish's TNT on the whole gathered pose state: the split
        model (polish.split_tnt_model) with one share holding every pose,
        captured with `graph`. Returns the global (t, R), f and the stats,
        with the host flag reads of the TNT and its set-up (the sharded
        solvers split the pose axis here)."""
        t, R = self.gather_global(st)
        share = SplitEdges.build(self.edges, self.part.node_of, 0,
                                 self.num_nodes)
        syncs0 = self.syncs.count
        t2, R2, fx, stats = self._run_polish_tnt(
            share, (t, R), params, node_precon, coarse, coarse_segments,
            graph=graph)
        stats["tnt_host_syncs"] = self.syncs.count - syncs0
        return t2, R2, fx, stats

    def _run_polish_tnt(self, share: SplitEdges, x0, params,
                        node_precon: bool, coarse: bool,
                        coarse_segments: tuple, exchange=None, reduce=None,
                        graph: bool = False):
        """TNT from x0, the own rows of `share` (a range of nodes), on the
        split model with the node-block preconditioner on this solver's
        problems and the rigid coarse levels; `exchange` and `reduce` as in
        split_tnt_model (None: one process). The model and preconditioners
        are built first, on the host-read route (they copy host arrays to
        the card); then the TNT runs, with `graph` as one captured program
        replayed once (graph_nodes.run_once), and its history is read after
        it. Returns (t, R, f, stats)."""
        def make_model(precondition):
            return polish_mod.split_tnt_model(
                share, exchange, reduce, self.loss, self.loss_reg,
                precondition, self.probs.kernels)

        precon = (self._node_block_precondition(share) if node_precon
                  else None)
        if coarse:
            model0 = make_model(precon)
            _, nabla = model0.grad_and_nabla(x0)
            P = self.meas.num_poses
            p0 = int(self.mg.start[share.node_lo])
            rows = slice(p0, p0 + share.num_own)
            node_of = self.part.node_of

            def dev(x):
                return torch.as_tensor(x, device=self.device)

            levels = [(dev(node_of[rows]), self.num_nodes)]
            for m in coarse_segments:
                if m >= P:
                    continue
                seg = polish_mod.contiguous_segments(P, m).numpy()
                # Pieces: the segments cut at the node boundaries.
                cut = np.r_[True, (seg[1:] != seg[:-1])
                            | (node_of[1:] != node_of[:-1])]
                piece = np.cumsum(cut) - 1
                levels.append((dev(seg[rows]), m,
                               (dev(piece[rows]), dev(seg[cut]))))
            precon = polish_mod.multilevel_rigid_preconditioner(
                model0.hess_vp, nabla, x0, levels, precon, reduce=reduce,
                kernels=self.probs.kernels)
        model = make_model(precon)
        stats = {"route": "graph" if graph else "host"}
        if graph:
            from dpgo_tpu_torch.ops import graph_nodes
            out, cap = graph_nodes.run_once(
                self.device, lambda: tnt_one(model, x0, params, record=True))
            stats.update(capture_s=cap.capture_s, warmup_s=cap.warmup_s,
                         pool_bytes=cap.pool_bytes)
        else:
            out = tnt_one(model, x0, params, syncs=self.syncs, record=True)
        x, fx, _, _, hist = out
        n = int(hist.count)
        stats.update(outer=n,
                     cg_iterations=int(hist.inner_iterations[:n].sum()),
                     history={k: getattr(hist, k)[:n].cpu().numpy()
                              for k in ("fx", "Delta", "inner_iterations",
                                        "rho", "accepted")})
        return x[0], x[1], fx, stats

    def refine_stats(self, st: MMState) -> dict:
        """Per-node, per-TNT-outer-iteration refinement profile for the
        current state: (f, |grad|, |Pgrad|, Delta, inner CG iterations,
        step M-norm, rho, accepted) ring buffers plus the refinement gate
        mask (the reference's TNTResult series). A diagnostic probe: it
        re-runs the refinement of the next step outside the step."""
        refined, hist = mm_mod.refine_probe(self.probs, st, self.opts,
                                            self.syncs)
        out = {k: v.cpu().numpy() for k, v in hist._asdict().items()}
        out["refined_mask"] = refined.cpu().numpy()
        return out

    def node_stats(self, st: MMState) -> dict:
        """Per-node observability snapshot (the reference's DPGOResult
        per-iteration series)."""
        def a(x):
            return x.cpu().numpy()

        return {
            "fobj": a(st.fobj), "gradFnorm": a(st.gradFnorm), "Gk": a(st.Gk),
            "Fk0": a(st.Fk0), "Fk1": a(st.Fk1), "gamma": a(st.gamma),
            "s": a(st.s), "soft_restart_hits": (a(st.hits0), a(st.hits1)),
            "num_oscillations": a(st.num_osc),
        }

    def run(self, num_iters: int, t0=None, R0=None, record_every: int = 1,
            callback=None, log_iterates: bool = False):
        """Run the solver; returns (state, history) where history rows are
        (iter, 2 fobj, 2 |grad|) from the exact global oracle.

        `callback(k, state, fobj2x, grad2x)` is invoked at every recorded
        iteration; returning True stops the run early. `log_iterates=True`
        also keeps the global (t, R) at every recorded iteration and returns
        (state, history, iterates), iterates a list of numpy pairs."""
        st = self.initialize(t0, R0)
        history, iterates = [], []

        def record(st, k):
            f, g = (float(x) for x in self._metrics(st))
            history.append((k, f, g))
            if log_iterates:
                t, R = self.gather_global(st)
                iterates.append((t.cpu().numpy(), R.cpu().numpy()))
            return self._agree(callback is not None
                               and bool(callback(k, st, f, g)))

        stopped = record(st, 0)
        done = 0
        while not stopped and done < num_iters:
            chunk = min(record_every, num_iters - done)
            st, done = self.run_steps(st, done, chunk)
            stopped = record(st, done)
        if log_iterates:
            return st, np.asarray(history), iterates
        return st, np.asarray(history)


class DPGOStarSolver(DPGOSolver):
    """AMM-PGO*: per-node accelerated steps with master-gated fallbacks
    using the exact global objective (reference DPGOStar). Runs on the base
    problems (no dynamic rescale). `fallbacks` counts the master fallbacks
    taken, by name (solvers/star.py FALLBACKS), from device counters that
    the step bumps on either route (reading them waits for the card);
    `reset_fallbacks` zeroes them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._fired = {n: torch.zeros((), dtype=torch.int64,
                                      device=self.device)
                       for n in star_mod.FALLBACKS}

    @property
    def fallbacks(self) -> dict:
        return {n: int(t) for n, t in self._fired.items()}

    def reset_fallbacks(self) -> None:
        for t in self._fired.values():
            t.zero_()

    def _global_f(self, t_own, R_own):
        t = t_own[self.node_of, self.local_of]
        if self._c is not None:
            t = t + self._c_dev[self.node_of]
        R = R_own[self.node_of, self.local_of]
        return evaluate_f(self.edges, t, R, self.loss, self.loss_reg)

    def initialize(self, t=None, R=None, dist_init: bool = False):
        with span("init", setup=True):
            t, R = self._start(t, R, dist_init)
            with span("init.update", setup=True):
                st = star_mod.init_star_state(self.probs,
                                              self._pack_start(t, R), 0.0)
                st = st.replace(Z=self._exchange_halos(st.Z))
                st = st.replace(Z_prev=st.Z,
                                F=self._global_f(st.Z.t, st.Z.R))
                st = star_mod.update_star(self.probs, st, self.opts,
                                          first=True)
                sync(self.device)
        return st

    def problems(self, st):
        return self.probs

    def _advance(self, probs, st, k):
        st = star_mod.iterate_star(probs, st, self.opts, self._global_f,
                                   k, self.syncs, self._fired,
                                   reduce=self._sum_over_ranks)
        st = st.replace(Z=self._exchange_halos(st.Z))
        return star_mod.update_star(probs, st, self.opts,
                                    first=False), probs

    def _step(self, st, k: int):
        return self._advance(self.probs, st, k)[0]


class _StepGraph:
    """One solver step captured as a CUDA graph: the JAX package's jitted
    step (dpgo_tpu/driver.py::_step_impl), replayed once per iteration.

    The graph reads the state from static buffers and ends by copying the
    next state back into them, with the step index `k` (int32) and, under
    dynamic rescale, the reweighted problems' tensors (the problems the
    next iterate runs on) carried the same way, so the rescale rebuilds
    inside the replay. It also writes this process's (sum fobj,
    sum gradFnorm^2) into the ring `hist` at the device step index `pos`.
    Its branches and bounded loops are conditional nodes (utils.device_cond
    / bounded_while on the "capture" route); K1, K2 and the sharded
    solvers' NCCL collectives launch inside it and bump their device
    counters at every replay. The warm-up before the capture and the
    capture itself: graph_nodes.warm_and_capture."""

    HISTORY = 256

    def __init__(self, solver: DPGOSolver, st, k0: int, key: tuple):
        dev = solver.device
        self.key = key
        leaves, self._rebuild = flatten(st)
        self.static = [x.clone() for x in leaves]
        probs = solver.problems(st)
        base = solver.probs
        self.dyn = [f.name for f in dataclasses.fields(probs)
                    if isinstance(getattr(probs, f.name), torch.Tensor)
                    and getattr(probs, f.name) is not getattr(base, f.name)]
        self.static_dyn = [getattr(probs, n).clone() for n in self.dyn]
        # Held for the graph's life: a NodeProblem made here also makes its
        # index tensors (__post_init__), which the graph reads.
        self.static_probs = (dataclasses.replace(
            probs, **dict(zip(self.dyn, self.static_dyn))) if self.dyn
            else probs)
        self.k = torch.full((), k0, dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.hist = torch.zeros((self.HISTORY, 2), dtype=solver.dtype,
                                device=dev)
        self.captured = None

    def capture(self, solver: DPGOSolver) -> None:
        """Warm up and capture `body` (graph_nodes.warm_and_capture). The
        warm-up writes its (discarded) step into the buffers; `load`
        overwrites them before the first replay. (The graph holds no
        reference to the solver, which holds the graph: a cycle would leave
        the graph to the garbage collector, which may free it inside a
        later warm-up's sync-debug window.)"""
        from dpgo_tpu_torch.ops import graph_nodes
        self.captured = graph_nodes.warm_and_capture(
            solver.device, lambda: self.body(solver))

    def body(self, solver: DPGOSolver) -> None:
        """One step from the static buffers back into them (what the graph
        records)."""
        nxt, probs2 = solver._advance(self.static_probs,
                                      self._rebuild(self.static), self.k)
        pair = torch.stack([torch.sum(nxt.fobj),
                            torch.sum(nxt.gradFnorm * nxt.gradFnorm)])
        self.hist.index_copy_(
            0, torch.remainder(self.pos, self.HISTORY).reshape(1),
            pair[None].to(self.hist.dtype))
        self.pos.add_(1)
        _copy_into(self.static + self.static_dyn,
                   flatten(nxt)[0] + [getattr(probs2, n) for n in self.dyn])
        self.k.add_(1)

    def replay(self) -> None:
        from dpgo_tpu_torch.ops import graph_nodes
        graph_nodes.replay(self.captured.graph)

    def matches(self, key: tuple) -> bool:
        return (all(a is b for a, b in zip(self.key[0], key[0]))
                and self.key[1] == key[1])

    def load(self, solver: DPGOSolver, st, k0: int) -> None:
        """Copy state `st` (and its problems under dynamic rescale) into the
        static buffers, the step index to k0 and the history position to
        0: device copies, no host read."""
        for b, x in zip(self.static, flatten(st)[0]):
            if b is not x:
                b.copy_(x)
        if self.dyn:
            probs = solver.problems(st)
            for b, n in zip(self.static_dyn, self.dyn):
                b.copy_(getattr(probs, n))
        self.k.fill_(k0)
        self.pos.zero_()

    def result(self):
        """A copy of the state in the static buffers."""
        return self._rebuild([x.clone() for x in self.static])


def communicate_star(Z: NodeState, halo_owner, halo_lpose,
                     halo_dc=None) -> NodeState:
    """communicate() on a bare NodeState (AMM-PGO*)."""
    th = Z.t[halo_owner, halo_lpose]
    if halo_dc is not None:
        th = th + halo_dc
    return NodeState(t=Z.t, R=Z.R, th=th, Rh=Z.R[halo_owner, halo_lpose])
