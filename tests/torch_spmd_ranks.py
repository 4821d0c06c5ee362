"""What each rank runs in tests/test_torch_spmd.py (a module of its own so
that the spawned processes import torch and the port only, never jax).

`run_cases` drives the sharded solvers through every case of one world and
returns, per case, numpy results the test holds against JAX's single-process
solvers and the port's."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

STEPS = 12
LOSS_REG = 0.25
# The forced segment regime (8 poses per node, 2 segments of 4) and the
# forced edge-wise regime.
SEG = dict(segment_limit=4, seg_size=4)
EDGEWISE = dict(dense_limit=0)
# Polish: outer iterations and the STPCG cap (the two packages' CG part by
# rounding at ~20 iterations; tests/test_torch_polish.py).
POLISH = dict(outer=6, tcg=12, coarse=True)
# The polish cases: the default, with contiguous-segment levels (16
# segments of 4 poses align with the ranks' pose ranges, 5 straddle them),
# in the forced segment regime, with local gauge centering and the ring
# exchange, under Huber, and from turned rotations (N(0, 0.3) per entry,
# then projected) with a trust radius of 100, where TNT rejects steps.
POLISH_CASES = ["polish", "polish_levels", "polish_segment",
                "polish_gauge_ring", "polish_huber", "polish_reject"]
REJECT_DELTA0 = 100.0
# The split oracles' cases: graph x loss.
ORACLE_CASES = [(g, loss) for g in ("d3", "d2") for loss in ("trivial",
                                                              "huber")]


def case_setup(name: str) -> dict:
    """Solver class, graph, options, loss and extra solver arguments of a
    case, by name; the same for the sharded run and its references."""
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    c = dict(cls="hash", graph="d3", opts={}, loss="trivial", kw={},
             steps=STEPS, halo="boundary")
    if name.startswith(("acc_", "plain_")):
        acc, halo = name.split("_")
        c.update(opts=dict(accelerated=acc == "acc"), halo=halo,
                 stats=name == "acc_boundary")
    elif name == "huber_dynamic":
        c.update(opts=dict(accelerated=True, rescale="dynamic",
                           tnt=TNTParams(max_iterations=0)),
                 loss="huber", steps=10)
    elif name == "aa":
        c.update(opts=dict(scheme="aa"))
    elif name == "d2":
        c.update(graph="d2", opts=dict(accelerated=True))
    elif name == "segment":
        c.update(opts=dict(accelerated=True,
                           tnt=TNTParams(max_iterations=0)), kw=SEG)
    elif name.startswith("star"):
        psi = 1e3 if name == "star_psi" else None
        c.update(cls="star", opts={} if psi is None else dict(psi=psi,
                                                             phi=psi))
    elif name == "gauge_ring":
        # Local gauge centering (the float32 default) in float64: the ring
        # exchange re-expresses the owners' translations (halo_dc).
        c.update(opts=dict(accelerated=True, local_gauge=True), halo="ring")
    elif name in POLISH_CASES:
        c.update(opts=dict(tnt=TNTParams(max_iterations=0)), steps=0,
                 polish=dict(POLISH))
        if name == "polish_levels":
            c["polish"]["coarse_segments"] = (16, 5)
        elif name == "polish_segment":
            c.update(kw=SEG)
        elif name == "polish_gauge_ring":
            c["opts"].update(local_gauge=True)
            c.update(halo="ring")
        elif name == "polish_huber":
            c.update(loss="huber")
        elif name == "polish_reject":
            c.update(Delta0=REJECT_DELTA0)
    else:
        raise KeyError(name)
    return c


HASH_CASES = [f"{a}_{h}" for a in ("acc", "plain")
              for h in ("boundary", "gather", "ring")]
CASES = HASH_CASES + ["huber_dynamic", "aa", "d2", "segment", "star",
                      "star_psi", "gauge_ring"] + POLISH_CASES


def make_solver(name: str, graphs: dict, device, sharded: bool, group=None,
                setup=case_setup, dtype=torch.float64):
    """(solver, setup) of a case: `setup(name)` (case_setup, or
    trace_setup) built in `dtype` on `device`, sharded or not."""
    from dpgo_tpu_torch import driver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.parallel import spmd
    from dpgo_tpu_torch.solvers.mm import MMOptions

    c = setup(name)
    if sharded:
        cls = (spmd.ShardedDPGOStarSolver if c["cls"] == "star"
               else spmd.ShardedDPGOSolver)
        extra = dict(group=group, halo=c["halo"])
    else:
        cls = (driver.DPGOStarSolver if c["cls"] == "star"
               else driver.DPGOSolver)
        extra = {}
    return cls(graphs[c["graph"]], num_nodes=graphs["num_nodes"],
               opts=MMOptions(**c["opts"]), loss=Loss(c["loss"]),
               loss_reg=LOSS_REG, dtype=dtype, device=device,
               **c["kw"], **extra), c


def turned(R, seed: int = 7, scale: float = 0.3):
    """Rotations R [P, d, d] plus N(0, scale) per entry, projected back onto
    SO(d) (numpy SVD)."""
    M = R + scale * np.random.default_rng(seed).normal(size=R.shape)
    U, _, Vt = np.linalg.svd(M)
    D = np.ones(R.shape[:-1])
    D[:, -1] = np.linalg.det(U @ Vt)
    return (U * D[:, None, :]) @ Vt


def drive(solver, c) -> dict:
    """initialize + the case's steps with history (or the polish); the
    result both the sharded run and the single-process run report."""
    from dpgo_tpu_torch.solvers.polish import polish_params

    st = solver.initialize()
    out = {}
    if c["steps"]:
        st, k, (f, g) = solver.run_steps_history(st, 0, c["steps"])
        assert k == c["steps"]
        out.update(f=f.cpu().numpy(), g=g.cpu().numpy())
    else:
        kw = dict(c["polish"])
        if "Delta0" in c:
            t, R = (x.cpu().numpy() for x in solver.gather_global(st))
            st = solver.initialize(t, turned(R))
            kw["params"] = dataclasses.replace(
                polish_params(outer=kw["outer"], tcg=kw["tcg"]),
                Delta0=c["Delta0"])
        st, f2 = solver.polish(st, **kw)
        stats = solver.polish_stats
        out.update(polish_f=f2, polish_history=stats["history"],
                   polish_counts={k: v for k, v in stats.items()
                                  if k != "history"})
    fe, ge = solver._metrics(st)
    out.update(exact=(float(fe), float(ge)), t=st.Z.t.cpu().numpy(),
               R=st.Z.R.cpu().numpy(), th=st.Z.th.cpu().numpy())
    if c.get("stats"):
        out["node_stats"] = solver.node_stats(st)
        out["refine_stats"] = solver.refine_stats(st)
    if hasattr(solver, "fallbacks"):
        out["fallbacks"] = dict(solver.fallbacks)
    return out


def _same(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def _build_ranges(graphs, device) -> dict:
    """Per regime: this rank's problems equal its rows of the whole build,
    field by field, before and after with_weights. Returns {regime: list of
    fields that differ}."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.parallel.spmd import ShardedDPGOSolver, take_nodes
    from dpgo_tpu_torch.problem import with_weights

    out = {}
    for regime, kw in (("dense", {}), ("edgewise", EDGEWISE),
                       ("segment", SEG)):
        s = ShardedDPGOSolver(graphs["d3"], graphs["num_nodes"],
                              device=device, **kw)
        full = DPGOSolver._build_problems(s)
        N = s.num_nodes
        rows = take_nodes(full, s.node_lo, s.node_hi, N)
        w = torch.linspace(0.2, 1.0, N * full.scale_w.shape[1],
                           dtype=torch.float64).reshape(full.scale_w.shape)
        rows_w = take_nodes(with_weights(full, w), s.node_lo, s.node_hi, N)
        mine_w = with_weights(s.probs, take_nodes(w, s.node_lo, s.node_hi,
                                                  N))
        bad = []
        for f in dataclasses.fields(full):
            a = getattr(s.probs, f.name)
            if isinstance(a, torch.Tensor):
                if not _same(a, getattr(rows, f.name)):
                    bad.append(f.name)
                if not _same(getattr(mine_w, f.name),
                             getattr(rows_w, f.name)):
                    bad.append(f.name + " (with_weights)")
            elif a != getattr(rows, f.name):
                bad.append(f.name)
        if regime == "segment":
            bad += [] if s.probs.seg else ["not on the segment path"]
        if regime == "edgewise":
            bad += [] if not (s.probs.seg or s.probs.dense) else [
                "not on the edge-wise path"]
        out[regime] = bad
    return out


def _errors(graphs, device) -> list:
    """The messages of the two refusals (a node count the ranks do not
    divide, an unknown halo strategy)."""
    from dpgo_tpu_torch.parallel.spmd import ShardedDPGOSolver

    msgs = []
    for kw in (dict(num_nodes=graphs["num_nodes"] - 1),
               dict(num_nodes=graphs["num_nodes"], halo="bogus")):
        try:
            ShardedDPGOSolver(graphs["d3"], device=device, **kw)
        except ValueError as exc:
            msgs.append(str(exc))
    return msgs


def _run_steps_equal(graphs, device) -> bool:
    """run_steps equals per-step stepping exactly."""
    s, _ = make_solver("acc_boundary", graphs, device, sharded=True)
    st0 = s.initialize()
    st_a = st0
    for k in range(8):
        st_a = s._step(st_a, k)
    st_b, k = s.run_steps(st0, 0, 8)
    fa, fb = s._metrics(st_a), s._metrics(st_b)
    return (k == 8 and _same(st_a.Z.t, st_b.Z.t) and _same(st_a.Z.R,
                                                            st_b.Z.R)
            and all(_same(a, b) for a, b in zip(fa, fb)))


def _run_with_callback(graphs, device, rank: int):
    """solver.run with a callback that asks to stop at iteration 4 on rank
    0 and at iteration 2 on the others: every rank stops where rank 0
    asked. Returns the history rows."""
    s, _ = make_solver("acc_boundary", graphs, device, sharded=True)
    stop_at = 4 if rank == 0 else 2
    _, hist = s.run(10, record_every=2,
                    callback=lambda k, st, f, g: k >= stop_at)
    return hist


def oracle_point(meas, seed: int = 3):
    """A global point (t, R) and a batch of two directions (vt, vR) of the
    graph's pose count and dimension, from `seed` (numpy)."""
    rng = np.random.default_rng(seed)
    P, d = meas.num_poses, meas.d
    t = 3.0 * rng.normal(size=(P, d))
    R = turned(np.broadcast_to(np.eye(d), (P, d, d)), seed, 1.0)
    return (t, R, rng.normal(size=(2, P, d)), rng.normal(size=(2, P, d, d)))


def split_oracles(graphs, device) -> dict:
    """On this rank, per graph and loss of ORACLE_CASES: its pose range,
    the objective's node partials summed over the ranks and nodes, and its rows of the
    Euclidean gradient and of the Hessian-vector products along two
    directions (one exchange of the point, one of the batch), at
    `oracle_point`."""
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.objective import split_euclidean_grad, split_f
    from dpgo_tpu_torch.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu_torch.solvers.polish import split_hess_vp, with_halo

    out = {}
    for gname, loss in ORACLE_CASES:
        meas = graphs[gname]
        s = ShardedDPGOSolver(meas, graphs["num_nodes"], loss=Loss(loss),
                              loss_reg=LOSS_REG, device=device)
        sp = s.pose_split()
        own = slice(sp.lo, sp.hi)
        t, R, vt, vR = (torch.as_tensor(np.ascontiguousarray(x),
                                        dtype=torch.float64, device=device)
                        for x in oracle_point(meas))
        te, Re = with_halo(s.exchange_rows, t[own], R[own])
        vte, vRe = with_halo(s.exchange_rows, vt[:, own], vR[:, own])
        f = s.comm.all_reduce(split_f(sp.edges, te, Re, s.loss,
                                      s.loss_reg)).sum()
        gt, gR = split_euclidean_grad(sp.edges, te, Re, s.loss, s.loss_reg)
        ht, hR = split_hess_vp(sp.edges, te, Re, vte, vRe, s.loss,
                               s.loss_reg)
        out[(gname, loss)] = {
            "range": (sp.lo, sp.hi), "f": float(f),
            **{k: v.cpu().numpy() for k, v in
               dict(gt=gt, gR=gR, ht=ht, hR=hR).items()}}
    return out


def split_share(solver) -> dict:
    """What the rank holds after a polish: its pose range, the number of
    edges of its share, the leading axis of every problem tensor, whether
    it kept a whole problem set, and what the collective count depends
    on (halo strategy, ring rounds, node count, dimension)."""
    sp = solver.pose_split()
    return {
        "range": (sp.lo, sp.hi), "edges": int(sp.edges.edges.i.shape[0]),
        "halo": len(sp.halo),
        "prob_rows": sorted({getattr(solver.probs, f.name).shape[0]
                             for f in dataclasses.fields(solver.probs)
                             if isinstance(getattr(solver.probs, f.name),
                                           torch.Tensor)}),
        "full_probs": hasattr(solver, "_full_probs"),
        "strategy": solver.halo, "ring_rounds": solver.ring_rounds}


def run_cases(rank: int, world_size: int, device, graphs: dict,
              names=None) -> dict:
    """The cases `names` (every case, and the checks of run_steps, run's
    callback, the refusals and the rank's problem build, when None) on this
    rank: {case: result}."""
    torch.set_num_threads(1)
    out = {}
    for name in names or CASES:
        solver, c = make_solver(name, graphs, device, sharded=True)
        solver.comm.reset()
        res = drive(solver, c)
        res.update(node_lo=solver.node_lo, node_hi=solver.node_hi,
                   comm=(solver.comm.calls, solver.comm.bytes,
                         solver.comm.host_copies),
                   backend=solver.comm.backend)
        if name in POLISH_CASES:
            res["share"] = split_share(solver)
        out[name] = res
    if names is not None:
        return out
    out["run_steps"] = _run_steps_equal(graphs, device)
    out["run_callback"] = _run_with_callback(graphs, device, rank)
    out["errors"] = _errors(graphs, device)
    out["build_ranges"] = _build_ranges(graphs, device)
    out["oracles"] = split_oracles(graphs, device)
    return out


def build_once(rank: int, world_size: int, device, build_dir: str,
               log: str) -> str:
    """Call ops/_build.build with nvcc stubbed out: every call of the
    stubbed compiler appends a line to `log` and writes the outputs its
    command names. The ranks enter build() together. Returns the library
    path build() gives."""
    import time

    import torch.distributed as dist

    from dpgo_tpu_torch.ops import _build

    def fake_run_all(cmds):
        for cmd in cmds:
            with open(log, "a") as fh:
                fh.write(" ".join(cmd[-2:]) + "\n")
            with open(cmd[cmd.index("-o") + 1], "w") as fh:
                fh.write("built")
        time.sleep(0.2)  # widen the window another rank could race into
        return ""

    _build.BUILD_DIR = build_dir
    _build.LIB_PATH = f"{build_dir}/libdpgo_kernels.so"
    _build._nvcc = lambda: "nvcc"
    _build._run_all = fake_run_all
    dist.barrier()
    return _build.build()


# ------------------------------------------------- the graph route's trace

# The sharded step on the trace route (tests/test_torch_spmd_graph.py):
# AMM-PGO# with each halo strategy and AMM-PGO* with forced fallbacks, TNT
# cut to 4 outer and 30 CG iterations (the trace route runs every trip up
# to the caps), as in tests/test_torch_graph_step.py.
TRACE_CASES = ["acc_boundary", "acc_gather", "acc_ring", "star_psi"]
TRACE_TNT = dict(max_iterations=4, max_tCG_iterations=30)
LOOPS = ("tnt", "stpcg", "seg_cg")


def trace_setup(name: str) -> dict:
    """case_setup with the trace cases' TNT caps."""
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    c = case_setup(name)
    c["opts"] = dict(c["opts"], tnt=TNTParams(**TRACE_TNT))
    return c


def _trace_solver(name, graphs, device, sharded=True):
    return make_solver(name, graphs, device, sharded, setup=trace_setup)[0]


def trace_step_graph():
    """driver._StepGraph on the trace route: nothing is captured, and a
    replay runs the recorded body (`_StepGraph.body`) with every branch
    and trip merged, which is what the graph's conditional nodes compute.
    Installed in place of driver._StepGraph (with the solver's
    `_graph_route` forced), run_steps_history runs the graph route's own
    code on the CPU: the loading of the buffers, the history ring, and the
    sum over the ranks after the replays."""
    from dpgo_tpu_torch import driver
    from dpgo_tpu_torch.utils import route

    class TraceStepGraph(driver._StepGraph):
        def capture(self, solver):
            self.solver = solver

        def replay(self):
            with route("trace"):
                self.body(self.solver)

    return TraceStepGraph


def _counts(solver) -> dict:
    from dpgo_tpu_torch.parallel.spmd import Collectives
    from dpgo_tpu_torch.utils import DeviceCounters

    out = {n: [DeviceCounters.read(n + ".entries"),
               DeviceCounters.read(n + ".trips")] for n in LOOPS}
    out.update({n: DeviceCounters.read(n) for n in Collectives.COUNTERS})
    if hasattr(solver, "fallbacks"):
        out["fallbacks"] = solver.fallbacks
    return out


def _reset(solver) -> None:
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    solver.syncs = HostSyncs()
    solver.comm.reset()
    DeviceCounters.reset()
    if hasattr(solver, "reset_fallbacks"):
        solver.reset_fallbacks()


def trace_route(solver, st0, steps):
    """run_steps_history on the graph route's code with the trace-route
    step graph (`trace_step_graph`); returns (state, f, g, counts, host
    syncs). Restores driver._StepGraph."""
    from dpgo_tpu_torch import driver

    saved = driver._StepGraph
    driver._StepGraph = trace_step_graph()
    solver._graph_route = lambda: True
    try:
        _reset(solver)
        st, k, (f, g) = solver.run_steps_history(st0, 0, steps)
        assert k == steps
        return st, f, g, _counts(solver), solver.syncs.count
    finally:
        driver._StepGraph = saved
        del solver._graph_route


def _states_equal(a, b) -> bool:
    from dpgo_tpu_torch.utils import flatten
    return all(torch.equal(x, y) for x, y in zip(flatten(a)[0],
                                                  flatten(b)[0]))


def trace_cases(rank: int, world_size: int, device, graphs: dict) -> dict:
    """Per case of TRACE_CASES on this rank: the host route
    (run_steps_history_eager) and the graph route's code on the trace route
    (`trace_route`), STEPS steps each from one start. Returns the
    histories, the device counters of both routes, the host route's Python
    collective counts and notes, and whether the final states are equal bit
    for bit. Then the graph key: a copy of the boundary solver with another
    halo strategy (as chip_smoke.py's sharded phase makes them) must not
    replay the first strategy's graph."""
    import copy

    torch.set_num_threads(1)
    out = {}
    for name in TRACE_CASES:
        solver = _trace_solver(name, graphs, device)
        st0 = solver.initialize()
        _reset(solver)
        hs, _, (hf, hg) = solver.run_steps_history_eager(st0, 0, STEPS)
        host = _counts(solver)
        py = (solver.comm.calls, solver.comm.bytes, solver.comm.host_copies)
        notes = {n: list(v) for n, v in solver.syncs.loops.items()}
        ts, tf, tg, trace, syncs = trace_route(solver, st0, STEPS)
        out[name] = dict(
            f=hf.numpy(), g=hg.numpy(), trace_f=tf.numpy(),
            trace_g=tg.numpy(), host=host, trace=trace, python=py,
            notes=notes, trace_syncs=syncs,
            states_equal=_states_equal(hs, ts),
            ring_rounds=solver.ring_rounds)

    # The graph key: a copy with another strategy shares the graph slot
    # but must not replay the captured step.
    solver = _trace_solver("acc_boundary", graphs, device)
    st0 = solver.initialize()
    trace_route(solver, st0, 3)
    graph = solver._graph
    other = copy.copy(solver)
    other.halo = "gather"
    keys = {"same": graph.matches(solver._graph_key(st0)),
            "other": graph.matches(other._graph_key(st0))}
    trace_route(other, st0, 3)
    keys["recaptured"] = other._graph is not graph
    out["graph_key"] = keys
    return out


def single_trace_history(name: str, graphs: dict) -> tuple:
    """The port's single-process solver on a trace case (host route):
    (2f, 2|grad|) histories, numpy."""
    solver = _trace_solver(name, graphs, "cpu", sharded=False)
    _, _, (f, g) = solver.run_steps_history(solver.initialize(), 0, STEPS)
    return f.numpy(), g.numpy()


def nccl_graph_checks(rank: int, world_size: int, device,
                      graphs: dict) -> dict:
    """On a card over NCCL (tests/test_torch_cuda.py): AMM-PGO# and
    AMM-PGO* in float32 and float64, STEPS steps with history on the graph
    route (host flag reads counted) and on the host-read route from the
    same start; then 5 steps on the graph route under
    torch.cuda.set_sync_debug_mode("error") (None: no host read; else what
    raised). Last, a step that reads the card on the host: whether
    run_steps raised (its message), kept no graph, and the host-read route
    still ran."""
    def build(name, dtype):
        return make_solver(name, graphs, device, True, dtype=dtype)[0]

    out = {}
    for name in ("acc_boundary", "star_psi"):
        for dtype in (torch.float32, torch.float64):
            solver = build(name, dtype)
            st0 = solver.initialize()
            syncs = solver.syncs.count
            _, _, (f, g) = solver.run_steps_history(st0, 0, STEPS)
            graph_syncs = solver.syncs.count - syncs
            _, _, (fe, ge) = solver.run_steps_history_eager(st0, 0, STEPS)
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")
            try:
                solver.run_steps(st0, 0, 5)
                replay_sync = None
            except RuntimeError as exc:
                replay_sync = str(exc)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out[f"{name}_{str(dtype)[6:]}"] = dict(
                f=f.cpu().numpy(), fe=fe.cpu().numpy(), g=g.cpu().numpy(),
                ge=ge.cpu().numpy(), graph_syncs=graph_syncs,
                eager_syncs=solver.syncs.count - syncs - graph_syncs,
                captured=solver._graph is not None,
                replay_sync=replay_sync, backend=solver.comm.backend)

    solver = build("acc_boundary", torch.float32)
    st0 = solver.initialize()
    advance = solver._advance

    def reads_the_card(probs, st, k):
        res = advance(probs, st, k)
        float(res[0].fobj.sum())
        return res

    solver._advance = reads_the_card
    try:
        solver.run_steps(st0, 0, 3)
        raised = None
    except RuntimeError as exc:
        raised = str(exc)
    del solver._advance
    st, k = solver.run_steps_eager(st0, 0, 2)
    out["failed_capture"] = dict(
        raised=raised, no_graph=solver._graph is None,
        eager_ran=k == 2 and bool(torch.isfinite(st.Z.t).all()))
    return out


# ------------------------------------------- the split polish's trace

def trace_run_once(device, fn):
    """graph_nodes.run_once on the "trace" route: nothing is captured, and
    `fn` runs with every branch and loop trip merged, which is what the
    captured program's conditional nodes compute."""
    import types

    from dpgo_tpu_torch.utils import route

    with route("trace"):
        out = fn()
    return out, types.SimpleNamespace(capture_s=0.0, warmup_s=0.0,
                                      pool_bytes=0, replay_s=lambda: 0.0)


def _polish_route(name, graphs, device, trace: bool) -> dict:
    """drive() of a polish case on the host-read route, or (`trace`) on the
    graph route's code (`_graph_route` forced, as NCCL on a card has it;
    graph_nodes.run_once on the trace route): 2f, history, stats, rows and
    the host flag reads."""
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    solver, c = make_solver(name, graphs, device, sharded=True)
    solver.syncs = HostSyncs()
    DeviceCounters.reset()
    saved = graph_nodes.run_once
    if trace:
        graph_nodes.run_once = trace_run_once
        solver._graph_route = lambda: True
    try:
        res = drive(solver, c)
    finally:
        graph_nodes.run_once = saved
    res.update(host_syncs=solver.syncs.count, node_lo=solver.node_lo,
               node_hi=solver.node_hi)
    return res


def polish_trace_cases(rank: int, world_size: int, device,
                       graphs: dict) -> dict:
    """Per case of POLISH_CASES on this rank: the split polish on the
    host-read route and on the graph route's code (`_polish_route`), from
    one start. Returns {case: {"host": ..., "trace": ...}}."""
    torch.set_num_threads(1)
    return {name: {"host": _polish_route(name, graphs, device, False),
                   "trace": _polish_route(name, graphs, device, True)}
            for name in POLISH_CASES}


def nccl_polish_checks(rank: int, world_size: int, device,
                       graphs: dict) -> dict:
    """On a card over NCCL (tests/test_torch_cuda.py): the split polish of
    the cases "polish" and "polish_levels" on the graph route (the TNT
    captured, its collectives inside) and on the host-read route
    (`eager=True`) from one start: 2f, host flag reads over the polish and
    the polish's stats, per route."""
    from dpgo_tpu_torch.utils import HostSyncs

    out = {}
    for name in ("polish", "polish_levels"):
        solver, c = make_solver(name, graphs, device, sharded=True)
        st = solver.initialize()
        for eager in (False, True):
            solver.syncs = HostSyncs()
            _, f2 = solver.polish(st, **dict(c["polish"], eager=eager))
            out[(name, eager)] = dict(
                f2=f2, host_syncs=solver.syncs.count,
                **{k: v for k, v in solver.polish_stats.items()
                   if k != "history"})
    return out
