"""What each rank runs in tests/test_torch_spmd.py (a module of its own so
that the spawned processes import torch and the port only, never jax).

`run_cases` drives the sharded solvers through every case of one world and
returns, per case, numpy results the test holds against JAX's single-process
solvers and the port's."""

from __future__ import annotations

import dataclasses

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
    elif name == "polish":
        c.update(opts=dict(tnt=TNTParams(max_iterations=0)), steps=0)
    else:
        raise KeyError(name)
    return c


HASH_CASES = [f"{a}_{h}" for a in ("acc", "plain")
              for h in ("boundary", "gather", "ring")]
CASES = HASH_CASES + ["huber_dynamic", "aa", "d2", "segment", "star",
                      "star_psi", "polish", "gauge_ring"]


def make_solver(name: str, graphs: dict, device, sharded: bool, group=None):
    from dpgo_tpu_torch import driver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.parallel import spmd
    from dpgo_tpu_torch.solvers.mm import MMOptions

    c = case_setup(name)
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
               loss_reg=LOSS_REG, dtype=torch.float64, device=device,
               **c["kw"], **extra), c


def drive(solver, c) -> dict:
    """initialize + the case's steps with history (or the polish); the
    result both the sharded run and the single-process run report."""
    st = solver.initialize()
    out = {}
    if c["steps"]:
        st, k, (f, g) = solver.run_steps_history(st, 0, c["steps"])
        assert k == c["steps"]
        out.update(f=f.cpu().numpy(), g=g.cpu().numpy())
    else:
        st, f2 = solver.polish(st, **POLISH)
        out.update(polish_f=f2)
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
        out[name] = res
    if names is not None:
        return out
    out["run_steps"] = _run_steps_equal(graphs, device)
    out["run_callback"] = _run_with_callback(graphs, device, rank)
    out["errors"] = _errors(graphs, device)
    out["build_ranges"] = _build_ranges(graphs, device)
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
