"""One cell of the benchmark: set-up, the measured window of solves, the
traced solves and the check of every answer against the plain reference.

A solve is `DPGOSolver.run_steps(st0, 0, K)` from the state the set-up
made, then the gathered estimate copied to the host: the answer. The
window runs solves back to back, each waiting for the last, until its
seconds are up; its rate is all the steps over all the time.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from pgobench import manifest
from pgobench.reference import pgo as reference

# The program's device counters read over a window (utils.DeviceCounters):
# kernel launches (K3's "block_mm" bumped inside its own launch),
# conditional-node flag launches, the bounded loops' entries and trips, and
# the sharded solvers' collectives, their bytes and host copies
# (parallel/spmd.py, Collectives.COUNTERS).
COUNTERS = ("stpcg", "stpcg_d2", "polar_so3", "block_mm", "graph_cond",
            "tnt.entries", "tnt.trips", "stpcg.entries", "stpcg.trips",
            "seg_cg.entries", "seg_cg.trips", "collectives",
            "collective_bytes", "collective_host_copies")
# Answers the check judges at most in one run: a window that runs more
# (only a fault is that fast) is judged on a sample.
MAX_JUDGED = 64


@dataclasses.dataclass
class CellSpec:
    """A workload of BENCHMARK.json with its configuration, mix and cell
    files, and the metrics it reports (end-to-end and per-layer)."""

    name: str
    chips: int
    config: dict
    mix: dict
    cell: dict
    end_to_end: list
    per_layer: list

    @staticmethod
    def load(bench: dict, name: str) -> "CellSpec":
        w = manifest.workload(bench, name)

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return CellSpec(name=name, chips=w["chips"],
                        config=manifest.config(bench, w["config"]),
                        mix=manifest.mix(w["traffic"]),
                        cell=manifest.cell(name),
                        end_to_end=mine(bench["end_to_end"]),
                        per_layer=mine(bench["per_layer"]))


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (metrics/<name>.py)."""

    card: str
    num_nodes: int
    num_poses: int
    d: int
    spans: dict        # seconds: build_s, init_s, warmup_s, capture_s
    steps: int         # steps of the window
    counters: dict     # device counters over the window
    host_syncs: int    # host flag reads over the window
    traced_steps: int
    traced_counters: dict
    trace: object      # trace.Trace of the traced solves


def make_graph(config: dict, seed: int) -> dict:
    """The configuration's graph (its noise drawn once, from the seed in
    the configuration), its edges in an order drawn from the run's seed
    (any whole number): every seed brings the same problem and so the same
    work, in another order."""
    g = manifest.generator(config["generator"]).graph(**config["graph"])
    order = np.random.default_rng(int(seed) % 2 ** 64).permutation(
        len(g["i"]))
    for k in ("i", "j", "R", "t", "kappa", "tau"):
        g[k] = g[k][order]
    return g


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    graph: dict
    solver: object
    st0: object
    steps_per_solve: int
    spans: dict


def setup(spec: CellSpec, seed: int, device, ctx=None) -> Setup:
    """Graph, problem build (`ctx.solver`), start and first update, then
    one step and one answer: the warm-up and capture of everything the
    window runs."""
    import torch

    from dpgo_tpu_torch.io.g2o import Measurements
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    cfg, spans = spec.config, {}
    t0 = time.perf_counter()
    g = make_graph(cfg, seed)
    spans["graph_s"] = time.perf_counter() - t0
    meas = Measurements(i=g["i"], j=g["j"], R=g["R"], t=g["t"],
                        kappa=g["kappa"], tau=g["tau"],
                        num_poses=g["num_poses"], d=g["d"])
    opts = dict(spec.mix["options"])
    opts = MMOptions(tnt=TNTParams(**opts.pop("tnt", {})), **opts)
    ctx = ctx or SOLO
    t0 = time.perf_counter()
    solver = ctx.solver(meas, cfg["num_nodes"], opts,
                        getattr(torch, cfg["dtype"]), device)
    sync(device)
    spans["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st0 = solver.initialize()
    sync(device)
    spans["init_s"] = time.perf_counter() - t0
    s = Setup(graph=g, solver=solver, st0=st0,
              steps_per_solve=spec.cell["steps_per_solve"], spans=spans)
    warm(s, ctx)
    return s


def warm(s: Setup, ctx=None) -> None:
    """One step and one answer (captures the step on the card)."""
    t0 = time.perf_counter()
    st, _ = s.solver.run_steps(s.st0, 0, 1)
    (ctx or SOLO).answer(s.solver, st)
    s.spans["warm_s"] = time.perf_counter() - t0
    stats = s.solver.graph_stats() or {"warmup_s": 0.0, "capture_s": 0.0}
    s.spans["warmup_s"] = stats["warmup_s"]
    s.spans["capture_s"] = stats["capture_s"]


def answer(solver, st):
    """The answer of a solve on the host: the gathered estimate (t, R) and
    the program's own objective at it, the sum of the node objectives."""
    t, R = solver.gather_global(st)
    return t.cpu().numpy(), R.cpu().numpy(), float(st.fobj.sum())


class Solo:
    """A run in one process, on one device: it builds the single-process
    solver, keeps every answer, decides alone when a window closes and is
    traced. (sharded.Rank is the same for one rank of a process group.)"""

    lead = True

    def solver(self, meas, num_nodes: int, opts, dtype, device):
        from dpgo_tpu_torch.driver import DPGOSolver
        return DPGOSolver(meas, num_nodes, opts, dtype=dtype, device=device)

    def answer(self, solver, st):
        return answer(solver, st)

    def agree(self, done: bool) -> bool:
        return done

    def barrier(self) -> None:
        pass


SOLO = Solo()


def read_counters() -> dict:
    from dpgo_tpu_torch.utils import DeviceCounters
    return {n: DeviceCounters.read(n) for n in COUNTERS}


def reset_counters() -> None:
    from dpgo_tpu_torch.utils import DeviceCounters
    DeviceCounters.reset()


@dataclasses.dataclass
class Window:
    answers: list
    steps: int
    seconds: float
    counters: dict
    host_syncs: int
    solve_s: list      # seconds of each solve, its answer included


def window(s: Setup, seconds: float, device,
           max_solves: int | None = None, ctx=None) -> Window:
    """Solves back to back until `seconds` have passed (or `max_solves`
    are done); every answer is kept for the check. After each solve the
    lead's decision holds for every process of the run (`ctx.agree`)."""
    ctx = ctx or SOLO
    solver, K = s.solver, s.steps_per_solve
    sync(device)
    reset_counters()
    syncs0 = solver.syncs.count
    answers, marks = [], []
    t0 = time.perf_counter()
    while True:
        st, _ = solver.run_steps(s.st0, 0, K)
        answers.append(ctx.answer(solver, st))
        marks.append(time.perf_counter())
        if ctx.agree(marks[-1] - t0 >= seconds
                     or len(answers) == max_solves):
            break
    secs = time.perf_counter() - t0
    return Window(answers=answers, steps=K * len(answers), seconds=secs,
                  counters=read_counters(),
                  host_syncs=solver.syncs.count - syncs0,
                  solve_s=np.diff([t0] + marks).tolist())


def traced(s: Setup, solves: int, device, ctx=None):
    """`solves` more solves under torch.profiler, recording the card's
    activity alone (kernels, copies, the CUDA API calls that launch them),
    not the host's operators; the per-kernel records still slow a solve
    down, so the traced seconds of each solve are returned beside the
    window's. Returns (trace, answers, device counters over them, steps,
    seconds of each traced solve)."""
    from torch.profiler import ProfilerActivity, profile

    from pgobench import trace as trace_mod

    ctx = ctx or SOLO
    solver, K = s.solver, s.steps_per_solve
    sync(device)
    reset_counters()
    answers, marks = [], []
    card = device.type == "cuda"
    acts = [ProfilerActivity.CUDA if card else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(solves):
            st, _ = solver.run_steps(s.st0, 0, K)
            answers.append(ctx.answer(solver, st))
            marks.append(time.perf_counter())
    counters = read_counters()
    return (trace_mod.from_profile(prof, card), answers, counters, K * solves,
            np.diff([t0] + marks).tolist())


def tnt_off(mix: dict, counters: dict) -> float:
    """1 where the window's TNT refinement ran otherwise than the mix
    states (a refining mix whose steps never entered the TNT, or a mix
    without it whose steps did), else 0: from the program's counter of TNT
    entries over the window."""
    tnt = mix["options"]["tnt"]
    refines = tnt["max_iterations"] > 0 and \
        tnt.get("max_iterations_accepted", 1) > 0
    return float(refines != (counters["tnt.entries"] > 0))


def judge(g: dict, answers: list, limits: dict, seed: int = 0,
          off: float = 0.0) -> dict:
    """Every answer (or, past MAX_JUDGED of them, the first, the last and a
    sample drawn from the seed) against the plain reference, in float64
    from the measurements:
    - f_gap: |the program's objective - the reference's at the program's
      estimate| / the reference's (the problem build, the gather);
    - grad_rel: the reference's Riemannian gradient norm at the estimate
      over its norm at the ground truth, which the noise alone sets (the
      iterate, the TNT and the exchange made progress);
    and the window's `tnt_off` (see there): where it is over its limit,
    no answer came from the mix's algorithm and every one fails.
    Returns {"numbers": worst of each, "failed": answers over a limit}."""
    if len(answers) > MAX_JUDGED:
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        pick = rng.choice(np.arange(1, len(answers) - 1), MAX_JUDGED - 2,
                          replace=False)
        answers = [answers[k] for k in
                   sorted({0, len(answers) - 1, *pick.tolist()})]
    g_true = reference.grad_norm(g, g["t_true"], g["R_true"])
    worst = {"f_gap": 0.0, "grad_rel": 0.0}
    failed = 0
    for t, R, f_claim in answers:
        if (np.isfinite(t).all() and np.isfinite(R).all()
                and math.isfinite(f_claim)):
            f_ref = reference.objective(g, t, R)
            nums = {"f_gap": abs(f_claim - f_ref) / f_ref,
                    "grad_rel": reference.grad_norm(g, t, R) / g_true}
        else:
            nums = {k: math.inf for k in worst}
        failed += (any(not nums[k] <= limits[k] for k in worst)
                   or not off <= limits["tnt_off"])
        worst = {k: max(worst[k], nums[k]) for k in worst}
    return {"numbers": dict(worst, tnt_off=off), "failed": failed}


def card_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def measure(spec: CellSpec, seed: int, seconds: float, trace: bool, device,
            plant=None, ctx=None) -> dict:
    """One run: set-up, window, traced solves, the per-layer readings and
    the check (once the window has closed, the peak is read and the
    program's state is freed). `plant(setup)`, if given, breaks the timed
    path after the set-up (the fault tests). `ctx` (Solo where None) is
    the process's place in the run: the set-up closes once every process
    of the run has passed `ctx.barrier`, and only the lead is traced,
    reads the per-layer metrics and judges the answers; another process
    runs the same solves untraced and returns no check."""
    import torch

    ctx = ctx or SOLO
    t0 = time.perf_counter()
    s = setup(spec, seed, device, ctx)
    if plant is not None:
        plant(s)
        warm(s, ctx)
    ctx.barrier()
    set_up = time.perf_counter()
    s.spans["setup_s"] = set_up - t0
    # Solves before the window, to let the card's pace settle: a process
    # that is not the first on its card often runs the same solves 5-12%
    # slower for its first seconds, then switches to the first's pace.
    # They are the window's own solves, already captured: no set-up.
    window(s, spec.cell["warm_seconds"], device, ctx=ctx)
    s.spans["settle_s"] = time.perf_counter() - set_up
    w = window(s, seconds, device, ctx=ctx)
    out = {"steps": w.steps, "seconds": w.seconds, "set_up": set_up,
           "solves": len(w.answers), "solve_s": w.solve_s,
           "counters": {k: v / w.steps for k, v in w.counters.items()}}
    answers = w.answers
    if trace and ctx.lead:
        tr, more, tcount, tsteps, tsolve_s = traced(
            s, spec.cell["trace_solves"], device, ctx)
        answers = answers + more
        out["traced_solve_s"] = tsolve_s
        rd = Readings(card=card_name(device), num_nodes=s.solver.num_nodes,
                      num_poses=s.graph["num_poses"], d=s.graph["d"],
                      spans=s.spans, steps=w.steps, counters=w.counters,
                      host_syncs=w.host_syncs, traced_steps=tsteps,
                      traced_counters=tcount, trace=tr)
        out["per_layer"] = {}
        for m in spec.per_layer:
            value = manifest.reader(m["name"]).read(rd)
            if value is not None:
                out["per_layer"][m["name"]] = value
        out.update(busy_s=tr.busy_s(), window_s=tr.window_s,
                   breakdown=tr.breakdown())
    elif trace:
        # The lead's traced solves, untraced here.
        for _ in range(spec.cell["trace_solves"]):
            st, _ = s.solver.run_steps(s.st0, 0, s.steps_per_solve)
            ctx.answer(s.solver, st)
    out["peak"] = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    out["spans"] = s.spans
    out["attempted"] = len(answers)
    g = s.graph
    del s
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.lead:
        out["check"] = judge(g, answers, spec.cell["limits"], seed,
                             tnt_off(spec.mix, w.counters))
    return out


def result(spec: CellSpec, part: dict, trace: bool, t_start: float,
           card: str, platform: str) -> dict:
    """The result line: the end-to-end metrics (set-up up to the settle,
    the window's rate) or the per-layer readings, the device, and last the
    check."""
    check = part["check"]
    metrics = {}
    if not trace:
        rate = part["steps"] / part["seconds"]
        # A cell on several cards reports its rate under a name of its own:
        # its runs spread wider than the bound of the cells on one card.
        e2e = {"setup_s": part["set_up"] - t_start, "iters_per_s": rate,
               "sharded_iters_per_s": rate}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.per_layer:
            if m["name"] in part["per_layer"]:
                metrics[m["name"]] = {"value": part["per_layer"][m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": platform, "kind": card, "count": 1,
           "memory_peak_bytes": part["peak"]}
    out = {"correct": check["failed"] == 0 and part["attempted"] > 0,
           "attempted": part["attempted"], "failed": check["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = part["busy_s"]
        dev["window_s"] = part["window_s"]
        out["breakdown"] = part["breakdown"]
    out["spans"] = part["spans"]
    out["window"] = {"solve_s": part["solve_s"],
                     "traced_solve_s": part.get("traced_solve_s", []),
                     "counters_per_step": part["counters"]}
    out["check"] = {k: {"value": v, "limit": spec.cell["limits"][k]}
                    for k, v in check["numbers"].items()}
    return out


def run(spec: CellSpec, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant=None) -> dict:
    """One run of a cell in this process: the result line's content."""
    part = measure(spec, seed, seconds, trace, device, plant=plant)
    return result(spec, part, trace, t_start, card_name(device),
                  "gpu" if device.type == "cuda" else device.type)

