"""The sharded solvers over NCCL at world size 4 on the graph route: one
rank per card on four cards of one host, rim_synth (16 nodes, 4 per rank).

    python3 tools/nccl4_graph.py          # needs four CUDA cards
    python3 tools/nccl4_graph.py --probe  # the short check first
    python3 tools/nccl4_graph.py --world 1  # the same runs on one card

What runs, each held as chip_smoke.py's sharded phase holds nccl1's
(`chip_smoke.sharded_rank` in the ranks, `_sharded_record`,
`_sharded_polish_record` and `_split_polish_routes` here), every run on
the graph route (held), the same program as nccl1's: collectives inside
conditional bodies too, which NCCL captures at this world size with
NCCL_GRAPH_MIXING_SUPPORT=0 (parallel/launch.py sets it; with NCCL's
default the capture fails, `--probe`):
- AMM-PGO# (float32, refined preset, boundary exchange), 150 steps on the
  graph route (the step captured with its NCCL all_gather), timed, then on
  the host-read route in the same ranks;
- the ring exchange, 20 steps on the graph route (its `batch_isend_irecv`
  rounds recorded into the captured step) and on the host-read route, in
  a run of its own after the others, whose failure is reported after
  their records;
- AMM-PGO*, 50 steps on the graph route (the master's all_reduces inside
  its IF bodies), timed, then on the host-read route in the same ranks;
- the split polish of rim's estimate (float64, `polish(outer=10, tcg=300,
  coarse=True)`) on the graph route (its TNT one captured program, the
  halo exchanges and all_reduces inside the WHILE bodies, 0 host syncs)
  and on the host-read route in the same ranks.
With `--probe` only the short check runs: the conditional-node probe
(chip_smoke.probe_nccl_conditional: all_reduce and all_gather captured at
the top level of a graph, held equal to eager, and inside IF and WHILE
bodies, with the graph node types each case's collective recorded) in a
fresh group of four ranks under each of NCCL_SETTINGS, printed with a JSON
line; then, under parallel/launch.py's settings, the probe (every case
held "ok") and 10 AMM-PGO# steps on grid3D_synth (8 nodes, float64) on
the graph route with the boundary and the ring exchange beside the
host-read route (2f within 1e-10 at every step). `--with-probe` runs the
probe's settings first and then the whole run; `--world N` the whole run
at another world size (1: on one card).
The references are computed first in this process on cuda:0: the
single-process AMM-PGO# and AMM-PGO* histories and it/s, and the
single-process polish of the same estimate. Prints one line per run and,
last, a JSON object of the records; exits non-zero if a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

WORLD = 4
RING_STEPS = 20
# A collective that waits longer raises in its rank; a spawn that outlives
# DEADLINE is stopped (each rank reports its progress on stderr, so a hang
# shows where it happened).
COLLECTIVE_TIMEOUT, DEADLINE = 120.0, 720.0


def single_refs(rim, init, dev):
    """The single-process references on `dev`: AMM-PGO# (150 steps) and
    AMM-PGO* (50 steps) histories with their it/s, rim's float32 estimate
    after its 150 steps, and the float64 polish of that estimate."""
    import torch

    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    refs = {}
    for key, cls, steps in (("rim", DPGOSolver, smoke.SHARDED_STEPS),
                            ("star", DPGOStarSolver,
                             smoke.SHARDED_STAR_STEPS)):
        solver = cls(rim, num_nodes=smoke.NUM_NODES,
                     opts=MMOptions(accelerated=True), dtype=torch.float32,
                     device=dev)
        st = solver.initialize(*init)
        solver.run_steps(st, 0, 1)        # the capture, outside the timing
        torch.cuda.synchronize()
        st, _, (fh, _) = solver.run_steps_history(st, 0, steps)
        t0 = time.perf_counter()
        solver.run_steps(solver.initialize(*init), 0, steps)
        torch.cuda.synchronize()
        refs[key] = {"f2_history": fh.cpu().numpy(),
                     "it_s": steps / (time.perf_counter() - t0)}
        if key == "rim":
            est = tuple(x.double().cpu().numpy()
                        for x in solver.gather_global(st))
        del solver, st
    solver = DPGOSolver(rim, num_nodes=smoke.NUM_NODES,
                        opts=MMOptions(tnt=TNTParams(max_iterations=0)),
                        dtype=torch.float64, device=dev)
    run = smoke.timed_polish(solver, solver.initialize(*est),
                             dict(outer=smoke.POLISH_OUTER,
                                  tcg=smoke.POLISH_TCG, coarse=True), dev)
    refs["polish_rim"] = {"f2": run["f2"], "memory": run["memory"],
                          "problem_bytes": smoke.problem_bytes(solver.probs),
                          "seconds": run["seconds"]}
    print(f"single process on {dev}: rim {refs['rim']['it_s']:.2f} it/s, "
          f"star {refs['star']['it_s']:.2f} it/s, polish_rim "
          f"{run['seconds']:.2f} s, 2f {run['f2']:.10f}")
    return refs, est


def rank_main(rank, world_size, device, jobs, ring_job, card):
    """One rank: `jobs` one at a time through chip_smoke.sharded_rank (the
    NCCL probe before the first), then the ring run alone, whose failure
    (a P2P capture refused) is returned as text, so that the other runs'
    records come back either way. Each start and end goes to stderr, so
    that a run which hangs until the deadline shows where."""
    t0 = time.perf_counter()

    def say(msg):
        print(f"nccl4 rank {rank}: {msg} at {time.perf_counter() - t0:.1f} "
              "s", file=sys.stderr, flush=True)

    recs = []
    for i, job in enumerate(jobs):
        say(f"{job['runs'][0]['key']} starts" + (" (probe first)"
                                                 if i == 0 else ""))
        recs += smoke.sharded_rank(rank, world_size, device, [job], card,
                                   probe_first=i == 0, log=say)
        say(f"{job['runs'][0]['key']} done")
    recs[-1]["rank_s"] = time.perf_counter() - t0
    say("rim_ring starts")
    try:
        ring = smoke.sharded_rank(rank, world_size, device, [ring_job],
                                  card, probe_first=False, log=say)
        say("rim_ring done")
    except Exception as exc:  # reported and failed on in main()
        ring = f"{type(exc).__name__}: {str(exc)[:500]}"
        say(f"rim_ring failed: {ring}")
    return recs, ring


PROBE_STEPS = 10
PROBE_DEADLINE = 150.0
# NCCL's settings that change what a launch records under capture, each
# tried alone over NCCL's defaults in a fresh group of four ranks by
# `--probe` (NCCL reads them once per process), then all together. NCCL's
# default NCCL_GRAPH_MIXING_SUPPORT=1 is named, since parallel/launch.py
# sets 0 where the environment names no value.
NCCL_LEADS = {"NCCL_GRAPH_MIXING_SUPPORT": "0", "NCCL_NVLS_ENABLE": "0",
              "NCCL_GRAPH_REGISTER": "0",
              "NCCL_ALGO": "Ring", "NCCL_PROTO": "Simple"}
_MIXING = {"NCCL_GRAPH_MIXING_SUPPORT": "1"}
NCCL_SETTINGS = ([("default", dict(_MIXING)),
                  ("NCCL_GRAPH_MIXING_SUPPORT=0",
                   {"NCCL_GRAPH_MIXING_SUPPORT": "0"})]
                 + [(f"{k}={v}", dict(_MIXING, **{k: v}))
                    for k, v in NCCL_LEADS.items()
                    if k not in ("NCCL_GRAPH_MIXING_SUPPORT", "NCCL_ALGO",
                                 "NCCL_PROTO")]
                 + [("NCCL_ALGO=Ring NCCL_PROTO=Simple",
                     dict(_MIXING, NCCL_ALGO="Ring", NCCL_PROTO="Simple")),
                    ("all of them", dict(NCCL_LEADS))])
SETTING_DEADLINE = 90.0


def probe_rank(rank, world_size, device, grid):
    """The short check on one rank (module docstring, `--probe`): the
    conditional-node probe with the node types each case's collective
    recorded, and with `grid` AMM-PGO#'s steps on both routes."""
    import torch

    from dpgo_tpu_torch.parallel.spmd import Collectives, ShardedDPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    t0 = time.perf_counter()

    def say(msg):
        print(f"nccl4 probe rank {rank}: {msg} at "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)

    say("conditional-node probe starts")
    nodes = {}
    out = {"probe": smoke.probe_nccl_conditional(Collectives(None, device),
                                                 device, nodes),
           "nodes": nodes,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "env": {k: os.environ.get(k) for k in NCCL_LEADS}}
    say(f"conditional-node probe done: {out['probe']}")
    if grid is None:
        return out
    for halo in ("boundary", "ring"):
        solver = ShardedDPGOSolver(grid, 8, opts=MMOptions(accelerated=True),
                                   dtype=torch.float64, device=device,
                                   halo=halo)
        st0 = solver.initialize()
        say(f"{halo}: graph route starts ({solver.ring_rounds} ring "
            "rounds)")
        _, _, (f, _) = solver.run_steps_history(st0, 0, PROBE_STEPS)
        say(f"{halo}: graph route done")
        _, _, (fe, _) = solver.run_steps_history_eager(st0, 0, PROBE_STEPS)
        out[halo] = {"route": "graph" if solver._graph_route() else "host",
                     "ring_rounds": solver.ring_rounds,
                     "f2": f.cpu().numpy(), "f2_host": fe.cpu().numpy()}
    return out


def probe_settings(card) -> dict:
    """The conditional-node probe in a fresh group of four NCCL ranks under
    each of NCCL_SETTINGS: one line per setting and rank, the node types
    rank 0's collectives recorded, and a JSON line. Returns {setting:
    whether every body case was "ok" on every rank}."""
    from dpgo_tpu_torch.parallel.launch import spawn

    devices = [f"cuda:{r}" for r in range(WORLD)]
    saved = {k: os.environ.get(k) for k in NCCL_LEADS}
    settings = {}
    for label, env in NCCL_SETTINGS:
        t0 = time.perf_counter()
        for k in NCCL_LEADS:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            res = spawn(probe_rank, WORLD, backend="nccl", devices=devices,
                        args=(None,), timeout=30.0,
                        deadline=SETTING_DEADLINE)
        except RuntimeError as exc:
            res = f"spawn failed: {str(exc)[-800:]}"
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        secs = time.perf_counter() - t0
        settings[label] = res
        if isinstance(res, str):
            print(f"nccl4 probe [{card}] {label}: {secs:.1f} s, {res}")
            continue
        print(f"nccl4 probe [{card}] {label}: {secs:.1f} s, NCCL "
              f"{res[0]['nccl']}, env {res[0]['env']}")
        for r, out in enumerate(res):
            print(f"  rank {r}: " + ", ".join(
                f"{k} {v.splitlines()[0]}" for k, v in out["probe"].items()))
        for k, v in res[0]["nodes"].items():
            print(f"  rank 0 {k} recorded: {v}")
    bodies = {label: all(v == "ok" for out in res
                         for v in out["probe"].values())
              for label, res in settings.items() if not isinstance(res, str)}
    print(json.dumps({"nccl4_probe_settings": {
        label: (res if isinstance(res, str) else
                {"probe": res[0]["probe"], "nodes": res[0]["nodes"],
                 "nccl": res[0]["nccl"],
                 "ranks_agree": all(o["probe"] == res[0]["probe"]
                                    for o in res)})
        for label, res in settings.items()},
        "bodies_capture": bodies}))
    return bodies


def probe_main(card) -> int:
    """`--probe`: the short check in four NCCL ranks (module docstring):
    probe_settings, then AMM-PGO#'s steps under the default settings."""
    import numpy as np

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.parallel.launch import spawn

    probe_settings(card)
    grid = read_g2o_file(os.path.join(ROOT, smoke.GRID3D))
    devices = [f"cuda:{r}" for r in range(WORLD)]
    t0 = time.perf_counter()
    res = spawn(probe_rank, WORLD, backend="nccl", devices=devices,
                args=(grid,), timeout=60.0, deadline=PROBE_DEADLINE)
    print(f"nccl4 probe [{card}]: spawn {time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(res):
        smoke.check(all(v == "ok" for v in out["probe"].values()),
                    f"nccl4 probe rank {r}: {out['probe']}")
        for halo in ("boundary", "ring"):
            o = out[halo]
            rel = float(np.max(np.abs(o["f2"] - o["f2_host"])
                               / np.abs(o["f2_host"])))
            print(f"nccl4 probe rank {r} {halo}: route {o['route']}, "
                  f"{o['ring_rounds']} ring rounds, 2f at {PROBE_STEPS} "
                  f"{o['f2'][-1]:.10f} vs {o['f2_host'][-1]:.10f} on the "
                  f"host-read route, largest relative gap {rel:.3e}")
            smoke.check(o["route"] == "graph" and rel <= 1e-10,
                        f"nccl4 probe rank {r} {halo}: route {o['route']}, "
                        f"gap {rel}")
    return 0


def main() -> int:
    import torch

    global WORLD
    if "--world" in sys.argv[1:]:
        # Another world size (1: the same runs and holds on one card).
        WORLD = int(sys.argv[sys.argv.index("--world") + 1])
    if torch.cuda.device_count() < WORLD:
        print(f"nccl4_graph: needs {WORLD} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import dpgo_tpu_torch  # noqa: F401  (sets true-f32 matmuls)
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.parallel.launch import spawn
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    card = smi.splitlines()[0]
    if "--probe" in sys.argv[1:]:
        _build.load()
        return probe_main(card)
    if "--with-probe" in sys.argv[1:]:
        _build.load()
        probe_settings(card)
    t_start = time.perf_counter()
    _build.load()
    dev = torch.device("cuda", 0)
    rim = read_g2o_file(os.path.join(ROOT, smoke.DATASET))
    R0 = chordal_initialization(rim)
    init = (recover_translations_global(rim, R0), R0)
    refs, est = single_refs(rim, init, dev)

    rim_job = dict(meas=rim, init=init, cls="hash", runs=[
        dict(key="rim_boundary", halo="boundary", steps=smoke.SHARDED_STEPS,
             deterministic=False, timed=True, eager=True)])
    ring_job = dict(rim_job, runs=[
        dict(key="rim_ring", halo="ring", steps=RING_STEPS,
             deterministic=False, timed=False, eager=True)])
    star_job = dict(meas=rim, init=init, cls="star", runs=[
        dict(key="star_boundary", halo="boundary",
             steps=smoke.SHARDED_STAR_STEPS, deterministic=False,
             timed=True, eager=True)])
    polish_job = dict(meas=rim, init=est, cls="hash", dtype="float64",
                      tnt={"max_iterations": 0}, runs=[dict(
                          key="polish_rim", halo="boundary", steps=0,
                          deterministic=False, timed=False, eager=True,
                          polish=dict(outer=smoke.POLISH_OUTER,
                                      tcg=smoke.POLISH_TCG, coarse=True))])
    # Every run takes the graph route at this world size.
    routes = {"rim_boundary": "graph", "rim_ring": "graph",
              "star_boundary": "graph", "polish_rim": "graph"}
    jobs = [rim_job, star_job, polish_job]
    t0 = time.perf_counter()
    both = spawn(rank_main, WORLD, backend="nccl",
                 devices=[f"cuda:{r}" for r in range(WORLD)],
                 args=(jobs, ring_job, card), timeout=COLLECTIVE_TIMEOUT,
                 deadline=DEADLINE)
    res = [recs for recs, _ in both]
    rank_s = max(recs[-1]["rank_s"] for recs in res)
    rings = [ring for _, ring in both]
    failed = [r for r in rings if isinstance(r, str)]
    if not failed:
        # The ring's records join the others (after them in every rank).
        res = [recs + ring for recs, ring in zip(res, rings)]
    secs = time.perf_counter() - t0
    print(f"nccl{WORLD} [{card}]: {WORLD} ranks on cuda:0-{WORLD - 1}, spawn "
          f"{secs:.1f} s, of which in the ranks' function {rank_s:.1f} s "
          "(the ring run apart)")
    probe = res[0][0]["probe"]
    print("nccl4 probe: " + ", ".join(f"{k} {v.splitlines()[0]}"
                                      for k, v in probe.items()))
    smoke.check(all(v == "ok" for v in probe.values()),
                f"nccl4: an NCCL collective failed its capture: {probe}")
    out = {"card": card, "world": WORLD, "spawn_s": secs, "rank_s": rank_s,
           "runs": {}}
    for i, rec in enumerate(res[0]):
        mine = [rank_recs[i] for rank_recs in res]
        label = f"sharded nccl{WORLD} {rec['key']}"
        if rec["steps"]:
            got = [r["route"] for r in mine]
            run = smoke._sharded_record(label, mine, refs, card)
            run.pop("f2", None)
        else:
            recs = [r["polish"] for r in mine]
            got = [r["route"] for r in recs]
            run = smoke._sharded_polish_record(label, "polish_rim", recs,
                                               refs, card)
            run["eager"] = smoke._split_polish_routes(
                label, recs, [r["polish_eager"] for r in mine], card)
            run["graph"] = {k: recs[0][k] for k in (
                "seconds", "host_syncs", "capture_s", "warmup_s",
                "pool_bytes")}
        print(f"{label}: routes {got}")
        smoke.check(got == [routes[rec["key"]]] * WORLD,
                    f"{label}: routes {got}, want {routes[rec['key']]}")
        out["runs"][rec["key"]] = run
    out["seconds"] = time.perf_counter() - t_start
    out["ring_failed"] = failed
    print(f"nccl4_graph: {out['seconds']:.1f} s [{card}]")
    print(json.dumps(out, default=float))
    smoke.check(not failed, f"nccl4: the ring run failed: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
