#!/usr/bin/env python3
"""Readings that the check's limits are set from, on the card at the
cell's own size: each seed's sound run, and on the first `--faulty` seeds
the controls (TF32 products, bfloat16 operators) and each planted fault,
all from one set-up per seed.

    python3 pgobench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--faulty 3] [--out calib.jsonl]

Prints one JSON line per (seed, variant): the worst f_gap and grad_rel
over the solves, tnt_off, the number of solves and it/s. A cell on
several cards runs in one group of ranks (sharded.calibrate), whose
lead prints the rows. The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PLANTED = ("run_steps", "_advance", "_exchange_halos", "gather_global")


def undo(s, probs, opts) -> None:
    """The solver as the set-up left it: planted methods gone, its own
    problems and options, true float32 products, the step captured
    again."""
    import torch
    s.solver.probs = probs
    s.solver.opts = opts
    s.solver._reweighted = (None, probs)
    for name in PLANTED:
        s.solver.__dict__.pop(name, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    s.solver._graph = None


def readings(spec, seed: int, seconds: float, variants, device,
             ctx=None) -> list:
    """One set-up for `seed`, then a window per variant (the sound run,
    then each plant undone after its window). `ctx` as in cell.measure:
    only the lead judges the answers and returns rows."""
    from pgobench import cell, faults

    ctx = ctx or cell.SOLO
    t0 = time.perf_counter()
    s = cell.setup(spec, seed, device, ctx)
    probs, opts = s.solver.probs, s.solver.opts
    setup_s = time.perf_counter() - t0
    out, max_solves = [], None
    for v in variants:
        if v != "sound":
            faults.apply(v, s, seed)
            cell.warm(s, ctx)
        w = cell.window(s, seconds, device, max_solves, ctx)
        if v == "sound":
            max_solves = len(w.answers)
        if ctx.lead:
            check = cell.judge(s.graph, w.answers, spec.cell["limits"],
                               seed, cell.tnt_off(spec.mix, w.counters))
            out.append({"cell": spec.name, "seed": seed, "variant": v,
                        **check["numbers"], "solves": len(w.answers),
                        "failed": check["failed"],
                        "it_s": w.steps / w.seconds, "setup_s": setup_s,
                        **{k: s.spans[k] for k in ("graph_s", "build_s",
                                                   "init_s", "warm_s")}})
        if v != "sound":
            undo(s, probs, opts)
            cell.warm(s, ctx)
    return out


def variants_of(n: int, faulty: int, spec) -> list:
    """The sound run; on the first `faulty` seeds also the controls and
    each fault that the cell's mix and sharding can have."""
    if n >= faulty:
        return ["sound"]
    out = ["sound", "tf32", "bf16", "unchanged", "half_batch",
           "no_exchange", "altered"]
    if spec.chips >= 4:
        out += ["moved_rank2", "rank3_kept"]
    if spec.mix["options"]["tnt"]["max_iterations"] > 0:
        out.append("no_tnt")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faulty", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from pgobench import cell, manifest
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = cell.CellSpec.load(manifest.benchmark(), args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    if spec.chips > 1:
        from pgobench import sharded
        if torch.cuda.device_count() < spec.chips:
            print(f"calibrate: {spec.name} needs {spec.chips} CUDA cards",
                  file=sys.stderr)
            return 2
        rows = sharded.calibrate(spec, seeds, args.seconds, args.faulty)
    else:
        device = torch.device("cuda", 0)
        rows = []
        for n, seed in enumerate(seeds):
            for row in readings(spec, seed, args.seconds,
                                variants_of(n, args.faulty, spec), device):
                print(json.dumps(row), flush=True)
                rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
