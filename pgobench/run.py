#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 pgobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (graph from the seed, problem build, start, warm-up and capture),
then the measured window of solves, then (with --trace 1) traced solves,
then the check of every answer against the plain float64 reference. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device and, last, check: each compared number beside its
limit, which also close standard error. Without a card, or with fewer
cards than the cell asks for, it prints no result and exits 2; if JAX or
the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# torch.profiler tears CUPTI down after a session and re-inits it at the
# next, which torch's source marks as crashing with CUDA graphs: keep it.
os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Whole top-level names: the port's name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "dpgo_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pgobench import cell, manifest
    spec = cell.CellSpec.load(manifest.benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pgobench: {args.workload} needs {spec.chips} CUDA card(s), "
              f"this machine has {n}; no result", file=sys.stderr)
        return 2
    if spec.chips > 1:
        from pgobench import sharded
        out = sharded.run(spec, args.seed, args.seconds, bool(args.trace),
                          T_START)
    else:
        out = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    print("pgobench: set-up parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.pop("spans").items()),
        file=sys.stderr)
    w = out.pop("window")
    ss = sorted(w["solve_s"])
    print(f"pgobench: {len(ss)} solves, seconds min {ss[0]:.4f} median "
          f"{ss[len(ss) // 2]:.4f} max {ss[-1]:.4f}; per step: " + ", ".join(
              f"{k} {v:.4f}" for k, v in w["counters_per_step"].items()
              if v), file=sys.stderr)
    print("pgobench: solve ms " + " ".join(
        f"{1e3 * x:.1f}" for x in w["solve_s"]), file=sys.stderr)
    if w["traced_solve_s"]:
        print("pgobench: traced solve ms " + " ".join(
            f"{1e3 * x:.1f}" for x in w["traced_solve_s"]), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"pgobench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
