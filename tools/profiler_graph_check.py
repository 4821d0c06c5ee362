#!/usr/bin/env python3
"""torch.profiler sessions interleaved with CUDA-graph captures and
replays on one CUDA card, in the order chip_smoke.py once made them: a
profiled DChordal set-up, then new captured programs (DChordal's stages,
a solver's step), then profiled replays, for a number of cycles.

    python3 tools/profiler_graph_check.py [--keep-cupti] [--cycles N]

Between two sessions torch.profiler tears CUPTI down and sets it up again;
with CUDA graphs captured in between, that re-init can end the process
with a segmentation fault. --keep-cupti sets TEARDOWN_CUPTI=0 and
DISABLE_CUPTI_LAZY_REINIT=1 first, as chip_smoke.py does. Prints one line
per cycle and "ok" at the end; a fatal signal prints the stacks
(faulthandler) and the exit code is then the signal's. Runs
artifacts/grid3D_synth.g2o with 4 nodes in float32. Exits 2 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keep-cupti", action="store_true")
    ap.add_argument("--cycles", type=int, default=4)
    args = ap.parse_args()
    if args.keep_cupti:
        os.environ["TEARDOWN_CUPTI"] = "0"
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    faulthandler.enable()
    import torch
    if not torch.cuda.is_available():
        print("profiler_graph_check: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file

    dev = torch.device("cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    meas = read_g2o_file(os.path.join(ROOT, "artifacts", "grid3D_synth.g2o"))
    cfg = dchordal.DChordalConfig()
    t0 = time.perf_counter()
    # Captured programs made before the first session.
    s64 = dchordal._setup(meas, 4, cfg, torch.float64, dev)
    for kernels in (True, False):
        dchordal._run(s64, kernels, True, {})
    sol = DPGOSolver(meas, num_nodes=4, dtype=torch.float32, device=dev)
    sol.run_steps(sol.initialize(), 0, 20)
    kept = [sol]
    for c in range(args.cycles):
        with profile(activities=acts):
            s32 = dchordal._setup(meas, 4, cfg, torch.float32, dev)
            torch.cuda.synchronize()
        for kernels in (True, False):
            dchordal._run(s32, kernels, True, {})
        sol = DPGOSolver(meas, num_nodes=4, dtype=torch.float32, device=dev)
        st, k = sol.run_steps(sol.initialize(dist_init=True), 0, 30)
        kept.append(sol)
        for _ in range(4):
            with profile(activities=acts) as prof:
                sol.run_steps(st, k, 5)
                torch.cuda.synchronize()
            keys = len(prof.key_averages())
            other = DPGOSolver(meas, num_nodes=4, dtype=torch.float32,
                               device=dev)
            other.run_steps(other.initialize(), 0, 5)
        print(f"cycle {c}: {time.perf_counter() - t0:.1f} s, {keys} "
              "profiled names", flush=True)
    print("ok", "keep-cupti" if args.keep_cupti else "default")
    return 0


if __name__ == "__main__":
    sys.exit(main())
