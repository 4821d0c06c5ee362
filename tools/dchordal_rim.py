#!/usr/bin/env python3
"""DChordal on rim_synth on one CUDA card: the quality of the start against
the centralized chordal initialization, by working type and stage length.

    python3 tools/dchordal_rim.py [--routes | --mm-spread N]

Runs dpgo_tpu_torch's distributed_chordal_init on artifacts/rim_synth.g2o
with 16 nodes in float32 and float64, each with kernel K2 and with its plain
version, at the reference's stage lengths and at 4x them (float64), and
prints per run: 2f of the start (exact oracle, float64), its ratio to the
centralized chordal 2f, the largest |R^T R - I| and the wall seconds,
beside the card's name and power limit.

With --routes it instead runs chip_smoke.py's DChordal comparison of the
mm_dchordal path: one set-up per type (float64, then float32 profiled),
the stages on the graph route (one captured program) with K2 and plain
and on the host-read route, each printed with its seconds, host syncs,
launches and loop trips.

With --mm-spread N it instead repeats N times the mm_dchordal path of
chip_smoke.py (a float32 MM-PGO solver, its own float32 DChordal start,
150 steps through the kernels and through their plain versions) and, for
comparison, the same from the float64 DChordal start, and prints each
final 2f and the kernel-vs-plain relative difference. Exits 2 without a
CUDA card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dchordal_rim: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dpgo_tpu_torch.chordal import DChordalConfig, distributed_chordal_init
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.objective import EdgeData, evaluate_f
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    meas = read_g2o_file(os.path.join(ROOT, "artifacts", "rim_synth.g2o"))
    edges = EdgeData.from_measurements(meas, device=dev)

    def f2(t, R):
        def f(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=dev)
        return 2.0 * float(evaluate_f(edges, f(t), f(R)))

    R0 = chordal_initialization(meas)
    f_c = f2(recover_translations_global(meas, R0), R0)
    print(f"centralized chordal 2f {f_c:.6f}")
    if "--routes" in sys.argv:
        import chip_smoke
        runs = (("graph", True, True), ("graph_plain", False, True),
                ("host", True, False))
        for dtype in (torch.float64, torch.float32):
            chip_smoke.dchordal_routes(meas, dtype, dev, card, runs, f2,
                                       profile=dtype == torch.float32)
        return 0
    if "--mm-spread" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--mm-spread") + 1])
        mm_spread(meas, dev, card, reps)
        return 0
    base = DChordalConfig()
    long = dataclasses.replace(
        base, iters_reduced_R=4 * base.iters_reduced_R,
        iters_full_R=4 * base.iters_full_R,
        iters_reduced_t=4 * base.iters_reduced_t,
        iters_full_t=4 * base.iters_full_t)
    runs = [("float32", torch.float32, True, base),
            ("float32", torch.float32, False, base),
            ("float64", torch.float64, True, base),
            ("float64", torch.float64, False, base),
            ("float64, 4x stages", torch.float64, True, long)]
    for label, dtype, kernels, cfg in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t, R = distributed_chordal_init(meas, 16, cfg=cfg, dtype=dtype,
                                        device=dev, kernels=kernels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        R64 = R.astype(np.float64)
        orth = float(np.abs(np.einsum("nki,nkj->nij", R64, R64)
                            - np.eye(3)).max())
        f = f2(t, R)
        print(f"DChordal {label}, {'K2' if kernels else 'plain'} [{card}]: "
              f"2f {f:.6f}, {f / f_c:.4f} x chordal, max |R^T R - I| "
              f"{orth:.2e}, {secs:.2f} s")
    return 0


def mm_spread(meas, dev, card, reps: int):
    """The mm_dchordal path's kernel-vs-plain final 2f gap, `reps` times from
    fresh float32 DChordal starts, and from the float64 start."""
    import torch

    from dpgo_tpu_torch.chordal import distributed_chordal_init
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    s = DPGOSolver(meas, num_nodes=16, opts=MMOptions(accelerated=False),
                   dtype=torch.float32, device=dev)
    plain = dataclasses.replace(s.probs, kernels=False)
    kern = s.probs

    def final_2f(probs, init):
        s.probs = probs
        st, _, (f, _) = s.run_steps_history(s.initialize(*init), 0, 150)
        return float(f[-1])

    starts = [(f"float32 start {r}", torch.float32) for r in range(reps)]
    starts.append(("float64 start", torch.float64))
    for label, dtype in starts:
        t, R = distributed_chordal_init(meas, 16, dtype=dtype, device=dev)
        fk = final_2f(kern, (t, R))
        fp = final_2f(plain, (t, R))
        print(f"mm_dchordal {label} [{card}]: 2f at 150 with kernels "
              f"{fk:.6f}, plain {fp:.6f}, relative difference "
              f"{abs(fk - fp) / abs(fp):.3e}")


if __name__ == "__main__":
    sys.exit(main())
