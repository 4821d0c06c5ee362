#!/usr/bin/env python3
"""The sharded solver at world size 1 against the single-process solver on
rim_synth, on one CUDA card: what a spawned process, the process group's
backend, the torch thread count and the sharded code path each cost.

    python3 tools/sharded_world1.py

Builds dpgo_tpu_torch's kernels, then times AMM-PGO# (refined preset,
16 nodes, float32, from the centralized chordal start) for 150 steps with
history and twice without, in this process, then in one spawned process
each (`parallel.launch.spawn`, world size 1 on cuda:0): DPGOSolver under a
gloo and under an NCCL group, ShardedDPGOSolver over NCCL (default and
os.cpu_count() torch threads) and over gloo (halos staged through the
host), DPGOSolver with os.cpu_count() threads; last in this process again,
since the host's speed drifts over a call. One line per variant: it/s,
host syncs per step, torch threads, seconds from the spawn to the
function, build seconds. Prints the card's name and power limit first.
Exits 2 without a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STEPS = 150


def run(solver, init, label):
    import torch
    st = solver.initialize(*init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps_history(st, 0, STEPS)
    torch.cuda.synchronize()
    hist = STEPS / (time.perf_counter() - t0)
    res = []
    for _ in range(2):
        st = solver.initialize(*init)
        torch.cuda.synchronize()
        s0 = solver.syncs.count
        t0 = time.perf_counter()
        solver.run_steps(st, 0, STEPS)
        torch.cuda.synchronize()
        res.append(STEPS / (time.perf_counter() - t0))
    return (f"{label}: history {hist:.2f} it/s, warm {res[0]:.2f} / "
            f"{res[1]:.2f} it/s, syncs/step "
            f"{(solver.syncs.count - s0) / STEPS:.2f}, torch threads "
            f"{torch.get_num_threads()}")


def child(rank, world_size, device, meas, init, variant, t_spawn):
    import torch
    t_fn = time.time() - t_spawn
    import dpgo_tpu_torch  # noqa: F401  (sets true-f32 matmuls)
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    if variant.get("threads"):
        torch.set_num_threads(variant["threads"])
    cls = ShardedDPGOSolver if variant["sharded"] else DPGOSolver
    t0 = time.perf_counter()
    solver = cls(meas, 16, opts=MMOptions(accelerated=True),
                 dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    b = time.perf_counter() - t0
    line = run(solver, init, variant["name"])
    return line + f"; fn entered {t_fn:.1f} s after spawn, build {b:.1f} s"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import dpgo_tpu_torch  # noqa: F401  (sets true-f32 matmuls)
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.parallel.launch import spawn
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.solvers.mm import MMOptions
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print("os.cpu_count", os.cpu_count(), "affinity",
          len(os.sched_getaffinity(0)), "torch threads",
          torch.get_num_threads(), flush=True)
    _build.load(verbose=False)
    meas = read_g2o_file(os.path.join(ROOT, "artifacts/rim_synth.g2o"))
    R0 = chordal_initialization(meas)
    init = (recover_translations_global(meas, R0), R0)
    dev = torch.device("cuda", 0)
    solver = DPGOSolver(meas, 16, opts=MMOptions(accelerated=True),
                        dtype=torch.float32, device=dev)
    print(run(solver, init, "parent single"), flush=True)
    del solver
    torch.cuda.empty_cache()
    n = os.cpu_count()
    variants = [
        ("gloo", dict(name="child single (gloo group)", sharded=False)),
        ("nccl", dict(name="child single (nccl group)", sharded=False)),
        ("nccl", dict(name="child sharded nccl", sharded=True)),
        ("nccl", dict(name=f"child sharded nccl, {n} threads", sharded=True,
                      threads=n)),
        ("gloo", dict(name="child sharded gloo (staged)", sharded=True)),
        ("gloo", dict(name=f"child single (gloo group), {n} threads",
                      sharded=False, threads=n)),
    ]
    for backend, v in variants:
        t0 = time.time()
        out = spawn(child, 1, backend=backend, devices=["cuda:0"],
                    args=(meas, init, v, t0), timeout=120, deadline=300)
        print(out[0] + f"; spawn {time.time() - t0:.1f} s", flush=True)
    solver = DPGOSolver(meas, 16, opts=MMOptions(accelerated=True),
                        dtype=torch.float32, device=dev)
    print(run(solver, init, "parent single, again"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
