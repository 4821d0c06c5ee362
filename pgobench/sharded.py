"""A cell on several cards: one solver process per card, the node axis of
the configuration split over the ranks (`ShardedDPGOSolver`), the halos
exchanged by the configuration's strategy over its backend.

The parent (`run.py`) starts the ranks through `parallel.launch.spawn`
and prints the result line. Each rank runs `cell.measure` with its `Rank`
as the run's context:

- the same graph from the seed, its own nodes' problems, the start and
  the capture; a barrier closes the set-up, so `setup_s` ends when the
  last rank passes it;
- the settle and the window as on one card, every solve followed by its
  answer: the gathered estimate and the objective summed over the ranks.
  After each solve rank 0 decides whether the window has closed and tells
  the others through one broadcast on a gloo group of its own, on the
  host: the decision reaches neither the card's stream nor the program's
  collective counters;
- with `--trace 1` rank 0 alone is traced and reads the per-layer
  metrics, where the program's spans live; the others run the same solves
  untraced;
- rank 0 judges its answers against the reference once its state is
  freed, while the others wait at a last barrier.

The result line is the one-card line with `device.count` the number of
ranks and `memory_peak_bytes` the largest of their peaks.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys

from pgobench import calibrate as calibrate_mod
from pgobench import cell, faults

# A collective of the program that waits longer raises in its rank.
COLLECTIVE_TIMEOUT = 120.0
# A barrier or decision of the ranks on the host that waits longer raises:
# rank 0 traces, reads and judges while the others wait.
HOST_TIMEOUT = 300.0
# The whole group, from the spawn to the last result: a checkout's first
# run also builds the kernels (the ranks take turns at the build's lock).
DEADLINE = 1100.0
# Libraries that size a thread pool from the host's cores when they load.
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class Rank:
    """One rank's place in the run (cell.Solo for a rank of a process
    group): it builds the sharded solver, joins every answer's gather,
    keeps the answers and decides when a window closes where it leads
    (rank 0), and meets the others at barriers on the host."""

    def __init__(self, rank: int, halo: str):
        import torch.distributed as dist
        self.lead = rank == 0
        self.halo = halo
        self.host = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=HOST_TIMEOUT))

    def solver(self, meas, num_nodes: int, opts, dtype, device):
        from dpgo_tpu_torch.parallel.spmd import ShardedDPGOSolver
        return ShardedDPGOSolver(meas, num_nodes, opts, dtype=dtype,
                                 device=device, halo=self.halo)

    def answer(self, solver, st):
        """On every rank the gather of the own blocks and the sum of the
        node objectives over the ranks; on the lead their host copies."""
        import torch
        t, R = solver.gather_global(st)
        f = solver.comm.all_reduce(torch.sum(st.fobj).reshape(1))
        if not self.lead:
            return None
        return t.cpu().numpy(), R.cpu().numpy(), float(f)

    def agree(self, done: bool) -> bool:
        """The lead's `done` on every rank."""
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(done)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.host)
        return bool(flag)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.host)


def _run_rank(rank, world_size, device, spec, seed, seconds, trace, plant):
    from pgobench.run import forbidden_modules
    me = Rank(rank, spec.config["halo"])
    fault = None if plant is None else (
        lambda s: faults.apply(plant, s, seed))
    part = cell.measure(spec, seed, seconds, trace, device, plant=fault,
                        ctx=me)
    part["card"] = cell.card_name(device)
    part["forbidden"] = forbidden_modules()
    me.barrier()
    if me.lead:
        return part
    return {k: part[k] for k in ("set_up", "peak", "forbidden")}


def _calibrate_rank(rank, world_size, device, spec, seeds, seconds, faulty):
    me = Rank(rank, spec.config["halo"])
    rows = []
    for n, seed in enumerate(seeds):
        new = calibrate_mod.readings(
            spec, seed, seconds, calibrate_mod.variants_of(n, faulty, spec),
            device, ctx=me)
        for row in new:
            print(json.dumps(row), flush=True)
        rows += new
    me.barrier()
    return rows


@contextlib.contextmanager
def _threads_per_rank(world: int):
    """Each rank's share of this host's cores for the thread pools its
    libraries size when they load (a value the environment names is
    kept); the environment as it was afterwards."""
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    share = str(max(1, len(os.sched_getaffinity(0)) // world))
    for k in THREAD_VARS:
        os.environ.setdefault(k, share)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _spawn(fn, spec, args: tuple, backend=None, devices=None) -> list:
    from dpgo_tpu_torch.parallel.launch import spawn
    if spec.config["world_size"] != spec.chips:
        raise ValueError(f"{spec.name}: the configuration's world_size "
                         f"{spec.config['world_size']} is not the cell's "
                         f"{spec.chips} chips")
    with _threads_per_rank(spec.chips):
        return spawn(fn, spec.chips, backend or spec.config["backend"],
                     devices, args=args, timeout=COLLECTIVE_TIMEOUT,
                     deadline=DEADLINE)


def run(spec, seed: int, seconds: float, trace: bool, t_start: float,
        plant: str | None = None, backend: str | None = None,
        devices=None) -> dict:
    """One run of a cell over `spec.chips` ranks, one per card (or, for
    the tests, `backend` "gloo" with `devices` "cpu"): the result line's
    content, as cell.run gives it for one card. `plant` names a fault of
    faults.apply, planted in every rank after its set-up. Exits 3 where a
    rank loaded JAX or the JAX package."""
    parts = _spawn(_run_rank, spec, (spec, seed, seconds, trace, plant),
                   backend, devices)
    bad = sorted({m for p in parts for m in p["forbidden"]})
    if bad:
        print(f"pgobench: a rank loaded {bad}; no result", file=sys.stderr)
        raise SystemExit(3)
    part = parts[0]
    part["set_up"] = max(p["set_up"] for p in parts)
    part["peak"] = max(p["peak"] for p in parts)
    card = part["card"]
    out = cell.result(spec, part, trace, t_start, card,
                      "cpu" if card == "cpu" else "gpu")
    out["device"]["count"] = spec.chips
    return out


def calibrate(spec, seeds: list, seconds: float, faulty: int,
              backend: str | None = None, devices=None) -> list:
    """calibrate.readings for every seed in one group of ranks; the lead's
    rows, each printed as one JSON line as soon as its seed is done."""
    return _spawn(_calibrate_rank, spec, (spec, seeds, seconds, faulty),
                  backend, devices)[0]
