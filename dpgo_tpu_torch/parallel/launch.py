"""Process groups and rank placement for the sharded solvers (the
counterpart of the JAX package's `Mesh(jax.devices(), ("nodes",))` and of
its multi-process launch, tools/multihost_demo.py).

Two ways to get a group:

- `spawn(fn, world_size, backend, devices)` starts `world_size` processes
  (torch.multiprocessing, spawn start method), makes their group through a
  `file://` rendezvous in a fresh temporary directory (or the given
  `init_method`, e.g. `tcp://localhost:<port>`), calls
  `fn(rank, world_size, device, *args)` in each and returns the results in
  rank order. A collective that waits longer than `timeout` seconds raises
  in its process, and the whole run is given `deadline` seconds; a rank
  that fails or overruns fails the call with its traceback, and every
  process is stopped.
- `init_from_env(backend, device)` under torchrun (`RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), e.g.
  `torchrun --nproc-per-node 2 script.py` with `backend="gloo"`,
  `device="cpu"`.

Rank r's device (`rank_device`): `cpu` when the caller names the CPU;
otherwise a CUDA card, `cuda:{local rank}` under NCCL (which takes one rank
per card and raises when there are fewer cards than ranks) and
`cuda:{local rank mod cards}` under gloo, so several gloo ranks can share
one card. Nothing falls back: without a card a CUDA placement raises, and
the backend is the one the caller names.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_device(local_rank: int, backend: str, device=None) -> torch.device:
    """The device of the rank with this local rank (see the module
    docstring); `device` "cpu" (or a CPU device) puts every rank there."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the sharded solvers run on CUDA cards by default "
                           "and this host has none; pass device='cpu'")
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if local_rank >= cards:
            raise RuntimeError(f"NCCL takes one rank per card: local rank "
                               f"{local_rank} but {cards} card(s)")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % cards)


# What NCCL reads from the environment when a group's communicator is made.
# Without graph-mixing support NCCL records a captured collective as kernel
# (and copy) nodes only; with it (NCCL's default) it adds event-record and
# event-wait nodes, which a conditional node's body refuses: above world
# size 1 an all_reduce or all_gather inside an IF or WHILE body then fails
# its capture (NVIDIA H100s, NCCL 2.28.9, tools/nccl4_graph.py --probe),
# and AMM-PGO*'s master branches and the split polish's loops hold
# collectives there. The price: no uncaptured collective may follow a graph
# launch still outstanding, which the collectives wait out
# (ops/graph_nodes.settle). A value the caller's environment names is kept.
NCCL_ENV = {"NCCL_GRAPH_MIXING_SUPPORT": "0"}


def nccl_environment(backend: str) -> None:
    """NCCL_ENV into this process's environment for an NCCL group, where
    the environment names no value; nothing for other backends."""
    if backend == "nccl":
        for k, v in NCCL_ENV.items():
            os.environ.setdefault(k, v)


def _init_group(backend: str, rank: int, world_size: int, device,
                init_method: str, timeout: float) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    nccl_environment(backend)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def init_from_env(backend: str, device=None, timeout: float = 60.0):
    """Join the group torchrun describes in the environment; returns
    (rank, world_size, device)."""
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(local_rank, backend, device)
    _init_group(backend, rank, world_size, dev, "env://", timeout)
    return rank, world_size, dev


def _entry(fn, rank, world_size, backend, device, init_method, timeout,
           results, args):
    try:
        _init_group(backend, rank, world_size, device, init_method, timeout)
        try:
            out = fn(rank, world_size, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, backend: str = "nccl", devices=None,
          init_method: str | None = None, args: tuple = (),
          timeout: float = 60.0, deadline: float = 600.0) -> list:
    """Run `fn(rank, world_size, device, *args)` in `world_size` new
    processes joined in one process group; returns the results in rank
    order. `fn` and `args` must be picklable (`fn` a module-level function).

    `devices`: None places the ranks on CUDA cards (`rank_device`), "cpu"
    on the CPU, or a list gives each rank's device."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [rank_device(r, backend, devices)
                   for r in range(world_size)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_entry, daemon=True, args=(
            fn, r, world_size, backend, devices[r], init_method, timeout,
            results, tuple(args))) for r in range(world_size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        end = time.monotonic() + deadline
        try:
            # Drain the queue before joining (a writer blocks otherwise).
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, val = results.get(
                        timeout=max(end - time.monotonic(), 0.01))
                except queue_mod.Empty:
                    failure = (f"ranks {sorted(set(range(world_size)) - set(out))}"
                               f" gave no result within {deadline} s")
                    break
                if ok:
                    out[rank] = val
                else:
                    failure = f"rank {rank} failed:\n{val}"
            for p in procs:
                p.join(timeout=max(end - time.monotonic(), 5.0)
                       if failure is None else 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failure is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, "
                           f"world_size={world_size}, backend={backend}): "
                           f"{failure}")
    stuck = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if stuck:
        raise RuntimeError(f"ranks {stuck} exited with codes "
                           f"{[procs[r].exitcode for r in stuck]}")
    return [out[r] for r in range(world_size)]
