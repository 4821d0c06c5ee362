"""Faults planted under the timed path, and the lower-precision control:
what the check has to find (`calibrate.py` on the card, `tests/` on the
CPU). Each `plant_*` takes the run's Setup after the set-up; the harness
then captures the step again, so a fault inside the step is recorded into
the replayed graph. Nothing here edits the program: the planted methods
are instance attributes of the one solver."""

from __future__ import annotations

import numpy as np


def plant_unchanged(s) -> None:
    """A solve that returns its state unchanged."""
    s.solver.run_steps = lambda st, k0, n: (st, k0 + n)


def plant_half_batch(s) -> None:
    """Half of the batch left out: every step keeps the second half of the
    nodes' own poses (and their objectives) as they were."""
    import torch

    solver = s.solver
    advance = solver._advance

    def half(probs, st, k):
        nxt, probs2 = advance(probs, st, k)
        h = nxt.Z.t.shape[0] // 2
        Z = nxt.Z.with_own(torch.cat([nxt.Z.t[:h], st.Z.t[h:]]),
                           torch.cat([nxt.Z.R[:h], st.Z.R[h:]]))
        return nxt.replace(Z=Z, fobj=torch.cat([nxt.fobj[:h],
                                                st.fobj[h:]])), probs2

    solver._advance = half
    solver._graph = None


def plant_no_exchange(s) -> None:
    """The exchange left out: no node's halo is refreshed from its
    owners."""
    s.solver._exchange_halos = lambda Z: Z
    s.solver._graph = None


def plant_altered(s, seed: int = 0) -> None:
    """An answer altered where it is produced: the gathered estimate of one
    pose (drawn from the seed) moved by 1 m."""
    solver = s.solver
    gather = solver.gather_global
    pose = int(np.random.default_rng(seed).integers(solver.meas.num_poses))

    def altered(st):
        t, R = gather(st)
        t = t.clone()
        t[pose] += 1.0
        return t, R

    solver.gather_global = altered


def plant_moved_on_rank(s, seed: int = 0, on: int = 2) -> None:
    """A sharded solver's answer altered where one rank produces it: on
    rank `on`, one of its own poses (drawn from the seed) moved by 1 m in
    the state its share of the gather reads. The lead's answer holds the
    move only where the gather brings in the other ranks' poses."""
    solver = s.solver
    if solver.comm.rank != on:
        return
    gather = solver.gather_global
    rng = np.random.default_rng(seed)
    node = int(rng.integers(solver.nodes_per_rank))
    pose = int(rng.integers(solver.mg.n0[solver.node_lo + node]))

    def moved(st):
        t = st.Z.t.clone()
        t[node, pose] += 1.0
        return gather(st.replace(Z=st.Z.with_own(t, st.Z.R)))

    solver.gather_global = moved


def plant_rank_kept(s, on: int = 3) -> None:
    """A sharded solver's rank `on` left out: every step there keeps its
    nodes' own poses and objectives as they were. The step, its exchange
    included, still runs, so the other ranks' collectives are met; every
    rank captures its step again, so that the capture's warm-up step
    meets the others' collectives too."""
    solver = s.solver
    solver._graph = None
    if solver.comm.rank != on:
        return
    advance = solver._advance

    def kept(probs, st, k):
        nxt, probs2 = advance(probs, st, k)
        return nxt.replace(Z=nxt.Z.with_own(st.Z.t, st.Z.R),
                           fobj=st.fobj), probs2

    solver._advance = kept


def plant_no_tnt(s) -> None:
    """The refinement left out: every step's TNT runs no iteration, so the
    step is the proximal one alone (and K1 never launches)."""
    import dataclasses

    opts = s.solver.opts
    s.solver.opts = dataclasses.replace(
        opts, tnt=dataclasses.replace(opts.tnt, max_iterations=0))
    s.solver._graph = None


def plant_tf32(s) -> None:
    """The control: the program with TF32 matrix products switched on, the
    precision below the float32 that the configuration states."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    s.solver._graph = None


def plant_bf16(s) -> None:
    """The control where the products reach no TF32 unit (the segment
    path's batched 3 x 3 products): the program computing on operators held
    to bfloat16, every floating tensor of the node problems rounded to it
    (kept in the stated type)."""
    import dataclasses

    import torch

    probs = s.solver.probs
    low = {f.name: getattr(probs, f.name).to(torch.bfloat16).to(
        getattr(probs, f.name).dtype) for f in dataclasses.fields(probs)
        if isinstance(getattr(probs, f.name), torch.Tensor)
        and getattr(probs, f.name).is_floating_point()}
    s.solver.probs = dataclasses.replace(probs, **low)
    s.solver._reweighted = (None, s.solver.probs)
    s.solver._graph = None


CONTROLS = {"tf32": plant_tf32, "bf16": plant_bf16}
# A fault that only a mix with the TNT refinement can have.
REFINEMENT = {"no_tnt": plant_no_tnt}
PLANTS = {"unchanged": plant_unchanged, "half_batch": plant_half_batch,
          "no_exchange": plant_no_exchange, "altered": plant_altered}
# Faults that only a solver sharded over four ranks or more can have.
SHARDED = {"moved_rank2": plant_moved_on_rank, "rank3_kept": plant_rank_kept}
# Plants that draw from the run's seed.
SEEDED = ("altered", "moved_rank2")


def apply(name: str, s, seed: int) -> None:
    """The plant or control `name` (PLANTS, SHARDED, CONTROLS,
    REFINEMENT) on the run's Setup."""
    plant = {**PLANTS, **SHARDED, **CONTROLS, **REFINEMENT}[name]
    if name in SEEDED:
        plant(s, seed)
    else:
        plant(s)
