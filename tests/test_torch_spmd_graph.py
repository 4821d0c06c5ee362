"""The sharded step on the graph route's code, on the CPU with gloo in
float64 (the graph route itself runs over NCCL on a card; gloo keeps the
host-read route there).

One process group of 2 ranks and one of 4 (one spawn each) run
tests/torch_spmd_ranks.py::trace_cases on the 64-pose graph with 8 nodes of
tests/test_torch_spmd.py: AMM-PGO# with each halo strategy and AMM-PGO* at
psi = phi = 1e3 (every master fallback fires, their all_reduces inside the
branches), 12 steps, TNT cut to 4 outer and 30 CG iterations. The graph
route's run_steps_history runs with a step graph whose replay is the
"trace" route (every branch and trip run, merged: what the captured
step's conditional nodes compute), against the host-read route."""

import concurrent.futures
import dataclasses
import functools
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)
from tests.synthetic import random_pose_graph

NUM_NODES = 8
WORLDS = (2, 4)


@functools.lru_cache(maxsize=None)
def _jax_graph():
    meas, _, _ = random_pose_graph(np.random.default_rng(42), num_poses=64,
                                   d=3, loop_closures=40)
    return meas


def _graphs():
    from dpgo_tpu_torch.io.g2o import Measurements
    meas = _jax_graph()
    return {"d3": Measurements(**{f.name: getattr(meas, f.name)
                                  for f in dataclasses.fields(meas)}),
            "num_nodes": NUM_NODES}


def _jax_sharded_history():
    """The JAX package's ShardedDPGOSolver on acc_boundary's trace setup
    (its TNT caps), on the 8 virtual CPU devices tests/conftest.py asks
    XLA for (in a pool process, which inherits the environment): the
    (2f, 2|grad|) histories."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from dpgo_tpu.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.solvers.tnt import TNTParams

    c = ranks.trace_setup("acc_boundary")
    opts = dict(c["opts"])
    opts["tnt"] = TNTParams(**dataclasses.asdict(opts["tnt"]))
    assert len(jax.devices()) == 8, jax.devices()
    s = ShardedDPGOSolver(_jax_graph(), num_nodes=NUM_NODES,
                          opts=MMOptions(**opts), loss_reg=ranks.LOSS_REG,
                          halo="boundary", dtype=jnp.float64)
    _, _, (f, g) = s.run_steps_history(s.initialize(),
                                       jnp.zeros((), jnp.int32), ranks.STEPS)
    return np.asarray(f), np.asarray(g)


@pytest.fixture(scope="module")
def background():
    """Both spawned worlds and the JAX reference, started at once."""
    from dpgo_tpu_torch.parallel.launch import spawn

    threads = concurrent.futures.ThreadPoolExecutor(max_workers=len(WORLDS))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    worlds = {w: threads.submit(spawn, ranks.trace_cases, w, backend="gloo",
                                devices="cpu", args=(_graphs(),),
                                timeout=60.0, deadline=300.0)
              for w in WORLDS}
    jax_ref = pool.submit(_jax_sharded_history)
    try:
        yield worlds, jax_ref
    finally:
        threads.shutdown(wait=True)
        pool.shutdown(wait=True, cancel_futures=True)
        for f in list(worlds.values()) + [jax_ref]:
            if not f.cancelled():
                f.exception()


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def world(request, background):
    return background[0][request.param].result(timeout=360)


@functools.lru_cache(maxsize=None)
def _single(name):
    torch.set_num_threads(1)
    return ranks.single_trace_history(name, _graphs())


@pytest.mark.parametrize("name", ranks.TRACE_CASES)
def test_sharded_trace_route_equals_host_route(world, name):
    """On every rank: the final state, the (2f, 2|grad|) history, the
    device counters of the loops (TNT outer loop, STPCG, segment CG), of
    the collectives (calls, bytes, host copies) and of the master
    fallbacks equal on both routes; no flag read on the host on the graph
    route's code; the histories equal on every rank and to the port's
    single-process solver (rtol 1e-12): summed over the ranks once per
    call, after the replays."""
    sf, sg = _single(name)
    for out in world:
        res = out[name]
        assert res["states_equal"]
        np.testing.assert_array_equal(res["trace_f"], res["f"])
        np.testing.assert_array_equal(res["trace_g"], res["g"])
        assert res["trace"] == res["host"]
        assert res["trace_syncs"] == 0
        np.testing.assert_array_equal(res["f"], world[0][name]["f"])
        np.testing.assert_allclose(res["trace_f"], sf, rtol=1e-12)
        np.testing.assert_allclose(res["trace_g"], sg, rtol=1e-12)
        for loop in ranks.LOOPS:
            assert res["host"][loop] == res["notes"].get(loop, [0, 0])
        assert res["host"]["tnt"][0] > 0
    if name == "star_psi":
        assert all(v > 0 for v in world[0][name]["host"]["fallbacks"]
                   .values())


@pytest.mark.parametrize("name", ranks.TRACE_CASES)
def test_collective_device_counts_equal_python_counts(world, name):
    """The collectives' device counters (bumped inside each collective, so
    that a captured step counts at every replay) equal the host route's
    Python totals: calls, bytes and host copies (none on the CPU). On
    AMM-PGO# a step is one exchange (ring_rounds collectives with the
    ring), and the history one all_reduce."""
    for out in world:
        res = out[name]
        calls, nbytes, copies = res["python"]
        host = res["host"]
        assert (host["collectives"], host["collective_bytes"],
                host["collective_host_copies"]) == (calls, nbytes, copies)
        assert copies == 0
        if name.startswith("acc"):
            per = res["ring_rounds"] if name.endswith("ring") else 1
            assert calls == ranks.STEPS * per + 1


def test_sharded_trace_route_matches_jax_sharded(background):
    """acc_boundary's graph-route history on the trace route at 2 and 4
    ranks against the JAX package's ShardedDPGOSolver on 8 virtual
    devices: 2f at rtol 1e-9, 2|grad| at rtol 1e-6 / atol 1e-9 (as
    tests/test_torch_spmd.py holds the host route)."""
    worlds, jax_ref = background
    jf, jg = jax_ref.result(timeout=360)
    for w in WORLDS:
        for out in worlds[w].result(timeout=360):
            res = out["acc_boundary"]
            np.testing.assert_allclose(res["trace_f"], jf, rtol=1e-9)
            np.testing.assert_allclose(res["trace_g"], jg, rtol=1e-6,
                                       atol=1e-9)


def test_graph_key_sees_the_halo_strategy(world):
    """A copy of a solver with another halo strategy shares its graph slot
    (copy.copy, as chip_smoke.py's sharded phase makes one solver per
    strategy) but not its captured step: `_graph_key` holds the strategy
    and the ring's round count, so the copy captures anew."""
    for out in world:
        keys = out["graph_key"]
        assert keys == {"same": True, "other": False, "recaptured": True}


def test_nccl_groups_run_without_graph_mixing(monkeypatch):
    """parallel/launch.py makes NCCL groups with
    NCCL_GRAPH_MIXING_SUPPORT=0 (with NCCL's default a collective inside a
    conditional body fails its capture above world size 1), where the
    environment names no value; a value it names is kept, and another
    backend's group is left as it is."""
    import os

    from dpgo_tpu_torch.parallel import launch

    key = "NCCL_GRAPH_MIXING_SUPPORT"
    monkeypatch.delenv(key, raising=False)
    launch.nccl_environment("gloo")
    assert key not in os.environ
    launch.nccl_environment("nccl")
    assert os.environ[key] == "0"
    monkeypatch.setenv(key, "1")
    launch.nccl_environment("nccl")
    assert os.environ[key] == "1"
