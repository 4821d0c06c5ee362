"""The split polish on the graph route's code, on the CPU with gloo in
float64 (the graph route itself runs over NCCL on a card at every world
size: the TNT captured whole, its halo exchanges and all_reduces inside
the WHILE bodies; gloo keeps the host-read route there).

One process group of 2 ranks and one of 4 (one spawn each) run
tests/torch_spmd_ranks.py::polish_trace_cases on the 64-pose graph with 8
nodes of tests/test_torch_spmd.py: every polish case (the default, segment
levels straddling the ranks, the forced segment regime, local gauge + ring,
Huber, a perturbed start where TNT rejects steps), polish(outer=6, tcg=12,
coarse=True), on the host-read route and with graph_nodes.run_once on the
"trace" route (every branch and loop trip run, merged: what the captured
program's conditional nodes compute)."""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)
from tests.synthetic import random_pose_graph

NUM_NODES = 8
WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _graphs():
    from dpgo_tpu_torch.io.g2o import Measurements

    def meas(d):
        m, _, _ = random_pose_graph(np.random.default_rng(42), num_poses=64,
                                    d=d, loop_closures=40)
        return Measurements(**{f.name: getattr(m, f.name)
                               for f in dataclasses.fields(m)})

    return {"d3": meas(3), "d2": meas(2), "num_nodes": NUM_NODES}


@pytest.fixture(scope="module")
def background():
    """Both spawned worlds, started at once."""
    from dpgo_tpu_torch.parallel.launch import spawn

    threads = concurrent.futures.ThreadPoolExecutor(max_workers=len(WORLDS))
    worlds = {w: threads.submit(spawn, ranks.polish_trace_cases, w,
                                backend="gloo", devices="cpu",
                                args=(_graphs(),), timeout=60.0,
                                deadline=300.0)
              for w in WORLDS}
    try:
        yield worlds
    finally:
        threads.shutdown(wait=True)
        for f in worlds.values():
            f.exception()


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def world(request, background):
    return background[request.param].result(timeout=360)


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's single-process polish of the case (host route): its
    drive() result."""
    torch.set_num_threads(1)
    solver, c = ranks.make_solver(name, _graphs(), "cpu", sharded=False)
    return ranks.drive(solver, c)


COUNTS = ("exchanges", "collectives", "bytes", "host_copies", "outer",
          "cg_iterations")


@pytest.mark.parametrize("name", ranks.POLISH_CASES)
def test_split_polish_trace_route_equals_host_route(world, name):
    """On every rank the graph route's split polish (trace route in place
    of the capture) equals the host-read route bit for bit: 2f, the own
    rows, halos and TNT history after the polish, and the device counts of
    its exchanges, collectives, bytes and host copies; it reads no flag on
    the host (the host route reads one per loop trip)."""
    for out in world:
        host, trace = out[name]["host"], out[name]["trace"]
        hc, tc = host["polish_counts"], trace["polish_counts"]
        assert (hc["route"], tc["route"]) == ("host", "graph")
        assert trace["polish_f"] == host["polish_f"]
        for k in ("t", "R", "th"):
            np.testing.assert_array_equal(trace[k], host[k], err_msg=k)
        for k, v in host["polish_history"].items():
            np.testing.assert_array_equal(trace["polish_history"][k], v,
                                          err_msg=k)
        for k in COUNTS:
            assert tc[k] == hc[k], k
        assert hc["cg_iterations"] > hc["outer"]
        assert trace["host_syncs"] == 0 < host["host_syncs"]
        assert trace["polish_f"] == world[0][name]["trace"]["polish_f"]


@pytest.mark.parametrize("name", ranks.POLISH_CASES)
def test_split_polish_trace_route_matches_single(world, name):
    """The graph route's split polish at 2 and 4 ranks against the port's
    single-process polish: 2f and every rank's rows (its nodes of the
    single solver's state, via take_nodes) within 1e-12, and the exchanges
    per CG iteration those of the design: one per CG iteration plus the
    set-up's and the outer iterations' (tests/test_torch_spmd.py's
    `_predicted`, held on the host route there)."""
    from dpgo_tpu_torch.parallel.spmd import take_nodes

    ref = _single(name)
    np.testing.assert_allclose(world[0][name]["trace"]["polish_f"],
                               ref["polish_f"], rtol=1e-12)
    for out in world:
        trace = out[name]["trace"]
        lo, hi = trace["node_lo"], trace["node_hi"]
        for k in ("t", "R"):
            np.testing.assert_allclose(
                trace[k], take_nodes(ref[k], lo, hi, NUM_NODES), rtol=0,
                atol=1e-12 * max(1.0, np.abs(ref[k]).max()), err_msg=k)
        c = trace["polish_counts"]
        assert c["cg_iterations"] < c["exchanges"] \
            <= c["cg_iterations"] + 2 * c["outer"] + 8


def test_split_polish_takes_the_graph_route_at_every_world_size(world):
    """Over NCCL the split polish and AMM-PGO* take the graph route at
    every world size, their collectives inside conditional bodies: NCCL
    captures them there above world size 1 without its graph-mixing
    support, which parallel/launch.py turns off for NCCL groups (unless
    the environment names a value). At 2 and 4 ranks with the graph route
    asked for, every case's split polish runs on it."""
    from dpgo_tpu_torch.parallel import launch, spmd
    for out in world:
        for name in ranks.POLISH_CASES:
            assert out[name]["trace"]["polish_counts"]["route"] == "graph"
    assert launch.NCCL_ENV == {"NCCL_GRAPH_MIXING_SUPPORT": "0"}
    assert not hasattr(spmd.ShardedDPGOStarSolver,
                       "_bodies_capture_collectives")
