"""The sharded solvers (dpgo_tpu_torch/parallel/) on the CPU with gloo, in
f64, against the JAX package's single-process solvers and the port's.

One process group of 2 ranks and one of 4 (module-scoped fixtures, one spawn
each) run every case of tests/torch_spmd_ranks.py on the 64-pose, d = 3,
40-loop-closure graph with 8 nodes of tests/test_spmd.py (d = 2: the same
generator); each case is a test of its own. Why the JAX package's sharded
Star deadlocks at psi = phi = 1e3 is pinned from its own quantities (see
test_jax_sharded_star_forced_fallbacks_deadlock)."""

import concurrent.futures
import dataclasses
import functools
import multiprocessing
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)
from tests.synthetic import random_pose_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_NODES = 8
WORLDS = (2, 4)
TORCHRUN_STEPS = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _jax_graph_truth(d):
    return random_pose_graph(np.random.default_rng(42), num_poses=64, d=d,
                             loop_closures=40)


def _jax_graph(d):
    return _jax_graph_truth(d)[0]


def _truth():
    """The d = 3 graph's true (t, R)."""
    return _jax_graph_truth(3)[1:]


def _graphs():
    return {"d3": _torch_meas(_jax_graph(3)), "d2": _torch_meas(_jax_graph(2)),
            "num_nodes": NUM_NODES}


# The JAX references, computed in a pool of processes while the ranks run
# (costliest first); the halo strategies share their JAX run.
JAX_CASES = ("acc_boundary", "star", "star_psi", "huber_dynamic",
             "plain_boundary", "segment", "d2", "polish", "polish_sharded",
             "aa")


def _jax_ref(name):
    """The JAX package's single-process solver on the case (in a pool
    process: CPU, float64): (2f history, 2|grad| history) or the polish's
    2f. "polish_sharded": the polish case through the JAX package's
    ShardedDPGOSolver on the 8 virtual CPU devices tests/conftest.py asks
    XLA for (the pool inherits the environment)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from dpgo_tpu import driver
    from dpgo_tpu.losses import Loss
    from dpgo_tpu.parallel.spmd import ShardedDPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions
    from dpgo_tpu.solvers.tnt import TNTParams

    sharded = name == "polish_sharded"
    c = ranks.case_setup("polish" if sharded else name)
    opts = dict(c["opts"])
    if "tnt" in opts:
        opts["tnt"] = TNTParams(**dataclasses.asdict(opts["tnt"]))
    cls = driver.DPGOStarSolver if c["cls"] == "star" else driver.DPGOSolver
    if sharded:
        assert len(jax.devices()) == 8, jax.devices()
        cls = ShardedDPGOSolver
    s = cls(_jax_graph(2 if c["graph"] == "d2" else 3), num_nodes=NUM_NODES,
            opts=MMOptions(**opts), loss=Loss(c["loss"]),
            loss_reg=ranks.LOSS_REG, dtype=jnp.float64, **c["kw"])
    st = s.initialize()
    if not c["steps"]:
        _, f2 = s.polish(st, **c["polish"])
        return float(f2)
    _, _, (f, g) = s.run_steps_history(st, jnp.zeros((), jnp.int32),
                                       c["steps"])
    return np.asarray(f), np.asarray(g)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Everything slow, started at once: both spawned worlds (`worlds`:
    {world size: future of the ranks' results}), the JAX references
    (`jax`: {case: future}) and the torchrun group (`torchrun`), with their
    output files in `logs`."""
    from dpgo_tpu_torch.io.g2o import write_g2o_file
    from dpgo_tpu_torch.parallel.launch import spawn

    threads = concurrent.futures.ThreadPoolExecutor(max_workers=len(WORLDS))
    jax_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    bg = types.SimpleNamespace(
        worlds={w: threads.submit(spawn, ranks.run_cases, w, backend="gloo",
                                  devices="cpu", args=(_graphs(),),
                                  timeout=60.0, deadline=300.0)
                for w in WORLDS},
        jax={name: jax_pool.submit(_jax_ref, name) for name in JAX_CASES},
        logs=tmp_path_factory.mktemp("spmd"))
    logs = bg.logs
    # torchrun with 2 ranks on the graph written as .g2o text.
    g2o = str(logs / "graph.g2o")
    write_g2o_file(g2o, *_truth(), _graphs()["d3"])
    with open(logs / "torchrun_out", "w") as out, \
            open(logs / "torchrun_err", "w") as err:
        bg.torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2",
             os.path.join(REPO, "tests", "torch_spmd_torchrun.py"), g2o,
             str(NUM_NODES), str(TORCHRUN_STEPS), str(logs / "torchrun")],
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
            cwd=REPO, stdout=out, stderr=err)
    try:
        yield bg
    finally:
        if bg.torchrun.poll() is None:
            bg.torchrun.kill()
        bg.torchrun.wait()
        threads.shutdown(wait=True)
        jax_pool.shutdown(wait=True, cancel_futures=True)
        for f in list(bg.worlds.values()) + list(bg.jax.values()):
            if not f.cancelled():
                f.exception()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, background):
    """The ranks' results of one world, on demand."""
    return lambda: background.worlds[request.param].result(timeout=360)


@pytest.fixture
def jax_ref(background):
    """The JAX reference of a case, on demand."""
    return lambda name: background.jax[name].result(timeout=360)


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's single-process solver on the case (rank results are held
    to its rows)."""
    torch.set_num_threads(1)
    solver, c = ranks.make_solver(name, _graphs(), "cpu", sharded=False)
    return ranks.drive(solver, c), solver.num_nodes


def _check_rows(world, name):
    """Every rank's own and halo rows equal the single-process solver's
    rows (rtol 1e-12), and every rank reports the same histories."""
    ref, N = _single(name)
    world = world()
    from dpgo_tpu_torch.parallel.spmd import take_nodes
    for r, out in enumerate(world):
        res = out[name]
        assert res["backend"] == "gloo"
        lo, hi = res["node_lo"], res["node_hi"]
        assert (lo, hi) == (r * N // len(world), (r + 1) * N // len(world))
        for key in ("t", "R", "th"):
            np.testing.assert_allclose(res[key],
                                       take_nodes(ref[key], lo, hi, N),
                                       rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(res["exact"], ref["exact"], rtol=1e-12)
        for key in ("f", "g", "polish_f", "exact"):
            if key in res:
                np.testing.assert_array_equal(res[key], world[0][name][key])
    return world[0][name], ref


@pytest.mark.parametrize("name", ranks.HASH_CASES)
def test_sharded_matches_jax_and_single(world, jax_ref, name):
    """AMM-PGO# and MM-PGO, each halo strategy: 2f at rtol 1e-9 and
    2|grad| at rtol 1e-6 / atol 1e-9 against JAX's DPGOSolver (as
    tests/test_spmd.py holds JAX's sharded solver), and rtol 1e-12 against
    the port's single-process solver."""
    jf, jg = jax_ref(name.split("_")[0] + "_boundary")  # no halo in JAX
    res, ref = _check_rows(world, name)
    np.testing.assert_allclose(res["f"], jf, rtol=1e-9)
    np.testing.assert_allclose(res["g"], jg, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res["f"], ref["f"], rtol=1e-12)
    np.testing.assert_allclose(res["g"], ref["g"], rtol=1e-12)
    # One exchange per step and at initialize, one history and one metrics
    # collective; the ring runs _ring_rounds rounds per exchange.
    exchanges = ranks.STEPS + 1
    per = 1 if not name.endswith("ring") else _rounds(len(world()))
    assert res["comm"][0] == exchanges * per + 2
    assert res["comm"][2] == 0  # no host copies on the CPU


@functools.lru_cache(maxsize=None)
def _rounds(world_size):
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.parallel.spmd import _ring_rounds
    _, _, mg = build_multigraph(_graphs()["d3"], NUM_NODES)
    return _ring_rounds(mg, world_size)


@pytest.mark.parametrize("name", ["huber_dynamic", "aa", "d2", "segment"])
def test_sharded_variants_match_jax_and_single(world, jax_ref, name):
    """Huber + dynamic rescale (10 steps), Anderson acceleration, d = 2 and
    the forced segment regime (STPCG capped at 10 iterations, as in
    tests/test_torch_segment.py): 2f at rtol 1e-9 against JAX, 2f and
    2|grad| at rtol 1e-12 against the port's single-process solver."""
    jf, _ = jax_ref(name)
    res, ref = _check_rows(world, name)
    np.testing.assert_allclose(res["f"], jf, rtol=1e-9)
    np.testing.assert_allclose(res["f"], ref["f"], rtol=1e-12)
    np.testing.assert_allclose(res["g"], ref["g"], rtol=1e-12)


@pytest.mark.parametrize("name", ["star", "star_psi"])
def test_sharded_star_matches_jax_and_single(world, jax_ref, name):
    """AMM-PGO* at the default psi and at psi = phi = 1e3, which forces
    master fallbacks: 2f at rtol 1e-9 against JAX's DPGOStarSolver and
    1e-12 against the port's; the fallback counts equal on every rank and
    to the single-process port's."""
    jf, _ = jax_ref(name)
    res, ref = _check_rows(world, name)
    np.testing.assert_allclose(res["f"], jf, rtol=1e-9)
    np.testing.assert_allclose(res["f"], ref["f"], rtol=1e-12)
    for out in world():
        assert out[name]["fallbacks"] == ref["fallbacks"]
    if name == "star_psi":
        assert sum(ref["fallbacks"].values()) > 0


def test_sharded_local_gauge_matches_single(world):
    """Local gauge centering on (halo_dc shifts the exchanged translations)
    with the ring exchange: the port's single-process solver's histories
    and rows (rtol 1e-12)."""
    res, ref = _check_rows(world, "gauge_ring")
    np.testing.assert_allclose(res["f"], ref["f"], rtol=1e-12)
    np.testing.assert_allclose(res["g"], ref["g"], rtol=1e-12)


def test_sharded_polish_matches_jax(world, jax_ref):
    """polish(outer=6, tcg=12, coarse=True) from the chordal start: 2f at
    rtol 1e-9 against JAX's local polish, 1e-12 against the port's."""
    jf = jax_ref("polish")
    res, ref = _check_rows(world, "polish")
    np.testing.assert_allclose(res["polish_f"], jf, rtol=1e-9)
    np.testing.assert_allclose(res["polish_f"], ref["polish_f"], rtol=1e-12)


def test_split_polish_matches_jax_sharded(world, jax_ref):
    """The pose axis split over 2 and 4 ranks against the JAX package's
    sharded polish (pose axis sharded over 8 virtual devices, GSPMD): 2f
    at rtol 1e-9, and at 1e-12 against the port's single-process polish."""
    jf = jax_ref("polish_sharded")
    res, ref = _check_rows(world, "polish")
    np.testing.assert_allclose(res["polish_f"], jf, rtol=1e-9)
    np.testing.assert_allclose(res["polish_f"], ref["polish_f"], rtol=1e-12)


def _polish_history_equal(world, name, ref):
    """Every rank's TNT history (f, Delta, inner iterations, rho,
    accepted) equals rank 0's exactly, and the single process's: the
    branches and CG counts exactly, f and Delta at rtol 1e-12 (rho, a
    ratio of differences of nearby objectives, is not compared)."""
    h0 = world[0][name]["polish_history"]
    for out in world:
        for k, v in out[name]["polish_history"].items():
            np.testing.assert_array_equal(v, h0[k], err_msg=k)
    hr = ref["polish_history"]
    for k in ("inner_iterations", "accepted"):
        np.testing.assert_array_equal(h0[k], hr[k], err_msg=k)
    for k in ("fx", "Delta"):
        np.testing.assert_allclose(h0[k], hr[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    return h0


@pytest.mark.parametrize("name", ranks.POLISH_CASES[1:])
def test_split_polish_variants_match_single(world, name):
    """The split polish with segment levels that straddle the ranks, in the
    forced segment regime (segment-Schwarz CG in the node-block
    preconditioner), with local gauge centering and the ring exchange,
    under Huber, and from turned rotations at a trust radius of 100, where
    TNT rejects steps: 2f at rtol 1e-12 against the port's single-process
    polish, every rank's TNT history equal."""
    res, ref = _check_rows(world, name)
    np.testing.assert_allclose(res["polish_f"], ref["polish_f"], rtol=1e-12)
    h = _polish_history_equal(world(), name, ref)
    if name == "polish_reject":
        assert 0 < int((~h["accepted"]).sum()) < len(h["accepted"]), h
        assert (h["rho"][~h["accepted"]] < 0.05).all()


def _predicted(counts, share, coarse_levels, d):
    """(exchanges, collectives) of a split polish up to its final
    all_gather, from its outer and CG iterations: setup (the coarse
    levels: one exchange for the point's gradient, one per chunk of 128
    basis directions, an all_reduce of the block sums and one of the
    Galerkin operator per level); the first evaluation (the objective's
    exchange and all_reduce, the gradient's exchange, the coarse
    restriction's all_reduce, one for the two norms); per outer iteration
    two all_reduces opening STPCG, one for the step's three scalars, the
    trial objective's exchange and all_reduce, and after the first a
    gradient exchange, a restriction and the norms; per CG iteration one
    exchange and 2 (+ 1 restriction) all_reduces. A ring exchange is
    `ring_rounds` collectives, the others one."""
    O, T = counts["outer"], counts["cg_iterations"]
    c = 1 if coarse_levels else 0
    K = 3 if d == 2 else 6
    chunks = sum(-(-n * K // 128) for n in coarse_levels)
    L = len(coarse_levels)
    E = c * (1 + chunks) + 2 + T + O + (O - 1)
    AR = 2 * L + 2 + c + 4 * O + T * (2 + c) + (O - 1) * (1 + c)
    X = share["ring_rounds"] if share["strategy"] == "ring" else 1
    return E, E * X + AR


@pytest.mark.parametrize("name", ranks.POLISH_CASES)
def test_split_polish_holds_its_share(world, name):
    """After a split polish a rank holds its nodes' problems only (no
    whole problem set) and the edges touching its poses (each inter-rank
    edge on both ranks), and it made exactly the exchanges and
    collectives the design predicts (`_predicted`): per CG iteration one
    halo exchange of the direction and 3 all_reduces of scalars (with
    the coarse level)."""
    meas = _graphs()["d3"]
    c = ranks.case_setup(name)
    segs = [m for m in c["polish"].get("coarse_segments", ())
            if m < meas.num_poses]
    levels = [NUM_NODES] + segs if c["polish"]["coarse"] else []
    w = world()
    for out in w:
        res = out[name]
        share, counts = res["share"], res["polish_counts"]
        lo, hi = share["range"]
        npd = res["node_hi"] - res["node_lo"]
        assert (lo, hi) == (res["node_lo"] * 8, res["node_hi"] * 8)
        assert share["prob_rows"] == [npd] and not share["full_probs"]
        touch = ((meas.i >= lo) & (meas.i < hi)) | ((meas.j >= lo)
                                                    & (meas.j < hi))
        assert share["edges"] == int(touch.sum())
        E, calls = _predicted(counts, share, levels, 3)
        assert counts["exchanges"] == E
        assert counts["collectives"] == calls
        assert counts["host_copies"] == 0
        assert counts == w[0][name]["polish_counts"]
    # The inter-rank edges are on both ranks that they touch.
    assert sum(out[name]["share"]["edges"] for out in w) > len(meas)


@pytest.mark.parametrize("case", ranks.ORACLE_CASES,
                         ids=lambda c: "-".join(c))
def test_split_oracles_match_global(world, case):
    """On every rank: the objective shares summed over the ranks, the
    rank's rows of the Euclidean gradient and of the Hessian-vector
    products (two directions in a batch; Huber's weight derivative
    included) equal the port's global evaluate_f /
    evaluate_euclidean_grad / euclidean_hess_vp at rtol 1e-12."""
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.objective import (EdgeData, evaluate_euclidean_grad,
                                          evaluate_f)
    from dpgo_tpu_torch.solvers.polish import euclidean_hess_vp

    gname, loss = case
    meas = _graphs()[gname]
    s, _ = ranks.make_solver("d2" if gname == "d2" else "acc_boundary",
                             _graphs(), "cpu", sharded=False)
    edges = EdgeData.from_measurements(meas, node_of=s.part.node_of,
                                       device="cpu")
    t, R, vt, vR = (torch.as_tensor(np.ascontiguousarray(x))
                    for x in ranks.oracle_point(meas))
    kw = dict(loss=Loss(loss), loss_reg=ranks.LOSS_REG)
    f = float(evaluate_f(edges, t, R, **kw))
    gt, gR = evaluate_euclidean_grad(edges, t, R, **kw)
    ht, hR = euclidean_hess_vp(edges, t, R, vt, vR, **kw)
    w = world()
    ranges = []
    for out in w:
        res = out["oracles"][case]
        lo, hi = res["range"]
        ranges.append((lo, hi))
        np.testing.assert_allclose(res["f"], f, rtol=1e-12)
        for key, ref in (("gt", gt[lo:hi]), ("gR", gR[lo:hi]),
                         ("ht", ht[:, lo:hi]), ("hR", hR[:, lo:hi])):
            np.testing.assert_allclose(res[key], ref.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=key)
    assert ranges[0][0] == 0 and ranges[-1][1] == meas.num_poses
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_sharded_run_steps_equals_stepping(world):
    assert all(out["run_steps"] for out in world())


def test_sharded_run_stops_where_rank0_asks(world):
    """run()'s callback asks to stop at iteration 4 on rank 0 and at 2 on
    the others: every rank stops at 4, with the single-process run's rows
    (rtol 1e-12)."""
    torch.set_num_threads(1)
    s, _ = ranks.make_solver("acc_boundary", _graphs(), "cpu",
                             sharded=False)
    _, ref = s.run(4, record_every=2)
    for out in world():
        hist = out["run_callback"]
        np.testing.assert_array_equal(hist[:, 0], [0, 2, 4])
        np.testing.assert_allclose(hist, ref, rtol=1e-12)


def test_sharded_node_and_refine_stats_are_the_rows(world):
    """node_stats and refine_stats of a rank are its rows of the
    single-process solver's."""
    from dpgo_tpu_torch.parallel.spmd import take_nodes
    ref, N = _single("acc_boundary")
    for out in world():
        res = out["acc_boundary"]
        lo, hi = res["node_lo"], res["node_hi"]
        for key in ("node_stats", "refine_stats"):
            for name, v in res[key].items():
                want = ref[key][name]
                for a, b in zip(v if isinstance(v, tuple) else (v,),
                                want if isinstance(want, tuple) else (want,)):
                    np.testing.assert_allclose(
                        a, take_nodes(b, lo, hi, N), rtol=1e-12, atol=1e-13,
                        err_msg=f"{key}[{name}]")


@pytest.mark.parametrize("regime", ["dense", "edgewise", "segment"])
def test_rank_problems_are_rows_of_the_whole_build(world, regime):
    """Each rank builds only its nodes; its problems (padded to the widths
    all ranks agree on) equal its rows of the whole build exactly, before
    and after with_weights."""
    for out in world():
        assert out["build_ranges"][regime] == []


def test_sharded_refusals(world):
    """ValueError for a node count the ranks do not divide and for an
    unknown halo strategy, on every rank."""
    for out in world():
        msgs = out["errors"]
        assert len(msgs) == 2
        assert "divisible" in msgs[0] and "halo" in msgs[1]


def test_halo_schedule_matches_jax():
    """build_halo_schedule and _ring_rounds give the JAX package's arrays
    (60 poses, 6 nodes), and the boundary halos equal the full-gather halos
    (tests/test_spmd.py::test_halo_schedule_compaction)."""
    from dpgo_tpu.graph import build_multigraph as jbuild
    from dpgo_tpu.parallel import spmd as jspmd

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.parallel import spmd

    meas, _, _ = random_pose_graph(np.random.default_rng(42), num_poses=60,
                                   d=3, loop_closures=30)
    _, _, jmg = jbuild(meas, 6)
    s = DPGOSolver(_torch_meas(meas), num_nodes=6, device="cpu")
    js, ts = jspmd.build_halo_schedule(jmg), spmd.build_halo_schedule(s.mg)
    assert ts.B == js.B and ts.B <= s.mg.n0_max
    np.testing.assert_array_equal(ts.bnd, js.bnd)
    np.testing.assert_array_equal(ts.halo_slot, js.halo_slot)
    assert ts.bnd.dtype == js.bnd.dtype == np.int32
    for D in (1, 2, 3, 6):
        assert spmd._ring_rounds(s.mg, D) == jspmd._ring_rounds(jmg, D)
    st = s.initialize()
    mg = s.mg
    th_full = st.Z.t[mg.halo_owner, mg.halo_lpose]
    tb = st.Z.t[np.arange(mg.num_nodes)[:, None], ts.bnd]
    th_c = tb[mg.halo_owner, ts.halo_slot]
    np.testing.assert_array_equal(th_full.numpy(), th_c.numpy())


def test_rim_schedule():
    """rim_synth at 16 nodes: the widest boundary set is 57 poses, and the
    ring needs 0, 1 and 3 rounds at 1, 2 and 4 ranks."""
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.parallel import spmd

    rim = read_g2o_file(os.path.join(REPO, "artifacts", "rim_synth.g2o"))
    _, _, mg = build_multigraph(rim, 16)
    sched = spmd.build_halo_schedule(mg)
    assert (mg.n0_max, mg.n1_max, sched.B) == (640, 82, 57)
    assert [spmd._ring_rounds(mg, D) for D in (1, 2, 4)] == [0, 1, 3]


def test_take_nodes_states():
    """take_nodes slices every per-node field of MMState and StarState and
    keeps the scalar master reference F."""
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.parallel.spmd import take_nodes

    meas = _graphs()["d3"]
    for cls in (DPGOSolver, DPGOStarSolver):
        s = cls(meas, num_nodes=NUM_NODES, device="cpu")
        st = s.initialize()
        part = take_nodes(st, 2, 6, NUM_NODES)
        for f in dataclasses.fields(st):
            a, b = getattr(st, f.name), getattr(part, f.name)
            if f.name == "F":
                assert b is a
            elif dataclasses.is_dataclass(a):
                assert torch.equal(b.t, a.t[2:6]) and torch.equal(b.Rh,
                                                                 a.Rh[2:6])
            else:
                assert torch.equal(b, a[2:6]), f.name


PSI_STEPS = 2


def _jax_star_shard_decisions():
    """The JAX package's AMM-PGO* (single process, float64) on the d = 3
    graph at psi = phi = 1e3, PSI_STEPS jitted steps. Per step and master
    test ("pm": the proximal candidate, "mm": the refined one): the
    decision each shard of its ShardedDPGOStarSolver on 8 devices (one node
    each) takes, `fobj > F - psi * sum over the shard's own nodes of the
    squared step` (dpgo_tpu/solvers/star.py:164-176, :179, :194, the sum
    inside shard_map), and the decision on the step summed over every
    node. The candidates and their global objectives are the two
    `global_f_fn` calls iterate_star makes at its top level (those inside
    the fallback branches are traced under lax.cond, another trace)."""
    import jax

    from dpgo_tpu.driver import DPGOStarSolver, communicate_star
    from dpgo_tpu.solvers import star as star_mod
    from dpgo_tpu.solvers.mm import MMOptions

    psi = 1e3
    s = DPGOStarSolver(_jax_graph(3), num_nodes=NUM_NODES,
                       opts=MMOptions(psi=psi, phi=psi), dtype=jnp.float64)

    @jax.jit
    def step(st, k):
        top = []

        def global_f(t, R):
            f = s._global_f(t, R)
            if f._trace is st.F._trace:
                top.append((t, R, f))
            return f

        st2 = star_mod.iterate_star(s.probs, st, s.opts, global_f, k)
        st2 = st2._replace(Z=communicate_star(st2.Z, s.halo_owner,
                                              s.halo_lpose, s.halo_dc))
        return star_mod.update_star(s.probs, st2, s.opts, first=False), top

    st = s.initialize()
    out = []
    for k in range(PSI_STEPS):
        nxt, top = step(st, jnp.asarray(k, jnp.int32))
        assert len(top) == 2, len(top)
        Zt, ZR, F = np.asarray(st.Z.t), np.asarray(st.Z.R), float(st.F)
        rec = {}
        for name, (t, R, f) in zip(("pm", "mm"), top):
            sq = (np.sum((np.asarray(t) - Zt) ** 2, axis=(1, 2))
                  + np.sum((np.asarray(R) - ZR) ** 2, axis=(1, 2, 3)))
            rec[name] = (float(f) > F - psi * sq,
                         bool(float(f) > F - psi * sq.sum()))
        out.append(rec)
        st = nxt
    return out


def test_jax_sharded_star_forced_fallbacks_deadlock():
    """The reference's sharded AMM-PGO* sums the psi-test's squared step
    over the local shard only (dpgo_tpu/solvers/star.py:164-176 inside
    shard_map), so at psi = phi = 1e3 the 8 shards of this graph take
    different decisions in the proximal test of the second step: the
    shards whose fallback fires enter its psum and wait for the others,
    and the reference deadlocks there. Pinned from the JAX package's own
    quantities (`_jax_star_shard_decisions`), not by running the deadlock:
    in step 1 every shard takes both tests' decision; in step 2 the
    proximal test splits the shards, and the refined test does not. The
    port sums the squared step over all ranks, so its ranks take the
    decision on the whole sum (test_sharded_star_matches_jax_and_single):
    the port's single-process solver fires the proximal fallback in both
    steps, as the whole sums say."""
    from dpgo_tpu_torch.driver import DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions

    dec = _jax_star_shard_decisions()
    for name in ("pm", "mm"):
        shards, whole = dec[0][name]
        assert shards.all() and whole, (name, shards)
    shards, whole = dec[1]["pm"]
    assert shards.any() and not shards.all() and whole, shards
    shards, whole = dec[1]["mm"]
    assert shards.all() and whole, shards

    s = DPGOStarSolver(_graphs()["d3"], num_nodes=NUM_NODES,
                       opts=MMOptions(psi=1e3, phi=1e3), device="cpu")
    s.run_steps(s.initialize(), 0, PSI_STEPS)
    assert s.fallbacks["pm"] == sum(d["pm"][1] for d in dec) == PSI_STEPS
    assert s.fallbacks["mm"] == sum(d["mm"][1] for d in dec)


def test_kernel_build_runs_once_under_several_ranks(tmp_path):
    """Four ranks enter ops/_build.build together (nvcc stubbed out): the
    file lock lets one compile and link; the others find the fresh
    library."""
    from dpgo_tpu_torch.parallel.launch import spawn

    log = str(tmp_path / "nvcc.log")
    paths = spawn(ranks.build_once, 4, backend="gloo", devices="cpu",
                  args=(str(tmp_path / "build"), log), deadline=120.0)
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    with open(log) as fh:
        calls = fh.read().splitlines()
    from dpgo_tpu_torch.ops import _build
    n_src = len([s for s in _build.sources() if s.endswith(".cu")])
    assert len(calls) == n_src + 1, calls  # one compile each, one link


def test_torchrun_ranks_join_from_the_environment(background):
    """torchrun --standalone --nproc-per-node 2: each rank joins through
    launch.init_from_env (RANK, WORLD_SIZE, LOCAL_RANK) with gloo on the
    CPU, and both print the single-process solver's 2f history of the graph
    read back from the .g2o text (rtol 1e-12)."""
    import json

    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file

    trun, logs = background.torchrun, background.logs
    trun.wait(timeout=240)
    assert trun.returncode == 0, (logs / "torchrun_err").read_text()
    recs = [json.loads((logs / f"torchrun.{r}.json").read_text())
            for r in range(2)]
    assert [r["rank"] for r in recs] == [0, 1]
    s = DPGOSolver(read_g2o_file(str(logs / "graph.g2o")), NUM_NODES,
                   device="cpu")
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, TORCHRUN_STEPS)
    for r in recs:
        assert (r["world_size"], r["backend"], r["device"]) == (2, "gloo",
                                                                "cpu")
        np.testing.assert_allclose(r["f2"], f.numpy(), rtol=1e-12)
