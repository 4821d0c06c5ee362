"""dpgo_tpu_torch's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor dpgo_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.cuda
def test_polar_so3_kernel_matches_plain(dev, rng):
    """K2 within 1e-5 of its plain version (f32) on matrices with separated
    singular values, every fifth with det < 0, and a zero matrix."""
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches, polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3

    U = polar_so3(torch.tensor(rng.normal(size=(999, 3, 3))))
    V = polar_so3(torch.tensor(rng.normal(size=(999, 3, 3))))
    sigma = torch.tensor([1.0, 2.0, 3.5]) + 0.5 * torch.rand(999, 3)
    A = U @ (sigma[:, :, None] * V.transpose(-1, -2))
    A[::5] *= -1
    A[7] = 0.0
    A = A.float().to(dev)
    before = Launches.count
    R = polar_so3_cuda(A)
    assert Launches.count == before + 1
    np.testing.assert_allclose(R.cpu().numpy(), polar_so3(A).cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(R[7].cpu().numpy(), np.eye(3), atol=0)


def _random_stpcg_case(dev, rng, d, n, N=3, cluster=None):
    """K1 against its plain version on a random SPD problem of N nodes with
    n poses of size d (node 1 inactive), at the given cluster size (None:
    the wrapper's choice): the same k per node, h within rtol 2e-4 / atol
    2e-5, Hh within rtol 2e-3 / atol 2e-4, |h|_M within rtol 1e-4; the
    inactive node gives a zero step with k = 0."""
    from dpgo_tpu_torch.manifold import project_sod
    from dpgo_tpu_torch.ops import stpcg_cuda
    from dpgo_tpu_torch.ops.stpcg import _proj_tall, stpcg_fused_reference
    from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused

    nd = d * n
    M = rng.normal(size=(N, nd, nd)) / np.sqrt(nd)
    H = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(nd)
    P = np.linalg.inv(H + 0.5 * np.eye(nd))
    Q = project_sod(torch.tensor(rng.normal(size=(N * n, d, d))))
    Q = Q.reshape(N, nd, d)
    S = rng.normal(size=(N, n, d, d)) * 0.01
    S = (S + S.transpose(0, 1, 3, 2)).reshape(N, nd, d)

    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev) \
            .contiguous()

    Ht, Pt, Qt, St = f(H), f(P), f(Q), f(S)
    g = _proj_tall(Qt, f(rng.normal(size=(N, nd, d)))).contiguous()
    v0 = _proj_tall(Qt, Pt @ g).contiguous()
    kw = dict(max_iters=250, kappa_fgr=0.05, theta=0.9)
    act = torch.ones(N, dtype=torch.bool, device=dev)
    act[1] = False
    for Delta in (100.0, 0.02):
        Dl = torch.full((N,), Delta, device=dev)
        before = stpcg_cuda.Launches.by_d[d]
        h, Hh, nrm, k = stpcg_fused(Ht, Pt, g, v0, Qt, St, Dl, act,
                                    cluster=cluster, **kw)
        assert stpcg_cuda.Launches.by_d[d] == before + 1
        hr, Hhr, nrmr, kr = stpcg_fused_reference(Ht, Pt, g, v0, Qt, St, Dl,
                                                  act, **kw)
        assert torch.equal(k.cpu(), kr.cpu())
        assert int(k[1]) == 0 and float(h[1].abs().max()) == 0.0
        np.testing.assert_allclose(h.cpu().numpy(), hr.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(Hh.cpu().numpy(), Hhr.cpu().numpy(),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(nrm.cpu().numpy(), nrmr.cpu().numpy(),
                                   rtol=1e-4)


@pytest.mark.cuda
def test_stpcg_kernel_matches_plain(dev, rng):
    """K1 at D = 3 against its plain version (f32) on a random SPD
    problem (see _random_stpcg_case), at the wrapper's cluster size."""
    _random_stpcg_case(dev, rng, 3, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [625, 100])
def test_stpcg_kernel_d2_matches_plain(dev, rng, n):
    """K1 at D = 2 against its plain version (f32): nd = 1250, the
    Manhattan-world node block, whose rows are only 8-byte aligned, and
    nd = 200, a multiple of 4 (16-byte loads)."""
    _random_stpcg_case(dev, rng, 2, n)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(3, 50), (3, 13), (2, 625), (2, 11)])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_stpcg_kernel_each_cluster_size(dev, rng, d, n, cluster):
    """K1 at every cluster size against its plain version, at D = 3 and
    D = 2, with pose counts that are multiples of neither C nor 4 (50, 13,
    625, 11), so the CTAs own unequal pose ranges; node 1 is inactive."""
    _random_stpcg_case(dev, rng, d, n, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 8])
def test_stpcg_kernel_more_nodes_than_resident(dev, rng, cluster):
    """Eight nodes more than the card holds clusters at once, at the
    wrapper's choice (then C = 1) and in clusters of 8: the clusters run in
    waves and match the plain version."""
    from dpgo_tpu_torch.ops.stpcg_cuda import (choose_cluster_size,
                                               resident_clusters)

    resident = resident_clusters(3, 3 * 20, dev)
    N = resident[cluster or 1] + 8
    if cluster is None:
        assert choose_cluster_size(N, 20, resident) == 1
    _random_stpcg_case(dev, rng, 3, 20, N=N, cluster=cluster)


@pytest.mark.cuda
def test_stpcg_cluster_choice_on_the_card(dev):
    """At the rim slice's shape (16 nodes, nd = 1920, D = 3) the card holds
    clusters of every size, and the wrapper picks the largest with which
    all 16 are resident."""
    from dpgo_tpu_torch.ops.stpcg_cuda import (CLUSTER_SIZES,
                                               choose_cluster_size,
                                               resident_clusters)

    resident = resident_clusters(3, 1920, dev)
    assert all(resident[C] > 0 for C in CLUSTER_SIZES), resident
    C = choose_cluster_size(16, 640, resident)
    assert resident[C] >= 16
    assert all(resident[c] < 16 for c in CLUSTER_SIZES if c > C)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 10241])
def test_polar_so3_kernel_ragged_counts(dev, rng, n):
    """K2 at counts that are not multiples of its 64-matrix block (and one
    that is) within 1e-5 of its plain version, on matrices with separated
    singular values, every fifth with det < 0; the kernel writes nothing
    past the n-th matrix of its output."""
    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3
    from dpgo_tpu_torch.synthetic import random_rotations

    sigma = np.array([1.0, 2.0, 3.5]) + rng.uniform(0, 0.5, size=(n, 3))
    A = random_rotations(rng, n) @ (
        sigma[:, :, None] * random_rotations(rng, n).transpose(0, 2, 1))
    A[::5] *= -1.0
    At = torch.tensor(A, dtype=torch.float32, device=dev)
    R = polar_so3_cuda(At)
    np.testing.assert_allclose(R.cpu().numpy(), polar_so3(At).cpu().numpy(),
                               atol=1e-5)
    buf = torch.full((n + 1, 3, 3), 7.0, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.load().dpgo_polar_so3(At.data_ptr(), buf.data_ptr(),
                                              n, stream), "polar_so3")
    assert torch.equal(buf[:n], R)
    assert bool((buf[n] == 7.0).all())


@pytest.mark.cuda
def test_stpcg_kernel_on_reweighted_problem(dev):
    """K1 on the Hred that with_weights rebuilt under dynamic rescale
    (Huber, artifacts/grid3D_synth.g2o with every tenth inter-node edge an
    outlier, after the first rescale) against its plain version: the same
    k per node and h within rtol 2e-4 / atol 2e-5."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.ops.stpcg import stpcg_fused_reference
    from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused
    from dpgo_tpu_torch.solvers.mm import MMOptions, stpcg_inputs
    from dpgo_tpu_torch.synthetic import with_outliers

    meas = read_g2o_file(os.path.join(REPO, "artifacts",
                                      "grid3D_synth.g2o"))
    meas, _ = with_outliers(meas, np.random.default_rng(0), 4)
    opts = MMOptions(accelerated=True, rescale="dynamic")
    s = DPGOSolver(meas, num_nodes=4, opts=opts, loss=Loss.HUBER,
                   loss_reg=0.25, dtype=torch.float32, device=dev)
    st, _ = s.run_steps(s.initialize(), 0, opts.max_rescale_count + 2)
    p = s.problems(st)
    assert p.dynamic and bool((st.scale_w < 1).any())
    assert not torch.equal(p.Hred_d, s.probs.Hred_d)
    args = stpcg_inputs(p, st)
    tnt = opts.tnt
    kw = dict(max_iters=tnt.max_tCG_iterations, kappa_fgr=tnt.kappa_fgr,
              theta=tnt.theta)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    for Delta in (1.0, 100.0):
        Dl = torch.full((4,), Delta, device=dev)
        h, _, _, k = stpcg_fused(*args, Dl, act, **kw)
        hr, _, _, kr = stpcg_fused_reference(*args, Dl, act, **kw)
        assert torch.equal(k.cpu(), kr.cpu())
        np.testing.assert_allclose(h.cpu().numpy(), hr.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_d2_problem_launches_k1(dev):
    """A d = 2 float32 problem on the card engages K1 (no silent plain CG):
    a few steps on a small Manhattan-world graph count D = 2 launches."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops import stpcg_cuda
    from dpgo_tpu_torch.synthetic import manhattan_world

    meas, _, _ = manhattan_world(np.random.default_rng(0), num_poses=800,
                                 grid=12, closures=800)
    s = DPGOSolver(meas, num_nodes=4, dtype=torch.float32, device=dev)
    assert s.probs.d == 2 and s.fused_stpcg_engaged()
    before = stpcg_cuda.Launches.by_d[2]
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, 10)
    assert stpcg_cuda.Launches.by_d[2] > before
    assert torch.isfinite(f).all()


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """A CUDA tensor goes to the kernel or raises: no fallback for float16,
    a wrong shape or non-contiguous input."""
    from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda

    with pytest.raises(TypeError):
        polar_so3_cuda(torch.zeros((4, 3, 3), dtype=torch.float16,
                                   device=dev))
    with pytest.raises(ValueError):
        polar_so3_cuda(torch.zeros((4, 3, 2), device=dev))
    with pytest.raises(ValueError):
        polar_so3_cuda(torch.zeros((3, 3, 4), dtype=torch.float64,
                                   device=dev).transpose(0, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 10241])
def test_polar_so3_kernel_f64_matches_plain(dev, rng, n):
    """K2's float64 instantiation within 1e-12 of its plain version on
    matrices with separated singular values, every fifth with det < 0 (as
    tests/test_aux.py mixes them in), a zero matrix, and a ragged count;
    it counts a float64 launch and writes nothing past the n-th matrix."""
    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches, polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3
    from dpgo_tpu_torch.synthetic import random_rotations

    sigma = np.array([1.0, 2.0, 3.5]) + rng.uniform(0, 0.5, size=(n, 3))
    sigma *= 10.0 ** rng.uniform(-2, 2, size=(n, 1))
    A = random_rotations(rng, n) @ (
        sigma[:, :, None] * random_rotations(rng, n).transpose(0, 2, 1))
    A[::5] *= -1.0
    A[3] = 0.0
    At = torch.tensor(A, dtype=torch.float64, device=dev)
    before = Launches.by_dtype[torch.float64]
    R = polar_so3_cuda(At)
    assert Launches.by_dtype[torch.float64] == before + 1
    assert R.dtype == torch.float64
    np.testing.assert_allclose(R.cpu().numpy(), polar_so3(At).cpu().numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(R[3].cpu().numpy(), np.eye(3), atol=0)
    buf = torch.full((n + 1, 3, 3), 7.0, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.load().dpgo_polar_so3_f64(
        At.data_ptr(), buf.data_ptr(), n, stream), "polar_so3")
    assert torch.equal(buf[:n], R)
    assert bool((buf[n] == 7.0).all())


@pytest.mark.cuda
def test_slice_kernels_match_plain_versions(dev):
    """The f32 slice on artifacts/grid3D_synth.g2o (512 poses, 4 nodes)
    through both kernels agrees with the same run through their plain
    versions: per-step 2f within rtol 1e-4 over 20 steps, both kernels
    launched, the fused CG engaged."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops import polar_so3_cuda, stpcg_cuda
    from dpgo_tpu_torch.utils import HostSyncs

    meas = read_g2o_file(os.path.join(REPO, "artifacts",
                                      "grid3D_synth.g2o"))
    s = DPGOSolver(meas, num_nodes=4, dtype=torch.float32, device=dev)
    assert s.fused_stpcg_engaged()
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    st, _, (f, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert stpcg_cuda.Launches.count > k1
    assert polar_so3_cuda.Launches.count > k2
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    _, _, (fp, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert (stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count) \
        == (k1, k2)
    assert torch.isfinite(f).all()
    np.testing.assert_allclose(f.cpu().numpy(), fp.cpu().numpy(), rtol=1e-4)


def _grid3d():
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    return read_g2o_file(os.path.join(REPO, "artifacts", "grid3D_synth.g2o"))


@pytest.mark.cuda
def test_default_f64_solver_runs_through_k2_f64(dev):
    """DPGOSolver with its defaults (float64, the card) at d = 3 launches
    K2's float64 instantiation (never the float32 one) and agrees with the
    run through the plain versions: per-step 2f within rtol 1e-9 over 10
    steps."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches
    from dpgo_tpu_torch.utils import HostSyncs

    s = DPGOSolver(_grid3d(), num_nodes=4)
    assert s.dtype == torch.float64 and s.probs.Hred_d.is_cuda
    f32, f64 = (Launches.by_dtype[torch.float32],
                Launches.by_dtype[torch.float64])
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, 10)
    assert Launches.by_dtype[torch.float64] > f64
    assert Launches.by_dtype[torch.float32] == f32
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    count = Launches.count
    _, _, (fp, _) = s.run_steps_history(s.initialize(), 0, 10)
    assert Launches.count == count
    np.testing.assert_allclose(f.cpu().numpy(), fp.cpu().numpy(), rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["star", "mm"])
def test_new_schemes_kernels_match_plain(dev, solver):
    """AMM-PGO* (DPGOStarSolver) and MM-PGO (accelerated=False) in float32
    on artifacts/grid3D_synth.g2o with 4 nodes: 20 steps through K1 and K2
    agree with the same run through their plain versions (per-step 2f
    within rtol 1e-4); both kernels launched; MM's 2f never rises by more
    than 1e-5 of itself."""
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.ops import polar_so3_cuda, stpcg_cuda
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.utils import HostSyncs

    cls = DPGOStarSolver if solver == "star" else DPGOSolver
    s = cls(_grid3d(), num_nodes=4,
            opts=MMOptions(accelerated=solver == "star"),
            dtype=torch.float32, device=dev)
    assert s.fused_stpcg_engaged()
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert stpcg_cuda.Launches.count > k1
    assert polar_so3_cuda.Launches.count > k2
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    _, _, (fp, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert (stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count) \
        == (k1, k2)
    f = f.cpu().numpy()
    assert np.isfinite(f).all()
    np.testing.assert_allclose(f, fp.cpu().numpy(), rtol=1e-4)
    if solver == "mm":
        assert np.all(np.diff(f) <= 1e-5 * np.abs(f[1:]))


@pytest.mark.cuda
def test_dchordal_kernels_match_plain(dev):
    """distributed_chordal_init in float32 on the card with K2 and with
    kernels=False (plain versions) on artifacts/grid3D_synth.g2o with 4
    nodes: K2 launched only by the first; 2f of the two starts within 1e-4
    relative; every rotation in SO(3) (|R^T R - I| <= 1e-4)."""
    from dpgo_tpu_torch.chordal import distributed_chordal_init
    from dpgo_tpu_torch.chordal.dchordal import chordal_objective
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches

    meas = _grid3d()
    count = Launches.count
    t, R = distributed_chordal_init(meas, 4, dtype=torch.float32,
                                    device=dev)
    assert Launches.count > count
    count = Launches.count
    tp, Rp = distributed_chordal_init(meas, 4, dtype=torch.float32,
                                      device=dev, kernels=False)
    assert Launches.count == count
    f = chordal_objective(meas, t.astype(np.float64), R.astype(np.float64))
    fp = chordal_objective(meas, tp.astype(np.float64),
                           Rp.astype(np.float64))
    np.testing.assert_allclose(f, fp, rtol=1e-4)
    RtR = np.einsum("nki,nkj->nij", R.astype(np.float64), R)
    assert np.abs(RtR - np.eye(3)).max() <= 1e-4


@pytest.mark.cuda
def test_polar_so3_kernel_at_100k_matrices(dev, rng):
    """K2 at [102400, 3, 3] float32, the projection batch of a 102,400-pose
    graph (16 nodes x 6,400 poses), within 1e-5 of its plain version."""
    from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3
    from dpgo_tpu_torch.synthetic import random_rotations

    n = 102400
    sigma = np.array([1.0, 2.0, 3.5]) + rng.uniform(0, 0.5, size=(n, 3))
    A = random_rotations(rng, n) @ (
        sigma[:, :, None] * random_rotations(rng, n).transpose(0, 2, 1))
    A[::5] *= -1.0
    At = torch.tensor(A, dtype=torch.float32, device=dev)
    R = polar_so3_cuda(At)
    assert R.shape == (n, 3, 3)
    np.testing.assert_allclose(R.cpu().numpy(), polar_so3(At).cpu().numpy(),
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["segment", "edgewise"])
def test_large_block_paths_kernels_match_plain(dev, path):
    """A forced-segment (segment_limit=32, seg_size=32) and a forced
    edge-wise (dense_limit=0) float32 solver on artifacts/grid3D_synth.g2o
    with 4 nodes (128 poses per node): 20 refined steps through K2 agree
    with the same run through its plain version (per-step 2f within rtol
    1e-4); K2 launched, K1 never (it is built for dense blocks only)."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops import polar_so3_cuda, stpcg_cuda
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    kw = (dict(segment_limit=32, seg_size=32) if path == "segment"
          else dict(dense_limit=0))
    s = DPGOSolver(_grid3d(), num_nodes=4, dtype=torch.float32, device=dev,
                   **kw)
    assert s.probs.seg == (path == "segment") and not s.probs.dense
    assert not s.fused_stpcg_engaged()
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    trips = DeviceCounters.read("stpcg.trips")
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert stpcg_cuda.Launches.count == k1
    assert polar_so3_cuda.Launches.count > k2
    # The torch STPCG refined (its trips counted inside the replays).
    assert DeviceCounters.read("stpcg.trips") > trips
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    k2 = polar_so3_cuda.Launches.count
    _, _, (fp, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert polar_so3_cuda.Launches.count == k2
    f = f.cpu().numpy()
    assert np.isfinite(f).all() and f[-1] < f[0]
    np.testing.assert_allclose(f, fp.cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_forced_segment_matches_dense_path_at_real_scale(dev):
    """artifacts/rim_synth.g2o (10,240 poses) with 16 nodes in float64,
    refinement off: the segment path forced with segment_limit=256 (640
    poses per node, 5 segments of 128) tracks the dense path. The segment
    path's only inexactness is the translation CG (tolerance 1e-7, 20
    trips), so the exact global 2f agrees within 1e-6 relative after 50
    steps and the mG00 matvec equals the dense mG00_d within 1e-12 of its
    largest entry."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    from dpgo_tpu_torch.utils import DeviceCounters

    meas = read_g2o_file(os.path.join(REPO, "artifacts", "rim_synth.g2o"))
    opts = MMOptions(accelerated=True, tnt=TNTParams(max_iterations=0))
    dense = DPGOSolver(meas, num_nodes=16, opts=opts, device=dev)
    seg = DPGOSolver(meas, num_nodes=16, opts=opts, device=dev,
                     segment_limit=256)
    assert dense.probs.dense and seg.probs.seg
    assert tuple(seg.probs.seg_t_inv.shape) == (16, 5, 128, 128)
    assert tuple(seg.probs.Minv_red.shape) == (16, 1, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(dense.probs.nvec.shape, generator=gen,
                    dtype=torch.float64, device=dev)
    ref = dense.probs.mG00_d @ v
    out = seg.probs.mG00_matvec(v)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    res = []
    for s in (dense, seg):
        entries = DeviceCounters.read("seg_cg.entries")
        st, _ = s.run_steps(s.initialize(), 0, 50)
        res.append([float(x) for x in s._metrics(st)])
    (fd, gd), (fs, gs) = res
    np.testing.assert_allclose(fs, fd, rtol=1e-6)
    np.testing.assert_allclose(gs, gd, rtol=1e-3)
    assert DeviceCounters.read("seg_cg.entries") - entries >= 50


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_polish_on_the_card_matches_plain(dev, dtype):
    """DPGOSolver.polish on the card (grid3D_synth, 4 nodes, refinement
    off, from the state after 10 steps, the rigid coarse level on): K2 in
    the solver's type is launched during the polish, 2f decreases, and the
    same polish with K2's plain version agrees (float64: 2f within rtol
    1e-10; float32: 1e-5)."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    s = DPGOSolver(_grid3d(), num_nodes=4, dtype=dtype, device=dev,
                   opts=MMOptions(tnt=TNTParams(max_iterations=0)))
    st, _ = s.run_steps(s.initialize(), 0, 10)
    f0 = float(s._metrics(st)[0])
    before = Launches.by_dtype[dtype]
    _, f2 = s.polish(st, outer=5, tcg=50, coarse=True)
    assert Launches.by_dtype[dtype] > before
    assert f2 < f0
    twin = copy.copy(s)
    twin.probs = dataclasses.replace(s.probs, kernels=False)
    count = Launches.count
    _, f2p = twin.polish(st, outer=5, tcg=50, coarse=True)
    assert Launches.count == count
    np.testing.assert_allclose(
        f2, f2p, rtol=1e-10 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_certify_on_the_card_matches_cpu(dev):
    """certify_solution with the operator on the card gives the CPU run's
    verdict and lambda_min (within 1e-6) on grid3D_synth's LM-polished
    estimate, and on a negative control (poses 100-199 turned 0.5 rad about
    z) rejects it like the CPU run."""
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.sesync.staircase import certify_solution
    from dpgo_tpu_torch.solvers.host_lm import lm_polish

    meas = _grid3d()
    R0 = chordal_initialization(meas)
    R = lm_polish(meas, recover_translations_global(meas, R0), R0).R
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    R_bad = R.copy()
    R_bad[100:200] = turn @ R_bad[100:200]
    for cand, want in ((R, True), (R_bad, False)):
        ok_c, lam_c, _, fx_c = certify_solution(meas, cand, device=dev)
        ok_h, lam_h, _, fx_h = certify_solution(meas, cand, device="cpu")
        assert ok_c == ok_h == want
        assert abs(lam_c - lam_h) <= 1e-6 * max(1.0, abs(lam_h))
        np.testing.assert_allclose(fx_c, fx_h, rtol=1e-12)


@pytest.mark.cuda
def test_round_solution_launches_k2_f64(dev):
    """SESyncProblem.round_solution on the card projects through K2's
    float64 instantiation and agrees with its plain version (1e-12)."""
    from dpgo_tpu_torch.ops.polar_so3_cuda import Launches
    from dpgo_tpu_torch.sesync import chordal_initialization
    from dpgo_tpu_torch.sesync.problem import build_sesync_problem

    meas = _grid3d()
    p = build_sesync_problem(meas, device=dev)
    R0 = chordal_initialization(meas)
    Y = torch.as_tensor(np.swapaxes(R0, 1, 2).reshape(-1, 3), device=dev)
    before = Launches.by_dtype[torch.float64]
    R = p.round_solution(Y)
    assert Launches.by_dtype[torch.float64] == before + 1
    Rp = dataclasses.replace(p, kernels=False).round_solution(Y)
    np.testing.assert_allclose(R.cpu().numpy(), Rp.cpu().numpy(), atol=1e-12)


def _outlier_grid3d():
    from dpgo_tpu_torch.synthetic import with_outliers
    return with_outliers(_grid3d(), np.random.default_rng(3), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcm_loop_errors_on_the_card_match_cpu(dev, dtype):
    """loop_errors on the card against the CPU in the same type, on the
    oriented inter-node edges of grid3D_synth with outliers (4 nodes,
    chordal estimate) for every node pair: within eps (1e-5 in float32,
    1e-12 in float64) times 1 + max |t|, the scale of the translations whose
    differences the loop error sums. pcm_filter on the card reads one mask
    per pair, runs the native cliques, and in float64 keeps the CPU's edges
    (in float32 an error within rounding of the tolerance may flip)."""
    from dpgo_tpu_torch import pcm
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.utils import HostSyncs

    meas, _ = _outlier_grid3d()
    R = chordal_initialization(meas)
    t = recover_translations_global(meas, R)
    eps = (1e-5 if dtype == torch.float32 else 1e-12) * (
        1.0 + np.abs(t).max())
    pairs = 0
    for es, Rm, tm, gi, gj in pcm._oriented_pairs(meas, 4):
        ones = np.ones(len(es))
        A = (Rm, tm, ones, ones, t[gi], R[gi], t[gj], R[gj])
        on_card = pcm.loop_errors(pcm._on(A, dev, dtype), pcm._on(A, dev,
                                                                 dtype))
        on_cpu = pcm.loop_errors(pcm._on(A, "cpu", dtype),
                                 pcm._on(A, "cpu", dtype))
        assert on_card.is_cuda and on_card.dtype == dtype
        np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(),
                                   rtol=0, atol=eps)
        pairs += 1
    opts = pcm.PCMOptions(tolerance=3.0)
    syncs = HostSyncs()
    pcm.CliqueRoutes.reset()
    _, keep = pcm.pcm_filter(meas, 4, t, R, opts, device=dev, dtype=dtype,
                             syncs=syncs)
    assert syncs.count == pairs > 0
    assert pcm.CliqueRoutes.counts["native"] == pairs
    if dtype == torch.float64:
        _, keep_cpu = pcm.pcm_filter(meas, 4, t, R, opts, device="cpu",
                                     dtype=dtype)
        np.testing.assert_array_equal(keep, keep_cpu)


@pytest.mark.cuda
def test_aa_with_k2_matches_plain(dev):
    """MMOptions(scheme="aa") in float32 on grid3D_synth with 4 nodes: 20
    steps through K2 (every Anderson candidate is projected by it) agree
    with the run through the plain versions (per-step 2f within rtol
    1e-4), no host read in the step, 2f never rises by more than 1e-5 of
    itself (the monotone safeguard)."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops import polar_so3_cuda, stpcg_cuda
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    s = DPGOSolver(_grid3d(), num_nodes=4, opts=MMOptions(scheme="aa"),
                   dtype=torch.float32, device=dev)
    k1, k2 = stpcg_cuda.Launches.count, polar_so3_cuda.Launches.count
    k2_dev = DeviceCounters.read("polar_so3")
    _, _, (f, _) = s.run_steps_history(s.initialize(), 0, 20)
    # Two per step, counted at every replay of the captured step.
    assert DeviceCounters.read("polar_so3") >= k2_dev + 40
    assert polar_so3_cuda.Launches.count > k2
    assert stpcg_cuda.Launches.count == k1
    assert s.syncs.count == 0
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    k2 = polar_so3_cuda.Launches.count
    _, _, (fp, _) = s.run_steps_history(s.initialize(), 0, 20)
    assert polar_so3_cuda.Launches.count == k2
    f = f.cpu().numpy()
    assert np.isfinite(f).all()
    assert np.all(np.diff(f) <= 1e-5 * np.abs(f[1:]))
    np.testing.assert_allclose(f, fp.cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_lsqr_and_tnls_on_the_card_match_cpu(dev, rng):
    """lsqr (a 30 x 10 least-squares problem with a trust radius) and tnls
    (the sphere problem min |x - p| on S^2) on the card in float64 against
    the CPU: same iterations, results within 1e-12."""
    from dpgo_tpu_torch.solvers.optimization import TNLSParams, lsqr, tnls

    A = torch.as_tensor(rng.normal(size=(30, 10)))
    b = torch.as_tensor(rng.normal(size=(30,)))
    out = {}
    for where in ("cpu", dev):
        Ad, bd = A.to(where), b.to(where)
        x, xn, k = lsqr(lambda v: Ad @ v, lambda u: Ad.T @ u, bd,
                        torch.zeros(10, dtype=torch.float64, device=where),
                        max_iters=200, atol=1e-12, Delta=0.3,
                        return_info=True)
        p = torch.tensor([1.0, 2.0, 2.0], dtype=torch.float64, device=where)
        y, Fn, gn, kt = tnls(
            lambda x: x - p, lambda x, v: v,
            lambda x, w: w - x * (x * w).sum(),
            lambda x, h: (x + h) / torch.linalg.norm(x + h),
            torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64,
                         device=where), TNLSParams(max_iterations=60))
        assert x.device.type == torch.device(where).type
        out[str(where)] = (x.cpu(), float(xn), k, y.cpu(), float(Fn), kt)
    (x0, n0, k0, y0, F0, kt0), (x1, n1, k1, y1, F1, kt1) = out.values()
    assert (k0, kt0) == (k1, kt1)
    np.testing.assert_allclose(x1.numpy(), x0.numpy(), atol=1e-12)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=1e-12)
    np.testing.assert_allclose([n1, F1], [n0, F0], rtol=1e-12)


@pytest.mark.cuda
def test_native_library_built_by_the_port(dev):
    """The port's loader builds libdpgo_native.so in its own build directory
    from native/*.cpp (never running make in native/): the clique solver
    and the g2o reader load from it and agree with the Python versions."""
    from dpgo_tpu_torch.io import native
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops._build import BUILD_DIR
    from dpgo_tpu_torch.pcm import max_clique_exact

    assert native.native_available(), native._Loaded.failed
    assert os.path.dirname(native.LIB_PATH) == BUILD_DIR
    assert os.path.exists(native.LIB_PATH + ".sha256")
    adj = np.random.default_rng(1).random((30, 30)) < 0.5
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    assert native.max_clique_native(adj).sum() == max_clique_exact(adj).sum()
    path = os.path.join(REPO, "artifacts", "grid3D_synth.g2o")
    got, want = native.read_g2o_file_native(path), read_g2o_file(path)
    np.testing.assert_array_equal(got.i, want.i)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-12, atol=1e-12)


def _sharded_on_card(backend, devices, names):
    """The cases `names` of tests/torch_spmd_ranks.py on grid3D_synth (8
    nodes, float64) in a group of len(devices) ranks, and the
    single-process solver's results on the card."""
    import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.parallel.launch import spawn

    graphs = {"d3": read_g2o_file(os.path.join(REPO, "artifacts",
                                               "grid3D_synth.g2o")),
              "num_nodes": 8}
    world = spawn(ranks.run_cases, len(devices), backend=backend,
                  devices=devices, args=(graphs, names), deadline=300.0)
    single = {}
    for name in names:
        solver, c = ranks.make_solver(name, graphs, "cuda", sharded=False)
        single[name] = ranks.drive(solver, c)
    return world, single


@pytest.mark.cuda
def test_sharded_nccl_world1_matches_single(dev):
    """ShardedDPGOSolver and ShardedDPGOStarSolver over NCCL at world size 1
    on the card: the single-process solvers' 2f histories (rtol 1e-9; float
    index_add_ on the card is not deterministic), no host copies."""
    names = ["acc_boundary", "star"]
    world, single = _sharded_on_card("nccl", ["cuda:0"], names)
    for name in names:
        res = world[0][name]
        assert res["backend"] == "nccl" and res["comm"][2] == 0
        np.testing.assert_allclose(res["f"], single[name]["f"], rtol=1e-9)


@pytest.mark.cuda
def test_sharded_gloo_ranks_share_one_card(dev):
    """Two gloo ranks on cuda:0, each halo strategy: every collective's
    buffers are staged through the host (two copies each), and the 2f
    history is the single-process solver's (rtol 1e-9) on both ranks."""
    names = ["acc_boundary", "acc_gather", "acc_ring"]
    world, single = _sharded_on_card("gloo", ["cuda:0", "cuda:0"], names)
    for name in names:
        for out in world:
            res = out[name]
            calls, _, copies = res["comm"]
            assert res["backend"] == "gloo" and copies == 2 * calls > 0
            np.testing.assert_allclose(res["f"], single[name]["f"],
                                       rtol=1e-9)


@pytest.mark.cuda
def test_split_polish_on_the_card(dev):
    """The polish with its pose axis split over two gloo ranks on cuda:0
    (grid3D_synth, 8 nodes, float64; the default case and Huber): 2f equal
    on both ranks and within rtol 1e-9 of the single-process polish on the
    card, each rank holding its own nodes' problems only, every collective
    staged through the host."""
    names = ["polish", "polish_huber"]
    world, single = _sharded_on_card("gloo", ["cuda:0", "cuda:0"], names)
    for name in names:
        for out in world:
            res = out[name]
            assert res["polish_f"] == world[0][name]["polish_f"]
            np.testing.assert_allclose(res["polish_f"],
                                       single[name]["polish_f"], rtol=1e-9)
            assert res["share"]["prob_rows"] == [4]
            assert not res["share"]["full_probs"]
            counts = res["polish_counts"]
            assert counts["host_copies"] == 2 * counts["collectives"] > 0


# ------------------------------------------------------------ graph route


def _graph_solver(dev, kind, dtype):
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    kw = dict(segment_limit=32, seg_size=32) if kind == "segment" else {}
    cls = DPGOStarSolver if kind == "star" else DPGOSolver
    return cls(_grid3d(), num_nodes=4, opts=MMOptions(accelerated=True),
               dtype=dtype, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dense", "segment", "star"])
def test_graph_route_matches_eager_route(dev, kind, dtype):
    """run_steps_history (the captured step replayed, conditional nodes for
    its branches and loops) against run_steps_history_eager (the same step,
    flags read on the host) on grid3D_synth with 4 nodes: per-step 2f
    within 1e-5 relative in float32 (index_add_ and atomics sum in another
    order from run to run), 1e-10 in float64, and there 2|grad| within
    1e-7; no host read on the graph
    route; the device counters of K2 (and of K1 on the dense f32 path)
    move at every replay of an unchanged capture."""
    from dpgo_tpu_torch.utils import DeviceCounters
    s = _graph_solver(dev, kind, dtype)
    st0 = s.initialize()
    syncs = s.syncs.count
    st, k, (f, g) = s.run_steps_history(st0, 0, 20)
    assert k == 20 and s.syncs.count == syncs
    capture = s._graph
    _, _, (fe, ge) = s.run_steps_history_eager(st0, 0, 20)
    assert s.syncs.count > syncs
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    np.testing.assert_allclose(f.cpu().numpy(), fe.cpu().numpy(), rtol=rtol)
    if dtype == torch.float64:
        # In float32 the gradient norm near the optimum is cancellation:
        # the two routes' scatter orders move it by up to ~15%.
        np.testing.assert_allclose(g.cpu().numpy(), ge.cpu().numpy(),
                                   rtol=1e3 * rtol)
    k2 = "polar_so3" if dtype == torch.float32 else "polar_so3_f64"
    names = [k2] + (["stpcg"] if kind == "dense"
                    and dtype == torch.float32 else [])
    before = {n: DeviceCounters.read(n) for n in names}
    s.run_steps(st, 20, 5)
    assert s._graph is capture  # no recapture
    for n in names:
        assert DeviceCounters.read(n) >= before[n] + 5, n


@pytest.mark.cuda
def test_graph_replay_reads_nothing_on_the_host(dev):
    """Once captured, a run_steps call (load, replays, the copy out) and a
    run_steps_history call run under torch.cuda.set_sync_debug_mode
    ("error"): no operation waits for the card. Huber with dynamic
    rescale, so the reweighted problems rebuild inside the replay."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions
    s = DPGOSolver(_grid3d(), num_nodes=4, dtype=torch.float32, device=dev,
                   opts=MMOptions(accelerated=True, rescale="dynamic"),
                   loss=Loss.HUBER)
    st0 = s.initialize()
    s.run_steps(st0, 0, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = s.run_steps(st0, 0, 10)
        st, _, _ = s.run_steps_history(st, 10, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(st.Z.t).all())
    assert float(st.scale_w.min()) < 1.0  # the rescale ran in the replays


@pytest.mark.cuda
def test_graph_runs_from_one_state_are_equal_and_do_not_alias(dev):
    """Two run_steps calls from one state give the same state (to 1e-9 of
    each field's largest entry: the card's scatter order), neither
    shares memory with the start, the other result or the capture's
    buffers, and the start is left as it was."""
    from dpgo_tpu_torch.utils import flatten
    s = _graph_solver(dev, "dense", torch.float64)
    st0 = s.initialize()
    before = [x.clone() for x in flatten(st0)[0]]
    a, _ = s.run_steps(st0, 0, 6)
    b, _ = s.run_steps(st0, 0, 6)
    # (Zero-sized fields, Anderson's history off, hold no memory.)
    held = {x.untyped_storage().data_ptr() for x in s._graph.static
            if x.numel()}
    for x0, x, y, z in zip(before, flatten(st0)[0], flatten(a)[0],
                           flatten(b)[0]):
        assert torch.equal(x0, x)
        # float64; index_add_'s atomics sum in another order per run, so
        # a field is held to 1e-9 of its largest entry.
        scale = (float(z.abs().max()) if z.is_floating_point()
                 and z.numel() else 0.0)
        torch.testing.assert_close(y, z, rtol=0, atol=1e-9 * scale)
        if x.numel():
            ptrs = {t.untyped_storage().data_ptr() for t in (x, y, z)}
            assert len(ptrs) == 3 and not ptrs & held


@pytest.mark.cuda
def test_failed_capture_raises(dev):
    """A step that reads the card on the host cannot be captured: run_steps
    raises (at the read, in the warm-up before the capture; no quiet fall
    back to the host-read route) and keeps no graph; the solver's
    host-read route still runs."""
    s = _graph_solver(dev, "dense", torch.float32)
    st0 = s.initialize()
    advance = s._advance

    def reads_the_card(probs, st, k):
        out = advance(probs, st, k)
        float(out[0].fobj.sum())
        return out

    s._advance = reads_the_card
    with pytest.raises(RuntimeError, match="synchroniz"):
        s.run_steps(st0, 0, 3)
    assert s._graph is None
    st, k = s.run_steps_eager(st0, 0, 2)
    assert k == 2 and bool(torch.isfinite(st.Z.t).all())


# ------------------------------------------- sharded graph route over NCCL

_NCCL_GRAPH = {}


def _nccl_graph_world():
    """tests/torch_spmd_ranks.py::nccl_graph_checks in one NCCL rank on
    cuda:0 (grid3D_synth, 8 nodes), spawned once for the tests below."""
    if not _NCCL_GRAPH:
        import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)

        from dpgo_tpu_torch.parallel.launch import spawn
        graphs = {"d3": _grid3d(), "num_nodes": 8}
        _NCCL_GRAPH["world"] = spawn(ranks.nccl_graph_checks, 1,
                                     backend="nccl", devices=["cuda:0"],
                                     args=(graphs,), deadline=300.0)
    return _NCCL_GRAPH["world"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["acc_boundary", "star_psi"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_nccl_graph_route_matches_host_route(dev, name, dtype):
    """ShardedDPGOSolver (AMM-PGO#) and ShardedDPGOStarSolver over NCCL at
    world size 1 take the graph route (the step captured, NCCL
    collectives inside, in IF bodies for AMM-PGO*), with no host flag
    read: per-step 2f within 1e-5 relative of the host-read route in
    float32 (the card's scatter order), 1e-10 in float64. AMM-PGO* at
    psi = phi = 1e3, so that its master fallbacks (an exchange and an
    all_reduce each) run inside the IF bodies."""
    res = _nccl_graph_world()[f"{name}_{dtype}"]
    assert res["backend"] == "nccl" and res["captured"]
    assert res["graph_syncs"] == 0 and res["eager_syncs"] > 0
    rtol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(res["f"], res["fe"], rtol=rtol)


@pytest.mark.cuda
def test_sharded_nccl_replays_read_nothing_on_the_host(dev):
    """Once captured, run_steps of the sharded solvers over NCCL (load,
    replays, the copy out) runs under torch.cuda.set_sync_debug_mode
    ("error")."""
    for key, res in _nccl_graph_world().items():
        if key != "failed_capture":
            assert res["replay_sync"] is None, (key, res["replay_sync"])


@pytest.mark.cuda
def test_sharded_nccl_failed_capture_raises(dev):
    """A sharded step that reads the card on the host cannot be captured:
    over NCCL run_steps raises (no quiet fall back to the host-read route)
    and keeps no graph; the host-read route still runs."""
    res = _nccl_graph_world()["failed_capture"]
    assert res["raised"] is not None and "synchroniz" in res["raised"]
    assert res["no_graph"] and res["eager_ran"]


@pytest.mark.cuda
def test_capture_node_types_see_the_recorded_nodes(dev):
    """graph_nodes.capture_node_types lists the nodes recorded so far into
    the graph the current stream captures into: a kernel at the top level,
    and inside an IF body the body's own kernel, not the top level's."""
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import current_route, device_cond

    x = torch.ones(8, device=dev)
    seen = {}

    def note(key):
        # The warm-up before the capture runs fn on another route.
        if current_route() == "capture":
            seen[key] = graph_nodes.capture_node_types()

    def fn():
        y = x * 2.0
        note("top")

        def body():
            z = y + 1.0
            note("body")
            return z
        return device_cond(y.sum() > 0, body, lambda: y)

    out, _ = graph_nodes.run_once(dev, fn)
    assert torch.equal(out, torch.full_like(x, 3.0))
    assert "kernel" in seen["top"]
    assert seen["body"] == ["kernel"]


@pytest.mark.cuda
def test_polish_graph_route_matches_host_route(dev):
    """DPGOSolver.polish on the card runs its TNT as one captured program
    (no host flag read in it) and reaches the host-read route's 2f within
    1e-10 in float64, with the same outer iterations (grid3D_synth, 4
    nodes, the coarse level)."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    s = DPGOSolver(_grid3d(), num_nodes=4, dtype=torch.float64, device=dev,
                   opts=MMOptions(tnt=TNTParams(max_iterations=0)))
    st0, _ = s.run_steps(s.initialize(), 0, 10)
    _, f2 = s.polish(st0, outer=5, tcg=100, coarse=True)
    graph = s.polish_stats
    _, f2e = s.polish(st0, outer=5, tcg=100, coarse=True, eager=True)
    host = s.polish_stats
    assert (graph["route"], host["route"]) == ("graph", "host")
    assert graph["tnt_host_syncs"] == 0 and host["tnt_host_syncs"] > 0
    assert graph["outer"] == host["outer"] == 5
    np.testing.assert_allclose(f2, f2e, rtol=1e-10)


# ------------------- the split polish over NCCL, SE-Sync's captured loops

@pytest.mark.cuda
def test_split_polish_nccl_graph_route_matches_host_route(dev):
    """The split polish over NCCL (one rank on cuda:0, grid3D_synth, 8
    nodes, float64) takes the graph route: no host flag read over the
    polish, 2f within 1e-10 of the host-read route's from the same start,
    exchanges and collectives per CG iteration within 0.1 of its (device
    counters on both routes), with and without segment levels."""
    import torch_spmd_ranks as ranks  # tests/ (pytest puts it on the path)

    from dpgo_tpu_torch.parallel.launch import spawn
    graphs = {"d3": _grid3d(), "num_nodes": 8}
    res = spawn(ranks.nccl_polish_checks, 1, backend="nccl",
                devices=["cuda:0"], args=(graphs,), deadline=300.0)[0]
    for name in ("polish", "polish_levels"):
        g, h = res[(name, False)], res[(name, True)]
        assert (g["route"], h["route"]) == ("graph", "host")
        assert g["host_syncs"] == 0 < h["host_syncs"]
        np.testing.assert_allclose(g["f2"], h["f2"], rtol=1e-10)
        for k in ("exchanges", "collectives"):
            assert abs(g[k] / g["cg_iterations"]
                       - h[k] / h["cg_iterations"]) <= 0.1, k


@pytest.mark.cuda
def test_lobpcg_graph_route_matches_host_route(dev):
    """min_eig_lobpcg as one captured program (Jacobi Rayleigh-Ritz) on a
    certificate-like spectrum, deflated, to a residual tolerance: no host
    flag read, theta within 1e-8 of the host route's (torch.linalg.eigh),
    and the same smallest eigenvalue as numpy on the complement (1e-6)."""
    from dpgo_tpu_torch.sesync.staircase import min_eig_lobpcg
    from dpgo_tpu_torch.utils import HostSyncs

    rng = np.random.default_rng(42)
    n = 300
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([[1e-3], np.geomspace(1.0, 1e3, n - 1)])
    S = torch.tensor((Q * w[None, :]) @ Q.T, device=dev)
    D = torch.tensor(rng.normal(size=(n, 3)), device=dev)
    out = {}
    for graph in (True, False):
        syncs, stats = HostSyncs(), {}
        th, _, _ = min_eig_lobpcg(lambda V: S @ V, n, 0, torch.float64,
                                  iters=400, deflate=D, syncs=syncs,
                                  graph=graph, stats=stats)
        out[graph] = (float(th), syncs.count, stats)
    assert out[True][2]["route"] == "graph" and out[True][1] == 0
    assert out[False][2]["route"] == "host" and out[False][1] > 0
    assert abs(out[True][0] - out[False][0]) <= 1e-8
    Qd, _ = np.linalg.qr(D.cpu().numpy())
    P = np.eye(n) - Qd @ Qd.T
    want = np.linalg.eigvalsh(P @ S.cpu().numpy() @ P + 1e6 * Qd @ Qd.T)[0]
    assert abs(out[True][0] - want) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", ["simplified", "sosync", "explicit"])
def test_sesync_graph_route_matches_host_route(dev, formulation):
    """sesync on grid3D_synth with each rank's TNT (and sosync's LOBPCG
    certificate) captured: the same status and rank as the host-read
    route, 2 SDP within 1e-10, no host flag read in the captured TNTs."""
    from dpgo_tpu_torch.sesync.staircase import sesync

    out = {}
    for graph in (True, False):
        stats = {}
        res = sesync(_grid3d(), formulation=formulation, device=dev,
                     graph=graph, stats=stats)
        out[graph] = (res, stats)
    (g, gs), (h, hs) = out[True], out[False]
    assert (gs["route"], hs["route"]) == ("graph", "host")
    assert (g.status, g.rank) == (h.status, h.rank) == ("GlobalOpt", 3)
    np.testing.assert_allclose(g.sdp_val, h.sdp_val, rtol=1e-10)
    assert all(r["tnt_host_syncs"] == 0 for r in gs["ranks"])
    assert all(r["tnt_host_syncs"] > 0 for r in hs["ranks"])
    if formulation == "sosync":
        assert [x["route"] for x in gs["lobpcg"]] == ["graph"]


@pytest.mark.cuda
def test_certify_lobpcg_graph_route_matches_host_route(dev):
    """certify_solution(method="lobpcg") on grid3D_synth's staircase
    optimum and a rotated control with the LOBPCG captured: the host
    route's verdicts (certified / rejected), lambda_min within 1e-5, no
    host sync in the certificate, S applications counted on the device."""
    from dpgo_tpu_torch.sesync.staircase import certify_solution, sesync

    meas = _grid3d()
    R = sesync(meas, device=dev).R
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    R_bad = R.copy()
    R_bad[100:200] = turn @ R_bad[100:200]
    for cand, want in ((R, True), (R_bad, False)):
        res = {}
        for graph in (True, False):
            stats = {}
            ok, lam, _, _ = certify_solution(meas, cand, method="lobpcg",
                                             device=dev, graph=graph,
                                             stats=stats)
            res[graph] = (ok, lam, stats)
        (gok, glam, gst), (hok, hlam, hst) = res[True], res[False]
        assert gok == hok == want
        assert abs(glam - hlam) <= 1e-5
        assert gst["lobpcg"]["route"] == "graph" and gst["host_syncs"] == 0
        assert gst["apply_S_calls"] > 0 and hst["apply_S_calls"] > 0


# ------------------------------- DChordal's stages as one captured program

def _dchordal_run(s, kernels, graph):
    """One run of DChordal's stages from set-up `s`: (t, R, stats, device
    counts of K2, conditional nodes and the stage loops)."""
    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.utils import DeviceCounters
    DeviceCounters.reset()
    stats = {}
    t, R = dchordal._run(s, kernels, graph, stats)
    names = ["polar_so3", "polar_so3_f64", "graph_cond"] + [
        f"dchordal.{n}.{k}" for n in ("reduced_R", "full_R", "reduced_t",
                                      "full_t") for k in ("entries", "trips")]
    return t, R, stats, {n: DeviceCounters.read(n) for n in names}


@pytest.mark.cuda
def test_dchordal_graph_route_matches_host_route(dev):
    """DChordal's stages on the card as one captured program against the
    host-read route, from one float64 set-up (grid3D_synth, 4 nodes): t
    and R within 1e-8, 2f within 1e-8 relative; no host flag read on the
    graph route (some on the host-read route); conditional nodes and the
    four stage loops (one entry, their trips) counted on the device; K2
    launches equal on both routes; with kernels=False the graph route
    launches no K2."""
    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.chordal.dchordal import chordal_objective

    meas = _grid3d()
    cfg = dchordal.DChordalConfig()
    s = dchordal._setup(meas, 4, cfg, torch.float64, dev)
    gt, gR, gs, gc = _dchordal_run(s, True, True)
    ht, hR, hs, hc = _dchordal_run(s, True, False)
    pt, pR, ps, pc = _dchordal_run(s, False, True)
    assert (gs["route"], hs["route"], ps["route"]) == ("graph", "host",
                                                       "graph")
    np.testing.assert_allclose(gt, ht, rtol=0, atol=1e-8)
    np.testing.assert_allclose(gR, hR, rtol=0, atol=1e-8)
    np.testing.assert_allclose(chordal_objective(meas, gt, gR),
                               chordal_objective(meas, ht, hR), rtol=1e-8)
    assert gs["host_syncs"] == 0 and ps["host_syncs"] == 0
    assert hs["host_syncs"] > 0
    assert gc["graph_cond"] > 0 and pc["graph_cond"] > 0
    assert hc["graph_cond"] == 0
    for c in (gc, hc, pc):
        assert [c["dchordal.reduced_R.entries"], c["dchordal.reduced_R.trips"],
                c["dchordal.full_R.trips"], c["dchordal.reduced_t.trips"],
                c["dchordal.full_t.trips"]] == [
            1, cfg.iters_reduced_R, cfg.iters_full_R, cfg.iters_reduced_t,
            cfg.iters_full_t]
    assert gc["polar_so3_f64"] == hc["polar_so3_f64"] > 0
    assert pc["polar_so3_f64"] == pc["polar_so3"] == 0
    assert gs["capture_s"] > 0 and gs["replay_s"] > 0


@pytest.mark.cuda
def test_dchordal_takes_the_graph_route_by_default(dev):
    """distributed_chordal_init and DPGOSolver.initialize(dist_init=True)
    take the graph route on the card (grid3D_synth, 4 nodes, float32), with
    no host flag read."""
    from dpgo_tpu_torch.chordal import distributed_chordal_init
    from dpgo_tpu_torch.driver import DPGOSolver

    meas = _grid3d()
    stats = {}
    distributed_chordal_init(meas, 4, dtype=torch.float32, device=dev,
                             stats=stats)
    assert stats["route"] == "graph" and stats["host_syncs"] == 0
    s = DPGOSolver(meas, num_nodes=4, dtype=torch.float32, device=dev)
    s.initialize(dist_init=True)
    assert s.dchordal_stats["route"] == "graph"
    assert s.dchordal_stats["host_syncs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sqrt_on_the_card_is_correctly_rounded(dev, rng, dtype):
    """torch.sqrt on the card equals numpy's correctly rounded root on
    10^6 values, so DChordal's Nesterov scalars on the device keep the
    bits of the host's numpy scalars."""
    x = rng.uniform(1.0, 1e6, 1_000_000).astype(
        str(dtype).removeprefix("torch."))
    got = torch.sqrt(torch.as_tensor(x, device=dev)).cpu().numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))


# The rim cells' block counts per node batch (16 nodes): intra edges m0,
# inter edges m1, poses n0 (pgobench's rim3d_10k_16n).
RIM_BLOCKS = (24848, 14048, 10208)


def _k3_operands(rng, n, d, dtype, dev, form):
    """Operands of one K3 form ("nn", "nt", "tn", "tt" or "mv") on the card
    (transposes as views) and the same on the CPU in float64."""
    A = torch.as_tensor(rng.normal(size=(n, d, d))).to(dtype)
    B = torch.as_tensor(rng.normal(size=(n, d) if form == "mv"
                                   else (n, d, d))).to(dtype)
    if form in ("tn", "tt"):
        A = A.transpose(-1, -2)
    if form in ("nt", "tt"):
        B = B.transpose(-1, -2)
    return A.to(dev), B.to(dev), A.double(), B.double()


@pytest.mark.cuda
@pytest.mark.parametrize("n", RIM_BLOCKS + (1, 33, 64, 65))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2, 3])
def test_block_mm_kernel_matches_plain(dev, rng, d, dtype, n):
    """K3 in every form (nn, nt, tn, tt as transpose views, mv) against its
    plain twin (the torch product) computed in float64 on the CPU: within
    2e-6 of the blocks' scale in float32 (a d-term FMA chain), 1e-14 in
    float64; one launch per call, counted on the device."""
    from dpgo_tpu_torch.ops import block_mm_cuda
    from dpgo_tpu_torch.utils import DeviceCounters
    tol = 2e-6 if dtype == torch.float32 else 1e-14
    for form in ("nn", "nt", "tn", "tt", "mv"):
        A, B, A64, B64 = _k3_operands(rng, n, d, dtype, dev, form)
        launches = block_mm_cuda.Launches.count
        dc = DeviceCounters.read("block_mm")
        if form == "mv":
            out = block_mm_cuda.block_mv(A, B)
            ref = (A64 @ B64[..., None])[..., 0]
        else:
            out = block_mm_cuda.block_mm(A, B)
            ref = A64 @ B64
        assert out.dtype == dtype and out.shape == ref.shape
        assert block_mm_cuda.Launches.count == launches + 1
        assert DeviceCounters.read("block_mm") == dc + 1
        np.testing.assert_allclose(out.double().cpu().numpy(), ref.numpy(),
                                   rtol=0, atol=tol * d, err_msg=form)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["broadcast", "strided", "offset",
                                    "batched", "broadcast_lead"])
def test_block_mm_kernel_other_layouts(dev, rng, layout):
    """K3 on operands read straight from global memory (a broadcast block,
    a strided view of a larger stack), on a stack that starts off the
    16-byte grid (the scalar staging path), on [N, m, 3, 3] stacks with a
    leading node axis, and on a [m, 3, 3] stack broadcast over that axis
    (copied first): equal to the torch product on the card within 2e-6."""
    from dpgo_tpu_torch.ops import block_mm_cuda
    f = dict(dtype=torch.float32, device=dev)
    n = 14048
    B = torch.as_tensor(rng.normal(size=(n, 3, 3)), **f)
    if layout == "broadcast":
        A = torch.as_tensor(rng.normal(size=(1, 3, 3)), **f).expand(n, 3, 3)
    elif layout == "strided":
        A = torch.as_tensor(rng.normal(size=(n, 4, 4)), **f)[:, 1:, :3]
    elif layout == "offset":
        A = torch.as_tensor(rng.normal(size=(n * 9 + 1,)), **f)[1:]
        A = A.view(n, 3, 3)
    elif layout == "batched":
        A = torch.as_tensor(rng.normal(size=(16, n // 16, 3, 3)), **f)
        B = B.view(16, n // 16, 3, 3)
    else:
        A = torch.as_tensor(rng.normal(size=(16, n // 16, 3, 3)), **f)
        B = B[:n // 16]
    torch.testing.assert_close(block_mm_cuda.block_mm(A, B), A @ B,
                               rtol=0, atol=2e-6 * 3)
    v = B[..., 0]  # a strided vector operand
    torch.testing.assert_close(block_mm_cuda.block_mv(A, v),
                               (A @ v[..., None])[..., 0], rtol=0,
                               atol=2e-6 * 3)


@pytest.mark.cuda
def test_block_mm_kernel_raises_on_what_it_does_not_take(dev):
    """On the card K3 launches or raises: float16, d = 4 and operands on
    two devices raise; a CPU operand beside a CUDA one too."""
    from dpgo_tpu_torch.ops import block_mm_cuda
    for A, B, err in (
            (torch.zeros((4, 3, 3), dtype=torch.float16, device=dev),
             torch.zeros((4, 3, 3), dtype=torch.float16, device=dev),
             TypeError),
            (torch.zeros((4, 4, 4), device=dev),
             torch.zeros((4, 4, 4), device=dev), ValueError),
            (torch.zeros((4, 3, 3), device=dev), torch.zeros((4, 3, 3)),
             ValueError)):
        with pytest.raises(err):
            block_mm_cuda.block_mm(A, B)


@pytest.mark.cuda
def test_block_mm_kernel_in_a_cuda_graph(dev, rng):
    """K3 captured into a CUDA graph (nn and mv at the rim cells' m0) and
    replayed after its inputs change in place: each replay equals an
    uncaptured launch on the new inputs bit for bit, and the device counter
    moves by the captured launches at every replay."""
    from dpgo_tpu_torch.ops import block_mm_cuda
    from dpgo_tpu_torch.utils import DeviceCounters
    n = RIM_BLOCKS[0]
    f = dict(dtype=torch.float32, device=dev)
    A = torch.as_tensor(rng.normal(size=(n, 3, 3)), **f)
    B = torch.as_tensor(rng.normal(size=(n, 3, 3)), **f)
    v = torch.as_tensor(rng.normal(size=(n, 3)), **f)
    block_mm_cuda.block_mm(A, B)  # the counter and the library, uncaptured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        C = block_mm_cuda.block_mm(A, B.transpose(-1, -2))
        c = block_mm_cuda.block_mv(C, v)
    for k in range(3):
        A.copy_(torch.as_tensor(rng.normal(size=(n, 3, 3)), **f))
        v.copy_(torch.as_tensor(rng.normal(size=(n, 3)), **f))
        before = DeviceCounters.read("block_mm")
        graph.replay()
        torch.cuda.synchronize()
        assert DeviceCounters.read("block_mm") == before + 2
        C_ref = block_mm_cuda.block_mm(A, B.transpose(-1, -2))
        assert torch.equal(C, C_ref)
        assert torch.equal(c, block_mm_cuda.block_mv(C_ref, v))


@pytest.mark.cuda
@pytest.mark.parametrize("tnt", [0, 10])
def test_block_mm_counter_counts_the_launches_of_a_step(dev, tnt):
    """The "block_mm" device counter over one step equals the K3 launches
    of that step: on the host route it moves with the wrapper's launch
    count, and the captured step replayed from the same state moves it by
    the same number (K3 adds its own count inside each launch). Proximal
    (tnt 0) and refined (tnt 10) steps on grid3D_synth, float32."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.ops import block_mm_cuda
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    from dpgo_tpu_torch.utils import DeviceCounters
    s = DPGOSolver(_grid3d(), num_nodes=4, dtype=torch.float32, device=dev,
                   opts=MMOptions(accelerated=True,
                                  tnt=TNTParams(max_iterations=tnt)))
    st0 = s.initialize()
    st1, _ = s.run_steps_eager(st0, 0, 3)
    launches = block_mm_cuda.Launches.count
    dc = DeviceCounters.read("block_mm")
    s.run_steps_eager(st1, 3, 1)
    per_step = block_mm_cuda.Launches.count - launches
    assert per_step >= 10
    assert DeviceCounters.read("block_mm") - dc == per_step
    s.run_steps(st1, 3, 1)  # warm-up and capture
    dc = DeviceCounters.read("block_mm")
    launches = block_mm_cuda.Launches.count
    s.run_steps(st1, 3, 1)
    assert block_mm_cuda.Launches.count == launches  # replayed, not issued
    assert DeviceCounters.read("block_mm") - dc == per_step


@pytest.mark.cuda
def test_block_mm_rim_proximal_kernels_match_plain(dev):
    """A proximal AMM-PGO# run (no TNT) on artifacts/rim_synth.g2o, 16
    nodes of 640 poses, float32, the shapes of the rim cells: 30 steps
    through K2 and K3 against the same run through the plain versions
    (per-step 2f within rtol 1e-4, as the slice's kernel test), with K3
    launched on every step and neither on the plain run nor in its exact
    global metrics (`_metrics`, the gradient's tangent projection)."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.ops import block_mm_cuda
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    meas = read_g2o_file(os.path.join(REPO, "artifacts", "rim_synth.g2o"))
    s = DPGOSolver(meas, num_nodes=16, dtype=torch.float32, device=dev,
                   opts=MMOptions(accelerated=True,
                                  tnt=TNTParams(max_iterations=0)))
    st0 = s.initialize()
    dc = DeviceCounters.read("block_mm")
    _, _, (f, _) = s.run_steps_history(st0, 0, 30)
    assert DeviceCounters.read("block_mm") - dc >= 30 * 10
    s.probs = dataclasses.replace(s.probs, kernels=False)
    s.syncs = HostSyncs()
    dc = DeviceCounters.read("block_mm")
    stp, _, (fp, _) = s.run_steps_history(st0, 0, 30)
    s._metrics(stp)
    assert DeviceCounters.read("block_mm") == dc
    f = f.cpu().numpy()
    assert np.isfinite(f).all() and f[-1] < f[0]
    np.testing.assert_allclose(f, fp.cpu().numpy(), rtol=1e-4)
