"""dpgo_tpu_torch modules against the JAX package, on the CPU.

Inputs come from numpy seeds (tests/synthetic.py), go through the JAX
function and its port, and are compared with the tolerance stated in each
test. The kernels' CUDA paths run only on a card (marked `cuda`); here their
wrappers take the plain torch versions, because the tensors lie on the CPU.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


def _problem_arrays(probs) -> dict:
    return {f.name: getattr(probs, f.name) for f in dataclasses.fields(probs)}


def _state_arrays(st) -> dict:
    out = {}
    for name, v in st._asdict().items():
        out[name] = ({f.name: np.asarray(getattr(v, f.name))
                      for f in dataclasses.fields(v)}
                     if dataclasses.is_dataclass(v) else np.asarray(v))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(d):
    """The JAX solver (f64, 40 poses, 2 nodes) after 3 AMM steps."""
    from dpgo_tpu.driver import DPGOSolver
    from dpgo_tpu.solvers.mm import MMOptions

    rng = np.random.default_rng(42)
    meas, _, _ = random_pose_graph(rng, num_poses=40, d=d, loop_closures=30,
                                   noise=0.05)
    s = DPGOSolver(meas, num_nodes=2, opts=MMOptions(accelerated=True),
                   dtype=jnp.float64)
    st = s.initialize()
    st, _ = s.run_steps(st, jnp.zeros((), jnp.int32), 3)
    return meas, s, st


@pytest.fixture(scope="module")
def jax_run():
    """The d = 3 run."""
    return _jax_run(3)


# ------------------------------------------------------------------ K2


def test_polar_so3_twin_matches_jax(rng):
    """K2's plain version vs the Pallas kernel (interpret mode) and
    ops/so3.py on 700 f64 matrices with det < 0 mixed in; atol 1e-12 as in
    tests/test_aux.py::test_pallas_so3_interpret."""
    from dpgo_tpu.ops.pallas_so3 import polar_so3_pallas
    from dpgo_tpu.ops.so3 import polar_so3 as polar_jax

    from dpgo_tpu_torch.ops.so3 import polar_so3

    A = rng.normal(size=(700, 3, 3))
    A[::5, :, 1] *= -1  # mix in det < 0
    A[3] = 0.0          # a zero matrix maps to the identity
    R = polar_so3(torch.tensor(A)).numpy()
    np.testing.assert_allclose(R, np.asarray(polar_jax(jnp.asarray(A))),
                               atol=1e-12)
    np.testing.assert_allclose(
        R, np.asarray(polar_so3_pallas(jnp.asarray(A), interpret=True)),
        atol=1e-12)
    np.testing.assert_allclose(R[3], np.eye(3), atol=0)


def test_polar_so3_wrapper_dispatch(rng):
    """A CPU tensor takes the plain version (bit-equal, no launch counted);
    a tensor on another device raises instead of falling back."""
    from dpgo_tpu_torch.manifold import project_sod
    from dpgo_tpu_torch.ops import polar_so3_cuda as k2
    from dpgo_tpu_torch.ops.so3 import polar_so3

    A = torch.tensor(rng.normal(size=(4, 5, 3, 3)), dtype=torch.float32)
    before = k2.Launches.count
    R = k2.polar_so3_cuda(A.reshape(-1, 3, 3))
    assert torch.equal(R, polar_so3(A.reshape(-1, 3, 3)))
    assert torch.equal(project_sod(A), R.reshape(4, 5, 3, 3))
    assert torch.equal(project_sod(A, kernel=False), R.reshape(4, 5, 3, 3))
    assert k2.Launches.count == before
    with pytest.raises(ValueError):
        k2.polar_so3_cuda(torch.empty((2, 3, 3), device="meta"))


def test_manifold_matches_jax(rng):
    """project_so2, proj_tangent, sym_block_diag_product vs the JAX package
    (f64, atol 1e-13)."""
    from dpgo_tpu import manifold as jm

    from dpgo_tpu_torch import manifold as tm

    A2 = rng.normal(size=(30, 2, 2))
    np.testing.assert_allclose(tm.project_so2(torch.tensor(A2)).numpy(),
                               np.asarray(jm.project_so2(jnp.asarray(A2))),
                               atol=1e-13)
    R = np.asarray(jm.project_sod(jnp.asarray(rng.normal(size=(30, 3, 3)))))
    V = rng.normal(size=(30, 3, 3))
    np.testing.assert_allclose(
        tm.proj_tangent(torch.tensor(R), torch.tensor(V)).numpy(),
        np.asarray(jm.proj_tangent(jnp.asarray(R), jnp.asarray(V))),
        atol=1e-13)
    np.testing.assert_allclose(
        tm.project_sod(torch.tensor(V)).numpy(),
        np.asarray(jm.project_sod(jnp.asarray(V))), atol=1e-12)


@pytest.mark.parametrize("kind", ["trivial", "huber", "geman_mcclure",
                                  "welsch"])
def test_losses_match_jax(rng, kind):
    """loss_value and loss_weight of every kernel (f64, rtol 1e-14)."""
    from dpgo_tpu import losses as jl

    from dpgo_tpu_torch import losses as tl

    s = rng.uniform(0.0, 3.0, size=200)
    for fn in ("loss_value", "loss_weight"):
        ref = np.asarray(getattr(jl, fn)(jl.Loss(kind), jnp.asarray(s), 0.25))
        out = getattr(tl, fn)(tl.Loss(kind), torch.tensor(s), 0.25).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-15)


# ------------------------------------------------------------------ K1


def _tnt_entry(s, st, dtype):
    """Node 0's TNT-entry quantities (as tests/test_pallas_stpcg.py builds
    them) in the given JAX dtype."""
    p = jax.tree.map(lambda x: x[0], s.probs)
    pf = jax.tree.map(lambda x: jnp.asarray(x, dtype)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x, p)
    t0 = jnp.asarray(st.Z.t[0], dtype)
    Q = jnp.asarray(p.to_tall(st.Z.R[0]), dtype)
    gQ = jnp.asarray(p.to_tall(st.g_R[0]), dtype)
    nabla = pf.reduced_grad_tall(t0, Q, gQ)
    grad = pf.proj_tall(Q, nabla)
    pgrad = pf.precondition_tall(Q, grad)
    n = Q.shape[0] // p.d
    Sb = jnp.einsum("nar,nbr->nab", Q.reshape(n, p.d, p.d),
                    nabla.reshape(n, p.d, p.d))
    Sb = 0.5 * (Sb + jnp.swapaxes(Sb, -1, -2))
    return p, pf, Q, nabla, grad, pgrad, Sb


def _t(x, dtype):
    return torch.tensor(np.asarray(x), dtype=dtype)[None]


@pytest.mark.parametrize("d", [3, 2])
def test_stpcg_twin_matches_pallas_kernel(d):
    """K1's plain version vs the JAX package's fused STPCG Pallas kernel
    (interpret mode, f32, panels via block_panels) on the inputs of
    tests/test_pallas_stpcg.py: same k; h within rtol 2e-4 / atol 2e-5,
    Hh within rtol 2e-3 / atol 2e-4, |h|_M within rtol 1e-4 (that test's
    tolerances); an inactive lane gives a zero step with k = 0. For SE(3)
    and SE(2) graphs (the kernel's two instantiations)."""
    from dpgo_tpu.ops import pallas_stpcg as pk
    from dpgo_tpu.solvers.tnt import TNTParams

    from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused

    _, s, st = _jax_run(d)
    f32 = jnp.float32
    p, pf, Q, nabla, grad, pgrad, Sb = _tnt_entry(s, st, f32)
    assert p.d == d
    n = p.pose_mask.shape[0]
    n_pad = max(-(-n // pk.LANE) * pk.LANE, pk.LANE)
    Hpan = jnp.asarray(pk.block_panels(np.asarray(p.Hred_d, np.float64), d,
                                       n_pad), f32)
    Ppan = jnp.asarray(pk.block_panels(np.asarray(p.precon_dense,
                                                  np.float64), d, n_pad), f32)
    params = TNTParams()
    kw = dict(max_iters=params.max_tCG_iterations,
              kappa_fgr=params.kappa_fgr, theta=params.theta)
    tf = torch.float32
    args = (_t(p.Hred_d, tf), _t(p.precon_dense, tf), _t(grad, tf),
            _t(pgrad, tf), _t(Q, tf), _t(Sb.reshape(n * d, d), tf))
    for Delta in (1.0, 0.02):
        h_ref, Hh_ref, nrm_ref, k_ref = pk.stpcg_fused(
            Hpan, Ppan, grad, pgrad, Q, Sb, jnp.asarray(Delta, f32),
            jnp.asarray(True), **kw)
        h, Hh, nrm, k = stpcg_fused(*args, torch.tensor([Delta], dtype=tf),
                                    torch.tensor([True]), **kw)
        assert int(k[0]) == int(k_ref), (Delta, int(k[0]), int(k_ref))
        np.testing.assert_allclose(h[0].numpy(), np.asarray(h_ref),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(Hh[0].numpy(), np.asarray(Hh_ref),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(float(nrm[0]), float(nrm_ref), rtol=1e-4)

    h, Hh, nrm, k = stpcg_fused(*args, torch.tensor([1.0], dtype=tf),
                                torch.tensor([False]), **kw)
    assert int(k[0]) == 0
    np.testing.assert_allclose(h.numpy(), 0.0)


def test_stpcg_twin_matches_tnt_stpcg_f64(jax_run):
    """K1's plain version vs solvers/tnt.py::stpcg on the same problem in
    f64 (rtol 1e-10), batched with a second, inactive lane."""
    from dpgo_tpu.solvers.tnt import TNTParams, stpcg

    from dpgo_tpu_torch.ops.stpcg import (stpcg_dense_reference,
                                          stpcg_target)

    _, s, st = jax_run
    f64 = jnp.float64
    p, pf, Q, nabla, grad, pgrad, Sb = _tnt_entry(s, st, f64)
    n, d = p.pose_mask.shape[0], p.d
    params = TNTParams()
    td = torch.float64

    def two(x):  # lane 0 and a copy in lane 1
        x = _t(x, td)
        return torch.cat([x, x])

    H, P, g, v0, Qt = (two(p.Hred_d), two(p.precon_dense), two(grad),
                       two(pgrad), two(Q))
    S = two(Sb.reshape(n * d, d))
    target = stpcg_target(g, v0, params.kappa_fgr, params.theta)
    for Delta in (1.0, 0.02):
        h_ref, Hh_ref, nrm_ref, k_ref = stpcg(
            grad, lambda v: pf.hessian_vp_tall(Q, nabla, v),
            lambda v: pf.precondition_tall(Q, v), jnp.asarray(Delta, f64),
            params, v0=pgrad)
        h, Hh, nrm, k = stpcg_dense_reference(
            H, P, g, v0, Qt, S, torch.full((2,), Delta, dtype=td),
            torch.tensor([True, False]), target, params.max_tCG_iterations)
        assert int(k[0]) == int(k_ref) and int(k[1]) == 0
        np.testing.assert_allclose(h[0].numpy(), np.asarray(h_ref),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(Hh[0].numpy(), np.asarray(Hh_ref),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(nrm[0]), float(nrm_ref),
                                   rtol=1e-10)
        assert float(h[1].abs().max()) == 0.0


def test_stpcg_wrapper_raises_off_cpu():
    """The K1 wrapper never falls back: a tensor on a device other than
    the CPU or a CUDA card raises."""
    from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused

    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        stpcg_fused(m(1, 6, 6), m(1, 6, 6), m(1, 6, 3), m(1, 6, 3),
                    m(1, 6, 3), m(1, 6, 3), m(1), m(1).bool(), max_iters=5,
                    kappa_fgr=0.05, theta=0.9)


def _meta_stpcg_args(N=2, n=5, d=3):
    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    nd = n * d
    return dict(H=m(N, nd, nd), P=m(N, nd, nd), g=m(N, nd, d),
                v0=m(N, nd, d), Q=m(N, nd, d), S=m(N, nd, d), Delta=m(N),
                active=m(N).bool())


@pytest.mark.parametrize("case,exc,match", [
    ("valid", ValueError, "unsupported device"),
    ("valid_d2", ValueError, "unsupported device"),
    ("cluster8_of_5_poses", ValueError, "cluster 8"),
    ("cluster3", ValueError, "cluster 3"),
    ("d4", ValueError, "d in"),
    ("H_shape", ValueError, "H has shape"),
    ("S_float64", TypeError, "S is torch.float64"),
    ("active_float", TypeError, "active is torch.float32"),
    ("Delta_shape", ValueError, "Delta has shape"),
    ("Q_strided", ValueError, "Q must be contiguous"),
    ("P_on_cpu", ValueError, "P on cpu"),
])
def test_stpcg_wrapper_argument_checks(case, exc, match):
    """K1's wrapper checks its arguments (d, shapes, float32 operators and
    vectors, a bool `active`, contiguity, the cluster size: one of 1, 2, 4,
    8 and at most the pose count) before anything reaches a device, on meta
    tensors; with valid arguments a meta tensor still raises rather than
    taking the plain version."""
    from dpgo_tpu_torch.ops.stpcg_cuda import stpcg_fused

    kw = _meta_stpcg_args(d=2 if case == "valid_d2" else 3)
    cluster = None
    if case == "cluster8_of_5_poses":
        cluster = 8
    elif case == "cluster3":
        cluster = 3
    elif case == "d4":
        kw = _meta_stpcg_args(d=4)
    elif case == "H_shape":
        kw["H"] = torch.empty((2, 15, 14), device="meta")
    elif case == "S_float64":
        kw["S"] = kw["S"].double()
    elif case == "active_float":
        kw["active"] = kw["active"].float()
    elif case == "Delta_shape":
        kw["Delta"] = torch.empty((3,), device="meta")
    elif case == "Q_strided":
        kw["Q"] = torch.empty((2, 3, 15), device="meta").transpose(1, 2)
    elif case == "P_on_cpu":
        kw["P"] = torch.empty(kw["P"].shape)
    with pytest.raises(exc, match=match):
        stpcg_fused(*kw.values(), max_iters=5, kappa_fgr=0.05, theta=0.9,
                    cluster=cluster)


@pytest.mark.parametrize("N,npose,resident,expect", [
    # rim: 16 nodes of 640 poses; 16 clusters of 8 fit -> 8.
    (16, 640, {1: 132, 2: 66, 4: 32, 8: 16}, 8),
    # A GPC layout that holds only 14 clusters of 8 -> 4.
    (16, 640, {1: 132, 2: 66, 4: 32, 8: 14}, 4),
    # Fewer poses than CTAs: C never exceeds the pose count.
    (16, 3, {1: 132, 2: 66, 4: 32, 8: 16}, 2),
    (4, 1, {1: 132, 2: 66, 4: 32, 8: 16}, 1),
    # More nodes than any size holds at once -> 1 (waves).
    (200, 640, {1: 132, 2: 66, 4: 32, 8: 16}, 1),
    (60, 640, {1: 132, 2: 66, 4: 32, 8: 16}, 2),
    # A CTA of one per node exceeds shared memory: the smallest that fits.
    (200, 1365, {1: 0, 2: 66, 4: 32, 8: 16}, 2),
    (16, 1365, {1: 0, 2: 66, 4: 32, 8: 16}, 8),
])
def test_choose_cluster_size(N, npose, resident, expect):
    """The wrapper's cluster size: the largest C in {1, 2, 4, 8} with which
    all N clusters are resident at once and C <= npose; 1 (or the smallest
    that fits) when none is."""
    from dpgo_tpu_torch.ops.stpcg_cuda import choose_cluster_size

    assert choose_cluster_size(N, npose, resident) == expect


def test_choose_cluster_size_raises_when_nothing_fits():
    from dpgo_tpu_torch.ops.stpcg_cuda import choose_cluster_size

    with pytest.raises(ValueError, match="no cluster size"):
        choose_cluster_size(16, 640, {1: 0, 2: 0, 4: 0, 8: 0})


@pytest.mark.parametrize("entry", ["DPGOSolver", "build_node_problems",
                                   "EdgeData.from_measurements",
                                   "build_sesync_problem", "min_eig_lobpcg"])
def test_entry_points_default_to_the_card(entry):
    """DPGOSolver, build_node_problems, EdgeData.from_measurements,
    build_sesync_problem and min_eig_lobpcg (without a tensor `deflate`)
    without `device` build on the CUDA card; on a host without one they
    raise instead of building on the CPU."""
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.objective import EdgeData
    from dpgo_tpu_torch.problem import build_node_problems
    from dpgo_tpu_torch.sesync.problem import build_sesync_problem
    from dpgo_tpu_torch.sesync.staircase import min_eig_lobpcg

    meas = _torch_meas(random_pose_graph(np.random.default_rng(1),
                                         num_poses=12, d=3,
                                         loop_closures=4)[0])

    def build():
        """A tensor of what the entry point built."""
        if entry == "DPGOSolver":
            return DPGOSolver(meas, num_nodes=2).probs.Hred_d
        if entry == "EdgeData.from_measurements":
            return EdgeData.from_measurements(meas).tau
        if entry == "build_sesync_problem":
            return build_sesync_problem(meas).tau
        if entry == "min_eig_lobpcg":
            return min_eig_lobpcg(lambda V: 2.0 * V, 8, 0, torch.float64,
                                  iters=2)[1]
        return build_node_problems(build_multigraph(meas, 2)[2]).Hred_d

    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the kernel build raises (no silent
    fallback)."""
    from dpgo_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc; the build would run")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "LIB_PATH",
                        os.path.join(REPO, "build", "dpgo_tpu_torch",
                                     "absent", "lib.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


# ------------------------------------------------------------- problem


@pytest.mark.parametrize("d", [3, 2])
def test_g2o_reader_matches_jax(tmp_path, d):
    """A graph written as EDGE_SE2 / EDGE_SE3:QUAT text reads back through
    the port's io/g2o.py exactly as through the JAX package's reader."""
    from dpgo_tpu.io.g2o import read_g2o_file as jax_read

    from dpgo_tpu_torch.io.g2o import read_g2o_file, write_g2o_file

    meas, t, R = random_pose_graph(np.random.default_rng(5), num_poses=20,
                                   d=d, loop_closures=10)
    path = str(tmp_path / "graph.g2o")
    write_g2o_file(path, t, R, _torch_meas(meas))
    ours, ref = read_g2o_file(path), jax_read(path)
    assert (ours.d, ours.num_poses) == (ref.d, ref.num_poses) == (d, 20)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(np.asarray(getattr(ours, f.name)),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("d", [3, 2])
def test_dense_problem_arrays_match_jax(d):
    """build_node_problems' dense arrays equal the JAX package's to 1e-12
    (f64; the host numpy build is the same code), for SE(3) and SE(2)
    graphs; the dynamic-rescale selectors are equal."""
    from dpgo_tpu_torch.graph import build_multigraph
    from dpgo_tpu_torch.problem import build_node_problems

    meas, s, _ = _jax_run(d)
    _, _, mg = build_multigraph(_torch_meas(meas), 2)
    tp = build_node_problems(mg, xi=1e-11, precon_cond=1e6, device="cpu")
    assert tp.d == d
    for name in ("ipose", "imask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(s.probs, name)),
                                      err_msg=name)
    for name in ("Minv_red", "Hred_d", "precon_dense", "mG01_d", "mG11_d",
                 "mG00_d", "W", "nvec", "diagT_inv", "null_V", "SU",
                 "scale_w", "wood_C"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(s.probs, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_problem_ops_match_jax_on_converted_state(jax_run, rng):
    """evaluate_f, grad_norm, proximal, recover_translations(_tall) and
    evaluate_G_tall_rel against the JAX package on one state carried across
    with convert.py (f64, rtol 1e-11)."""
    from dpgo_tpu import objective as jo

    from dpgo_tpu_torch import objective as to
    from dpgo_tpu_torch.convert import problem_from_numpy, state_from_numpy

    meas, s, st = jax_run
    tp = problem_from_numpy(_problem_arrays(s.probs), device="cpu")
    ts = state_from_numpy(_state_arrays(st), device="cpu")
    tol = dict(rtol=1e-11, atol=1e-12)

    t, R = s.gather_global(st)
    edges = to.EdgeData.from_measurements(_torch_meas(meas),
                                          node_of=s.part.node_of,
                                          device="cpu")
    tt, tR = torch.tensor(np.asarray(t)), torch.tensor(np.asarray(R))
    np.testing.assert_allclose(float(to.evaluate_f(edges, tt, tR)),
                               float(jo.evaluate_f(s.edges, t, R)), **tol)
    np.testing.assert_allclose(float(to.grad_norm(edges, tt, tR)),
                               float(jo.grad_norm(s.edges, t, R)), **tol)

    jp = jax.vmap(lambda p, z, dt, dR: p.proximal(z, (dt, dR)))(
        s.probs, st.Z, st.Df_t, st.Df_R)
    pt, pR = tp.proximal(ts.Z, (ts.Df_t, ts.Df_R))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jp[0]), **tol)
    np.testing.assert_allclose(pR.numpy(), np.asarray(jp[1]), **tol)

    jt = jax.vmap(lambda p, R_, gt, ta: p.recover_translations(R_, gt, ta))(
        s.probs, jp[1], st.g_t, st.Z.t)
    np.testing.assert_allclose(
        tp.recover_translations(pR, ts.g_t, ts.Z.t).numpy(),
        np.asarray(jt), **tol)
    jtt = jax.vmap(lambda p, R_, gt, ta: p.recover_translations_tall(
        p.to_tall(R_), gt, ta))(s.probs, jp[1], st.g_t, st.Z.t)
    np.testing.assert_allclose(
        tp.recover_translations_tall(tp.to_tall(pR), ts.g_t, ts.Z.t).numpy(),
        np.asarray(jtt), **tol)

    # A perturbed candidate around the anchor.
    dt_ = 1e-2 * rng.normal(size=np.asarray(st.Z.t).shape)
    xt = np.asarray(st.Z.t) + dt_
    xR = np.asarray(jp[1])
    jG = jax.vmap(lambda p, x_t, x_R, zt, zR, gt, gR, fo:
                  p.evaluate_G_tall_rel(x_t, p.to_tall(x_R), zt,
                                        p.to_tall(zR), gt, p.to_tall(gR),
                                        fo))(
        s.probs, jnp.asarray(xt), jnp.asarray(xR), st.Z.t, st.Z.R, st.g_t,
        st.g_R, st.fobj)
    tG = tp.evaluate_G_tall_rel(torch.tensor(xt), tp.to_tall(torch.tensor(xR)),
                                ts.Z.t, tp.to_tall(ts.Z.R), ts.g_t,
                                tp.to_tall(ts.g_R), ts.fobj)
    np.testing.assert_allclose(tG.numpy(), np.asarray(jG), **tol)
    jGr = jax.vmap(lambda p, x_t, x_R, zt, zR, gt, gR, fo:
                   p.evaluate_G_rel(zt, zR, x_t, x_R, (gt, gR), fo))(
        s.probs, jnp.asarray(xt), jnp.asarray(xR), st.Z.t, st.Z.R, st.g_t,
        st.g_R, st.fobj)
    zres = tp.anchor_residuals(ts.Z.t, ts.Z.R)
    tGr = tp.evaluate_G_rel(ts.Z.t, ts.Z.R, torch.tensor(xt),
                            torch.tensor(xR), (ts.g_t, ts.g_R), ts.fobj, zres)
    np.testing.assert_allclose(tGr.numpy(), np.asarray(jGr), **tol)
    # The pair form (candidates sharing rotations) equals two single ones.
    pair = tp.evaluate_G_rel_pair(ts.Z.t, ts.Z.R, torch.tensor(xt), pt, pR,
                                  (ts.g_t, ts.g_R), ts.fobj, zres)
    for t_, G in zip((torch.tensor(xt), pt), pair):
        np.testing.assert_allclose(
            G.numpy(), tp.evaluate_G_rel(ts.Z.t, ts.Z.R, t_, pR,
                                         (ts.g_t, ts.g_R), ts.fobj,
                                         zres).numpy(), **tol)


# ------------------------------------------------------------- imports


def test_port_imports_no_jax():
    """Every dpgo_tpu_torch module imports without jax or dpgo_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dpgo_tpu_torch\n"
        "for m in pkgutil.walk_packages(dpgo_tpu_torch.__path__,\n"
        "                               'dpgo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dpgo_tpu' or m.startswith('dpgo_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('dpgo_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
