"""SE-Sync's staircase TNT and its LOBPCG certificate as captured
programs (sesync/staircase.py on a CUDA card), on the CPU in float64: the
graph route's code with graph_nodes.run_once on the "trace" route (every
branch and loop trip run, merged: what the captured program's conditional
nodes compute) against the host-read route, bit for bit, and against the
JAX package; min_eig_lobpcg's host route against the loop it replaced;
the Jacobi eigensolver and Gram-Schmidt QR (ops/linalg.py) the captured
programs use in place of cuSOLVER's."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph

# The trace route runs every trip up to the cap: LOBPCG's cap in the
# min_eig_lobpcg tests, and in the staircase's and certificate's (whose
# default is 20000); TNT's caps in the staircase (its default 200 outer x
# 250 CG; the explicit formulation takes 20 outer, under 50 CG each).
MAX_ITERS = 25
CERT_MAX_ITERS = 300
TNT = dict(max_iterations=25, max_iterations_accepted=25,
           max_tCG_iterations=50, gradient_tolerance=1e-6,
           preconditioned_gradient_tolerance=1e-8,
           relative_decrease_tolerance=1e-12, stepsize_tolerance=1e-8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@functools.lru_cache(maxsize=None)
def _graph(num_poses=30, seed=11):
    meas, _, _ = random_pose_graph(np.random.default_rng(seed),
                                   num_poses=num_poses, d=3,
                                   loop_closures=20, noise=0.05)
    return meas


def _opts():
    from dpgo_tpu_torch.sesync.staircase import SESyncOpts
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    return SESyncOpts(tnt=TNTParams(**TNT))


@functools.lru_cache(maxsize=None)
def _jax_sesync(formulation):
    """The JAX package's staircase with the same TNT caps."""
    from dpgo_tpu.sesync.staircase import SESyncOpts, sesync
    from dpgo_tpu.solvers.tnt import TNTParams
    return sesync(_graph(), SESyncOpts(tnt=TNTParams(**TNT)),
                  formulation=formulation)


def _trace_run_once(device, fn):
    """graph_nodes.run_once on the trace route: no capture."""
    from dpgo_tpu_torch.utils import route
    with route("trace"):
        out = fn()
    return out, types.SimpleNamespace(capture_s=0.0, warmup_s=0.0,
                                      pool_bytes=0, replay_s=lambda: 0.0)


@pytest.fixture
def traced(monkeypatch):
    """graph_nodes.run_once replaced by the trace route, and the
    staircase's and certificate's LOBPCG capped at CERT_MAX_ITERS trips."""
    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.sesync import staircase
    monkeypatch.setattr(graph_nodes, "run_once", _trace_run_once)
    monkeypatch.setattr(staircase, "min_eig_lobpcg", functools.partial(
        staircase.min_eig_lobpcg, max_iters=CERT_MAX_ITERS))


@pytest.fixture
def capturable_everywhere(monkeypatch):
    """The staircase and its LOBPCG on either route with ops/linalg.py's
    eigensolver and QR (as the card's graph route takes them)."""
    from dpgo_tpu_torch.sesync import staircase
    monkeypatch.setattr(staircase, "capturable", lambda graph, device: True)


def _lobpcg_before(apply_S, nd, seed, dtype, block=4, iters=200,
                   resid_tol=None, max_iters=20000, deflate=None,
                   precon=None, device=None, syncs=None):
    """min_eig_lobpcg as it was before its loop became a bounded_while (a
    host-read Python loop), kept here to pin the host route's bits."""
    from dpgo_tpu_torch.sesync.staircase import _normal
    from dpgo_tpu_torch.utils import HostSyncs, resolve_device

    syncs = syncs or HostSyncs()
    if device is None and isinstance(deflate, torch.Tensor):
        device = deflate.device
    device = resolve_device(device)

    def ortho(X):
        return torch.linalg.qr(X)[0]

    if deflate is not None:
        D = ortho(torch.as_tensor(deflate, dtype=dtype, device=device))

        def proj(X):
            return X - D @ (D.T @ X)
    else:
        def proj(X):
            return X

    X = ortho(proj(_normal(seed, (nd, block), dtype, device)))
    budget = iters if resid_tol is None else max_iters
    lock_tol = 0.0 if resid_tol is None else resid_tol
    drop_tol = float(torch.finfo(dtype).eps) ** 0.5

    SX = apply_S(X)
    P = torch.zeros_like(X)
    k = 0
    th = torch.zeros((), dtype=dtype, device=device)
    resid = torch.full((), float("inf"), dtype=dtype, device=device)
    while k < budget:
        if resid_tol is not None and k >= 2:
            # Stop once the SIGN question is resolved: theta is an upper
            # bound on the (restricted) lambda_min, so a clearly negative
            # theta is already a sound negative verdict; a positive theta
            # certifies once the residual is safely below it.
            unresolved = resid > torch.clamp(0.5 * th.abs(), min=resid_tol)
            if not syncs.flag(unresolved):
                break
        theta = torch.sum(X * SX, dim=0)
        Rres = SX - X * theta[None, :]
        resid_cols = torch.linalg.norm(Rres, dim=0)
        Rres = torch.where(resid_cols[None, :] <= lock_tol,
                           torch.zeros_like(Rres), Rres)
        if precon is not None:
            Rres = precon(Rres)
        Rres = proj(Rres)
        V = torch.cat([X, Rres, P], dim=1)
        Q, Rf = torch.linalg.qr(V)
        dR = torch.abs(torch.diagonal(Rf))
        good = dR > drop_tol * torch.max(dR)
        good[:block] = True
        SQ = apply_S(Q)
        H = Q.T @ SQ
        H = 0.5 * (H + H.T)
        gmask = good[:, None] & good[None, :]
        big = 1e12 * (1.0 + torch.max(torch.abs(H)))
        H = torch.where(gmask, H, torch.zeros_like(H)) \
            + torch.diag(torch.where(good, torch.zeros_like(dR), big))
        w, U = torch.linalg.eigh(H)
        U = U * good[:, None]
        Xn = proj(Q @ U[:, :block])
        SXn = SQ @ U[:, :block]
        P = proj(Xn - X @ (X.T @ Xn))
        X, SX = Xn, SXn
        th = w[0]
        resid = torch.linalg.norm(SX[:, 0] - th * X[:, 0])
        k += 1
    syncs.note("lobpcg", k)

    # Final pair from an EXACT operator application (the carried S X picks
    # up the drift re-projections): the residual feeds the certificate's
    # defensible bound.
    SX = apply_S(X)
    theta = torch.sum(X * SX, dim=0)
    i0 = torch.argmin(theta)
    v = X[:, i0]
    th = theta[i0]
    resid = torch.linalg.norm(SX[:, i0] - th * v)
    return th, v, resid


def _certificate_like(n=90, seed=42):
    """A symmetric matrix with a certificate's spectrum (an isolated 1e-3
    below a band 1 .. 1e3) and a 3-column block to deflate."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([[1e-3], np.geomspace(1.0, 1e3, n - 1)])
    return torch.as_tensor((Q * w[None, :]) @ Q.T), \
        torch.as_tensor(rng.normal(size=(n, 3)))


def _lobpcg_cases():
    """(name, S, keyword arguments) of min_eig_lobpcg: a fixed trip count
    on a random symmetric matrix; a residual tolerance on a certificate-like
    spectrum, deflated, plain and with the Chebyshev preconditioner."""
    from dpgo_tpu_torch.sesync.staircase import chebyshev_precon

    rng = np.random.default_rng(3)
    A = rng.normal(size=(60, 60))
    S0 = torch.as_tensor(0.5 * (A + A.T))
    S1, D = _certificate_like()
    pre = chebyshev_precon(lambda V: S1 @ V, lam_max=1.05e3, degree=6)
    return [("fixed", S0, dict(iters=MAX_ITERS)),
            ("tol_deflated", S1, dict(resid_tol=1e-6, max_iters=MAX_ITERS,
                                      deflate=D)),
            ("tol_chebyshev", S1, dict(resid_tol=1e-6, max_iters=MAX_ITERS,
                                       deflate=D, precon=pre))]


CASE_NAMES = ["fixed", "tol_deflated", "tol_chebyshev"]


def _case(name):
    return {c[0]: c[1:] for c in _lobpcg_cases()}[name]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_lobpcg_host_route_unchanged(name):
    """min_eig_lobpcg's host route (its loop now utils.bounded_while with
    the JAX package's cond and body) returns the same bits as the loop it
    replaced: theta, the vector and the residual, and notes the same
    trips."""
    from dpgo_tpu_torch.sesync.staircase import min_eig_lobpcg
    from dpgo_tpu_torch.utils import HostSyncs

    S, kw = _case(name)
    a_syncs, b_syncs = HostSyncs(), HostSyncs()
    old = _lobpcg_before(lambda V: S @ V, S.shape[0], 0, torch.float64,
                         device="cpu", syncs=a_syncs, **kw)
    new = min_eig_lobpcg(lambda V: S @ V, S.shape[0], 0, torch.float64,
                         device="cpu", syncs=b_syncs, **kw)
    for a, b in zip(old, new):
        assert torch.equal(a, b)
    assert a_syncs.loops == b_syncs.loops


@pytest.mark.parametrize("capturable", [False, True],
                         ids=["cusolver", "capturable"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_lobpcg_trace_route_equals_host_route(name, capturable, traced,
                                              request):
    """The graph route's LOBPCG (start, loop and final pair as one
    program; trace route in place of the capture) equals the host route
    bit for bit, with cuSOLVER's QR and eigh and with the Gram-Schmidt
    QR and Jacobi sweeps the card's captured program takes (ops/linalg.py),
    in the same trips (the device counter
    of the loop's trips equals the host route's note); it reads no flag on
    the host."""
    from dpgo_tpu_torch.sesync.staircase import min_eig_lobpcg
    from dpgo_tpu_torch.utils import DeviceCounters, HostSyncs

    if capturable:
        request.getfixturevalue("capturable_everywhere")
    S, kw = _case(name)
    out, syncs, trips = {}, {}, {}
    for graph in (False, True):
        syncs[graph] = HostSyncs()
        DeviceCounters.reset()
        stats = {}
        out[graph] = min_eig_lobpcg(
            lambda V: S @ V, S.shape[0], 0, torch.float64, device="cpu",
            syncs=syncs[graph], graph=graph, stats=stats,
            **kw)
        trips[graph] = (DeviceCounters.read("lobpcg.trips"),
                        stats["iterations"], stats["route"])
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    assert trips[False][:2] == trips[True][:2]
    assert (trips[False][2], trips[True][2]) == ("host", "graph")
    assert syncs[False].loops["lobpcg"] == [1, trips[False][0]]
    assert syncs[True].count == 0 < syncs[False].count


@pytest.mark.parametrize("capturable", [False, True],
                         ids=["cusolver", "capturable"])
def test_lobpcg_theta_matches_eigvalsh_and_jax(capturable, traced,
                                               request):
    """LOBPCG's smallest eigenvalue on the graph route's code within 1e-6
    of numpy.linalg.eigvalsh and of the JAX package's min_eig_lobpcg (150
    iterations on a random symmetric matrix, tests/test_sesync.py's case;
    500 deflated on the certificate-like spectrum, against the smallest
    eigenvalue on the complement of the deflated block)."""
    from dpgo_tpu.sesync.staircase import min_eig_lobpcg as jlobpcg

    from dpgo_tpu_torch.sesync.staircase import min_eig_lobpcg

    if capturable:
        request.getfixturevalue("capturable_everywhere")
    rng = np.random.default_rng(42)
    A = rng.normal(size=(60, 60))
    S = 0.5 * (A + A.T)
    th, _, _ = min_eig_lobpcg(lambda V: torch.as_tensor(S) @ V, 60, 0,
                              torch.float64, iters=150, device="cpu",
                              graph=True)
    jth, _, _ = jlobpcg(lambda V: jnp.asarray(S) @ V, 60,
                        jax.random.PRNGKey(0), jnp.float64, iters=150)
    want = np.linalg.eigvalsh(S)[0]
    assert abs(float(th) - want) <= 1e-6
    assert abs(float(th) - float(jth)) <= 1e-6

    S1, D = _certificate_like()
    th, _, _ = min_eig_lobpcg(lambda V: S1 @ V, 90, 0, torch.float64,
                              iters=500, deflate=D, device="cpu",
                              graph=True)
    Qd, _ = np.linalg.qr(D.numpy())
    P = np.eye(90) - Qd @ Qd.T
    restricted = np.linalg.eigvalsh(P @ S1.numpy() @ P + 1e6 * Qd @ Qd.T)
    jth, _, _ = jlobpcg(lambda V: jnp.asarray(S1.numpy()) @ V, 90,
                        jax.random.PRNGKey(0), jnp.float64, iters=500,
                        deflate=jnp.asarray(D.numpy()))
    assert abs(float(th) - restricted[0]) <= 1e-6
    assert abs(float(th) - float(jth)) <= 1e-6


def test_jacobi_eigh_matches_numpy():
    """ops/linalg.py's Jacobi sweeps against numpy.linalg.eigh: batched
    2 x 2, 3 x 3 (padded to 4) and 12 x 12, random, with clusters (G = I +
    small, as SE-Sync's Gram matrices near the manifold) and with
    LOBPCG's masked rows (a zero row and column and a 1e12 diagonal):
    eigenvalues within 1e-13 of the largest, V orthonormal and
    V diag(w) V^T = A to 1e-13, ascending order."""
    from dpgo_tpu_torch.ops.linalg import jacobi_eigh

    rng = np.random.default_rng(0)
    mats = []
    for n in (2, 3, 12):
        B = rng.normal(size=(16, n, n))
        mats.append(B + B.transpose(0, 2, 1))
        C = 1e-9 * rng.normal(size=(16, n, n))
        mats.append(np.eye(n) + C + C.transpose(0, 2, 1))
    M = mats[-2].copy()
    M[:, 9:, :] = 0.0
    M[:, :, 9:] = 0.0
    M[:, 9:, 9:] = 1e12 * np.eye(3)
    mats.append(M)
    for A in mats:
        w, V = jacobi_eigh(torch.as_tensor(A))
        w, V = w.numpy(), V.numpy()
        scale = np.abs(A).max()
        np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=0,
                                   atol=1e-13 * scale)
        n = A.shape[-1]
        np.testing.assert_allclose(V.transpose(0, 2, 1) @ V,
                                   np.broadcast_to(np.eye(n), V.shape),
                                   atol=1e-13)
        np.testing.assert_allclose((V * w[:, None, :]) @ V.transpose(0, 2, 1),
                                   A, atol=1e-13 * scale)
        assert (np.diff(w, axis=-1) >= 0).all()


def test_gram_schmidt_qr_matches_householder():
    """ops/linalg.py's CGS2 QR against torch.linalg.qr (Householder) on a
    tall [300, 12] basis shaped as LOBPCG's [X, R, P] (X orthonormal,
    columns of very different norms): |diag R| within 1e-12 of the largest,
    Q orthonormal and Q R = V to 1e-13; with a zero block (P at the first
    iteration) and a repeated column, the columns without content of
    their own get zero columns in Q and a diagonal below sqrt(eps) of the
    largest (LOBPCG's truncation masks them), and nothing is NaN."""
    from dpgo_tpu_torch.ops.linalg import gram_schmidt_qr

    rng = np.random.default_rng(5)
    X, _ = np.linalg.qr(rng.normal(size=(300, 4)))
    V = np.concatenate([X, 1e-3 * rng.normal(size=(300, 4)),
                        1e2 * rng.normal(size=(300, 4))], axis=1)
    V = torch.as_tensor(V)
    Q, R = gram_schmidt_qr(V)
    _, Rh = torch.linalg.qr(V)
    scale = float(R.diagonal().abs().max())
    np.testing.assert_allclose(R.diagonal().numpy(),
                               Rh.diagonal().abs().numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(12), atol=1e-13)
    np.testing.assert_allclose((Q @ R).numpy(), V.numpy(), rtol=0,
                               atol=1e-13 * scale)
    W = V.clone()
    W[:, 8:] = 0.0
    W[:, 7] = W[:, 1]
    Q, R = gram_schmidt_qr(W)
    assert bool(torch.isfinite(Q).all() and torch.isfinite(R).all())
    d = R.diagonal()
    dead = [7, 8, 9, 10, 11]
    assert bool((d[dead] <= 1.5e-8 * d.max()).all())
    assert float(Q[:, dead].abs().max()) == 0.0
    live = [0, 1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose((Q[:, live].T @ Q[:, live]).numpy(),
                               np.eye(7), atol=1e-13)


def test_project_blocks_jacobi_matches_eigh():
    """SESyncProblem.project_blocks with Jacobi sweeps (the captured
    staircase on a card) equals the torch.linalg.eigh one within 1e-13,
    at r = 3 and r = 5."""
    from dpgo_tpu_torch.sesync.problem import build_sesync_problem

    prob = build_sesync_problem(_torch_meas(_graph()), device="cpu")
    jprob = dataclasses.replace(prob, capturable=True)
    rng = np.random.default_rng(1)
    for r in (3, 5):
        A = torch.as_tensor(rng.normal(size=(prob.n * 3, r)))
        np.testing.assert_allclose(jprob.project_blocks(A).numpy(),
                                   prob.project_blocks(A).numpy(), rtol=0,
                                   atol=1e-13)


def _sesync_routes(formulation):
    """sesync on the host-read route and on the graph route's code (trace
    route in place of the captures): the results and stats."""
    from dpgo_tpu_torch.sesync.staircase import sesync

    out = {}
    for graph in (False, True):
        stats = {}
        res = sesync(_torch_meas(_graph()), _opts(),
                     formulation=formulation, device="cpu", graph=graph,
                     stats=stats)
        out[graph] = (res, stats)
    return out


def _same_result(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert x == y or (x != x and y != y), f.name


FORMULATIONS = ["simplified", "sosync", "explicit"]


@pytest.mark.parametrize("capturable", [False, True],
                         ids=["cusolver", "capturable"])
@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_sesync_trace_route_equals_host_route(formulation, capturable,
                                              traced, request):
    """The staircase with each rank's TNT (and, for sosync, the LOBPCG
    certificate) on the graph route's code equals the host-read route bit
    for bit: status, rank, rotations, translations, SDP and rounded values,
    lambda_min and bound; the same TNT outer iterations per rank; no host
    flag read in the TNTs (the host route reads one per trip). With
    `capturable` both routes take ops/linalg.py's eigensolver and QR, as
    the card's captured programs do (project_blocks, LOBPCG)."""
    if capturable:
        request.getfixturevalue("capturable_everywhere")
    out = _sesync_routes(formulation)
    (hres, hst), (tres, tst) = out[False], out[True]
    _same_result(hres, tres)
    assert (hst["route"], tst["route"]) == ("host", "graph")
    assert [r["outer"] for r in hst["ranks"]] == \
        [r["outer"] for r in tst["ranks"]]
    assert all(r["tnt_host_syncs"] > 0 for r in hst["ranks"])
    assert all(r["tnt_host_syncs"] == 0 for r in tst["ranks"])
    if formulation == "sosync":
        assert [s["route"] for s in tst["lobpcg"]] == ["graph"]
        assert tst["lobpcg"][0]["iterations"] == \
            hst["lobpcg"][0]["iterations"]


@pytest.mark.parametrize("capturable", [False, True],
                         ids=["cusolver", "capturable"])
@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_sesync_trace_route_matches_jax(formulation, capturable, traced,
                                        request):
    """The graph route's staircase against the JAX package's sesync: the
    same status and rank, fxhat and sdp_val within 1e-9 (relative), the
    rounded rotations within 1e-6 up to the global gauge."""
    from dpgo_tpu_torch.sesync.staircase import sesync

    if capturable:
        request.getfixturevalue("capturable_everywhere")
    jr = _jax_sesync(formulation)
    tr = sesync(_torch_meas(_graph()), _opts(), formulation=formulation,
                device="cpu", graph=True)
    assert (tr.status, tr.rank) == (jr.status, jr.rank)
    np.testing.assert_allclose(tr.fxhat, jr.fxhat, rtol=1e-9)
    np.testing.assert_allclose(tr.sdp_val, jr.sdp_val, rtol=1e-9)
    g = np.einsum("ba,nbc->nac", tr.R[0], tr.R)
    jg = np.einsum("ba,nbc->nac", jr.R[0], jr.R)
    np.testing.assert_allclose(g, jg, atol=1e-6)


@pytest.mark.parametrize("precon", ["auto", "chebyshev"])
def test_certify_lobpcg_graph_route_matches_jax(precon, traced):
    """certify_solution(method="lobpcg") with the LOBPCG on the graph
    route's code: certified on the staircase's optimum and rejected on the
    negative control (poses 10-19 turned 0.5 rad), as the JAX package
    decides, lambda_min within 1e-6 of the host route's and of JAX's on
    the optimum (below -1e-2 on the control); the applications of S
    counted on the device; no flag read on the host in the LOBPCG."""
    from dpgo_tpu.sesync.staircase import certify_solution as jcertify

    from dpgo_tpu_torch.sesync.staircase import certify_solution

    meas = _graph()
    R = _jax_sesync("simplified").R
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    Rbad = R.copy()
    Rbad[10:20] = turn @ Rbad[10:20]
    for cand, want in ((R, True), (Rbad, False)):
        jok, jlam, _, _ = jcertify(meas, cand, method="lobpcg",
                                   precon=precon)
        res = {}
        for graph in (False, True):
            stats = {}
            res[graph] = certify_solution(
                _torch_meas(meas), cand, method="lobpcg", precon=precon,
                device="cpu", graph=graph, stats=stats) + (stats,)
        (hok, hlam, _, _, hst), (tok, tlam, _, _, tst) = res[False], \
            res[True]
        assert tok == hok == jok == want
        assert tst["lobpcg"]["route"] == "graph"
        assert hst["lobpcg"]["route"] == "host"
        assert tst["apply_S_calls"] == hst["apply_S_calls"] > 0
        assert tst["loops"].get("lobpcg") is None
        assert hst["loops"]["lobpcg"][1] == tst["lobpcg"]["iterations"]
        if want:
            assert abs(tlam - hlam) <= 1e-6 and abs(tlam - jlam) <= 1e-6
        else:
            assert tlam < -1e-2 and jlam < -1e-2


def test_graph_route_is_chosen_up_front():
    """graph_route: by default the captured route on a CUDA card where the
    operator has no host piece, the host-read route on the CPU and above
    the dense limit; asking for the captured route with a host piece (the
    SuperLU reduced-Laplacian solve) raises instead of falling back (a
    30-pose problem built with dense_limit=10 has the host piece)."""
    from dpgo_tpu_torch.sesync import staircase
    from dpgo_tpu_torch.sesync.problem import build_sesync_problem

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert staircase.graph_route(None, cuda, False) is True
    assert staircase.graph_route(None, cuda, True) is False
    assert staircase.graph_route(None, cpu, False) is False
    assert staircase.graph_route(False, cuda, False) is False
    assert staircase.graph_route(True, cpu, False) is True
    with pytest.raises(ValueError, match="host round trip"):
        staircase.graph_route(True, cuda, True)
    prob = build_sesync_problem(_torch_meas(_graph()), dense_limit=10,
                                device="cpu")
    assert prob.lred_host is not None
    with pytest.raises(ValueError, match="graph=False"):
        staircase.graph_route(True, cpu, prob.lred_host is not None)
