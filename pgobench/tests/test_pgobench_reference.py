"""The plain float64 reference: zero on a noise-free graph, a hand-worked
two-pose case, and the port's own oracle on a small graph (same
convention, so the program's objective can be held to it)."""

import numpy as np

from pgobench.gen import rim
from pgobench.reference import pgo


def test_zero_on_a_noise_free_graph():
    g = rim.graph(3, floors=2, rows=4, cols=16, rot_noise=0.05,
                  trans_noise=0.1)
    # The measurements the ground truth makes exactly.
    Rt, tt = g["R_true"], g["t_true"]
    Ri_T = np.swapaxes(Rt[g["i"]], 1, 2)
    g["R"] = Ri_T @ Rt[g["j"]]
    g["t"] = np.einsum("mab,mb->ma", Ri_T, tt[g["j"]] - tt[g["i"]])
    assert pgo.objective(g, g["t_true"], g["R_true"]) < 1e-20
    assert pgo.grad_norm(g, g["t_true"], g["R_true"]) < 1e-9


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_two_poses_by_hand():
    # One edge 0 -> 1 measuring t~ = (1, 0, 0), R~ = I; poses t0 = 0,
    # R0 = I, t1 = (2, 0, 0), R1 = Rz(a).
    a, tau, kappa = 0.3, 4.0, 5.0
    g = {"i": np.array([0]), "j": np.array([1]), "R": np.eye(3)[None],
         "t": np.array([[1.0, 0.0, 0.0]]), "tau": np.array([tau]),
         "kappa": np.array([kappa]), "num_poses": 2, "d": 3}
    t = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    R = np.stack([np.eye(3), rot_z(a)])
    # r_t = t0 + R0 t~ - t1 = (-1, 0, 0); |I - Rz(a)|_F^2 = 4 (1 - cos a).
    f = 0.5 * (tau * 1.0 + kappa * 4.0 * (1.0 - np.cos(a)))
    assert abs(pgo.objective(g, t, R) - f) < 1e-14
    Gt, GR = pgo.riemannian_grad(g, t, R)
    np.testing.assert_allclose(Gt, [[-tau, 0, 0], [tau, 0, 0]], atol=1e-14)
    # d/da of kappa/2 * 4 (1 - cos a) is 2 kappa sin a: pose 1's rotation
    # gradient is R1 [w]_x with |grad|_F = sqrt(2) |2 kappa sin a| / ... —
    # check it along the generator: <GR1, R1 [e_z]_x> = 2 kappa sin a.
    ez = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    assert abs(np.sum(GR[1] * (R[1] @ ez)) - 2 * kappa * np.sin(a)) < 1e-12
    assert abs(np.sum(GR[0] * (R[0] @ ez)) + 2 * kappa * np.sin(a)) < 1e-12


def test_agrees_with_the_ports_oracle():
    import torch

    from dpgo_tpu_torch.io.g2o import Measurements
    from dpgo_tpu_torch.objective import EdgeData, evaluate_f, grad_norm
    g = rim.graph(4, floors=2, rows=4, cols=16, rot_noise=0.05,
                  trans_noise=0.1)
    meas = Measurements(i=g["i"], j=g["j"], R=g["R"], t=g["t"],
                        kappa=g["kappa"], tau=g["tau"],
                        num_poses=g["num_poses"], d=3)
    rng = np.random.default_rng(0)
    t = g["t_true"] + 0.05 * rng.normal(size=g["t_true"].shape)
    R = g["R_true"] @ rim.so3_exp(0.02 * rng.normal(size=(len(t), 3)))
    e = EdgeData.from_measurements(meas, dtype=torch.float64, device="cpu")
    tt, RR = torch.as_tensor(t), torch.as_tensor(R)
    assert abs(pgo.objective(g, t, R) - float(evaluate_f(e, tt, RR))) \
        <= 1e-12 * pgo.objective(g, t, R)
    assert abs(pgo.grad_norm(g, t, R) - float(grad_norm(e, tt, RR))) \
        <= 1e-10 * pgo.grad_norm(g, t, R)
