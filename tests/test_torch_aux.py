"""The port's message transport (transport.py) against the JAX package and
against the driver's in-process halo exchange, and its viz.py, on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.synthetic import random_pose_graph


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _torch_meas(meas):
    from dpgo_tpu_torch.io.g2o import Measurements
    return Measurements(**{f.name: getattr(meas, f.name)
                           for f in dataclasses.fields(meas)})


@pytest.mark.parametrize("d", [3, 2])
def test_transport_matches_jax(rng, d):
    """extract_messages and apply_messages on each node of a 4-node graph,
    from random own states and halos: the same messages (destinations,
    poses, order) and the same updated halos as the JAX package's."""
    from dpgo_tpu import transport as jt
    from dpgo_tpu.graph import build_multigraph as jax_build

    from dpgo_tpu_torch import transport as tt
    from dpgo_tpu_torch.graph import build_multigraph

    meas, _, _ = random_pose_graph(rng, num_poses=48, d=d, loop_closures=30)
    _, jnodes, _ = jax_build(meas, 4)
    _, tnodes, _ = build_multigraph(_torch_meas(meas), 4)
    own = [(rng.normal(size=(g.n0, d)), rng.normal(size=(g.n0, d, d)))
           for g in tnodes]
    sent = {a: tt.extract_messages(g, *own[a]) for a, g in enumerate(tnodes)}
    for a, (jg, tg) in enumerate(zip(jnodes, tnodes)):
        want = jt.extract_messages(jg, *own[a])
        assert list(sent[a]) == list(want) and len(want) > 0
        for b in want:
            for x, y in zip(sent[a][b], want[b]):
                np.testing.assert_array_equal(x, y)
        th, Rh = rng.normal(size=(tg.n1, d)), rng.normal(size=(tg.n1, d, d))
        msgs = {b: sent[b][a] for b in tg.recv}
        for x, y in zip(tt.apply_messages(tg, th, Rh, msgs),
                        jt.apply_messages(jg, th, Rh, msgs)):
            np.testing.assert_array_equal(x, y)


def test_message_round_equals_communicate(rng):
    """One round of extract_messages / apply_messages over all nodes of a
    DPGOSolver's state, with random own poses, gives the halo that
    driver.communicate gathers (float64, no gauge offsets); a message of
    the wrong length is refused."""
    from dpgo_tpu_torch.driver import DPGOSolver, communicate
    from dpgo_tpu_torch.problem import NodeState
    from dpgo_tpu_torch.transport import apply_messages, extract_messages

    meas, _, _ = random_pose_graph(rng, num_poses=48, d=3, loop_closures=30)
    s = DPGOSolver(_torch_meas(meas), 4, device="cpu")
    st = s.initialize()
    Z = NodeState(t=torch.as_tensor(rng.normal(size=st.Z.t.shape)),
                  R=torch.as_tensor(rng.normal(size=st.Z.R.shape)),
                  th=torch.zeros_like(st.Z.th), Rh=torch.zeros_like(st.Z.Rh))
    want = communicate(st.replace(Z=Z), s.halo_owner, s.halo_lpose,
                       s.halo_dc).Z
    sent = {a: extract_messages(g, Z.t[a, :g.n0].numpy(),
                                Z.R[a, :g.n0].numpy())
            for a, g in enumerate(s.nodes)}
    for b, g in enumerate(s.nodes):
        th, Rh = apply_messages(g, np.zeros((g.n1, 3)),
                                np.zeros((g.n1, 3, 3)),
                                {a: sent[a][b] for a in g.recv})
        np.testing.assert_array_equal(th, want.th[b, :g.n1].numpy())
        np.testing.assert_array_equal(Rh, want.Rh[b, :g.n1].numpy())
    g = s.nodes[0]
    a = next(iter(g.recv))
    with pytest.raises(ValueError, match="schedule expects"):
        apply_messages(g, np.zeros((g.n1, 3)), np.zeros((g.n1, 3, 3)),
                       {a: (sent[a][0][0][:-1], sent[a][0][1][:-1])})


def test_viz_writes_files(rng, tmp_path):
    """plot_trajectory (3-D, colored by node, with loop closures),
    plot_convergence and animate_iterates (2-D GIF of 3 frames) write their
    files."""
    pytest.importorskip("matplotlib")
    from dpgo_tpu_torch.viz import (animate_iterates, plot_convergence,
                                    plot_trajectory)

    meas, t_true, _ = random_pose_graph(rng, num_poses=30, d=3)
    p1 = str(tmp_path / "traj.png")
    plot_trajectory(t_true, p1, edges=(meas.i, meas.j),
                    color_by_node=np.repeat([0, 1, 2], 10))
    hist = np.array([[0, 100.0, 10.0], [1, 50.0, 5.0], [2, 40.0, 1.0]])
    p2 = str(tmp_path / "conv.png")
    plot_convergence(hist, p2, f_star=39.0)
    meas2, t2, _ = random_pose_graph(rng, num_poses=20, d=2)
    frames = [t2 + 0.3 * rng.normal(size=t2.shape), t2]
    p3 = str(tmp_path / "iterates.gif")
    animate_iterates(frames + [t2], p3, edges=(meas2.i, meas2.j), fps=2)
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 0
    with pytest.raises(ValueError, match="empty"):
        animate_iterates([], str(tmp_path / "none.gif"))
