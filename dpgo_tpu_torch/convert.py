"""Load the JAX package's problem and solver state into this port.

`problem_from_numpy`, `state_from_numpy` and `star_state_from_numpy` take
the leaves of a dpgo_tpu `NodeProblem` / `MMState` / `StarState` as numpy
arrays keyed by field name (the node-stacked pytrees converted with
`np.asarray`) and build the port's counterparts on `device` (named by the
caller: the tests carry the JAX package's state to the CPU), so both
packages can start from one state. Dense, edge-wise and segment problems at
d = 2 and 3 are taken, reweighted (dynamic) ones included; a field a regime
does not build is the JAX package's [N, 1, 1] placeholder in both. Fields
the port does not carry (fused-kernel panels, the one-hot scatter) are
ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from dpgo_tpu_torch.losses import Loss
from dpgo_tpu_torch.problem import NodeProblem, NodeState, make_problem
from dpgo_tpu_torch.solvers.mm import MMState
from dpgo_tpu_torch.solvers.star import StarState

_STATE_FIELDS = ("g_t", "g_R", "f", "fobj", "Df_t", "Df_R", "g_t_prev",
                 "g_R_prev", "Df_t_prev", "Df_R_prev", "fobj_prev",
                 "gradFnorm", "Gk", "Fk0", "Fk1", "s", "s_next", "gamma",
                 "z_rt", "z_rR", "z_us", "z_Es", "scale_w", "aa_dX", "aa_dR",
                 "aa_x_prev", "aa_r_prev")
_STATE_INT_FIELDS = ("hits0", "hits1", "osc_buf", "num_osc",
                     "rescale_count", "aa_count")
_STAR_FIELDS = ("g_t", "g_R", "f", "fobj", "Df_t", "Df_R", "g_t_prev",
                "g_R_prev", "Df_t_prev", "Df_R_prev", "gradFnorm", "s",
                "s_next", "gamma", "F", "z_rt", "z_rR", "z_us", "z_Es")


def problem_from_numpy(arrays: dict, device,
                       dtype=torch.float64) -> NodeProblem:
    """Port NodeProblem from the JAX NodeProblem's fields.

    `arrays` holds every array field of the port's NodeProblem plus the
    static fields d, xi, loss (a Loss of either package, or its value
    string), loss_reg, dense, dynamic, seg, seg_size, seg_cg_iters and
    seg_cg_tol."""
    loss = arrays["loss"]
    loss = Loss(getattr(loss, "value", loss))
    return make_problem(arrays, d=int(arrays["d"]), xi=float(arrays["xi"]),
                        loss=loss, loss_reg=float(arrays["loss_reg"]),
                        dense=bool(arrays["dense"]),
                        dynamic=bool(arrays["dynamic"]),
                        seg=bool(arrays["seg"]),
                        seg_size=int(arrays["seg_size"]),
                        seg_cg_iters=int(arrays["seg_cg_iters"]),
                        seg_cg_tol=float(arrays["seg_cg_tol"]),
                        device=device, dtype=dtype)


def _node_state(z: dict, device, dtype) -> NodeState:
    def f(name):
        return torch.as_tensor(np.array(z[name]), dtype=dtype,
                               device=device)

    return NodeState(t=f("t"), R=f("R"), th=f("th"), Rh=f("Rh"))


def state_from_numpy(arrays: dict, device,
                     dtype=torch.float64) -> MMState:
    """Port MMState from the JAX MMState's fields; Z and Z_prev are dicts
    of the NodeState fields t, R, th, Rh."""
    kw = {name: torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                                device=device) for name in _STATE_FIELDS}
    kw.update({name: torch.as_tensor(np.array(arrays[name], np.int32),
                                     device=device)
               for name in _STATE_INT_FIELDS})
    return MMState(Z=_node_state(arrays["Z"], device, dtype),
                   Z_prev=_node_state(arrays["Z_prev"], device, dtype), **kw)


def star_state_from_numpy(arrays: dict, device,
                          dtype=torch.float64) -> StarState:
    """Port StarState from the JAX StarState's fields; Z and Z_prev are
    dicts of the NodeState fields t, R, th, Rh."""
    kw = {name: torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                                device=device) for name in _STAR_FIELDS}
    return StarState(Z=_node_state(arrays["Z"], device, dtype),
                     Z_prev=_node_state(arrays["Z_prev"], device, dtype),
                     **kw)
