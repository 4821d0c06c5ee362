"""Checkpoint / resume for solver state (torch port of
dpgo_tpu/checkpoint.py).

The full per-node solver state (anchors, surrogate terms, Nesterov scalars,
restart counters) round-trips through one .npz file, so long runs survive
preemption. The port's states are dataclasses of tensors (`MMState`,
`StarState`, with nested `NodeState`s), flattened by field name ("Z.t",
"gamma", ...). The JAX package flattens its pytrees by leaf position, so a
file written by one package does not load in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _flatten(state, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flatten(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def save_state(path: str, state, step: int, gauge_c=None) -> None:
    """`gauge_c` (optional [N, d]) records the solver's local-gauge
    centroids (driver._set_gauge) so a resumed process reuses the exact
    frame the state was written in."""
    arrays = {"state." + k: v.cpu().numpy()
              for k, v in _flatten(state).items()}
    arrays["__step__"] = np.asarray(step)
    if gauge_c is not None:
        arrays["__gauge_c__"] = np.asarray(gauge_c)
    np.savez_compressed(path, **arrays)


def _restore(template, data, prefix: str):
    kw = {}
    for f in dataclasses.fields(template):
        ref = getattr(template, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(ref):
            kw[f.name] = _restore(ref, data, key + ".")
            continue
        if "state." + key not in data:
            raise ValueError(f"checkpoint has no field {key!r}; was it "
                             "written for another solver?")
        arr = data["state." + key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint field {key} shape {arr.shape} != expected "
                f"{tuple(ref.shape)}; was the checkpoint written by a "
                "different problem configuration?")
        kw[f.name] = torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)
    return dataclasses.replace(template, **kw)


def load_state(path: str, template, solver=None):
    """Restore into the structure of `template` (same solver configuration).

    With `solver` given, also restores the local-gauge frame recorded by
    save_state into it. Returns (state, step)."""
    data = np.load(path)
    if solver is not None and "__gauge_c__" in data:
        solver.set_gauge(data["__gauge_c__"])
    return _restore(template, data, ""), int(data["__step__"])
