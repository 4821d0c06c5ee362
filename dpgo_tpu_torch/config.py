"""JSON/YAML config loading for solver options (torch port of
dpgo_tpu/config.py).

Keys mirror the MMOptions / TNTParams fields plus dataset/result paths. JSON
always works; a .yaml/.yml file needs PyYAML where the program runs.
"""

from __future__ import annotations

import dataclasses
import json

from dpgo_tpu_torch.solvers.mm import MMOptions
from dpgo_tpu_torch.solvers.tnt import TNTParams


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("a .yaml config needs PyYAML, which this Python "
                           "lacks; use a .json config") from e
    return yaml


def _is_yaml(path: str) -> bool:
    return path.endswith((".yaml", ".yml"))


def load_config(path: str):
    """Load solver options from a .json (or .yaml/.yml) file.

    Returns (MMOptions, dict-of-extras). Unknown top-level keys are returned
    in extras (e.g. dataset, num_nodes, result_path). TNTParams keys may sit
    at the top level or under "tnt"."""
    with open(path) as fh:
        raw = _yaml().safe_load(fh) if _is_yaml(path) else json.load(fh)
    raw = dict(raw or {})

    tnt_fields = {f.name for f in dataclasses.fields(TNTParams)}
    tnt_kwargs = {k: raw.pop(k) for k in list(raw) if k in tnt_fields}
    tnt_raw = raw.pop("tnt", {}) or {}
    tnt_kwargs.update({k: v for k, v in tnt_raw.items() if k in tnt_fields})

    mm_fields = {f.name for f in dataclasses.fields(MMOptions)}
    mm_kwargs = {k: raw.pop(k) for k in list(raw) if k in mm_fields}
    if tnt_kwargs:
        mm_kwargs["tnt"] = TNTParams(**tnt_kwargs)
    return MMOptions(**mm_kwargs), raw


def save_config(path: str, opts: MMOptions, **extras):
    data = dataclasses.asdict(opts)
    data.update(extras)
    with open(path, "w") as fh:
        if _is_yaml(path):
            _yaml().safe_dump(data, fh)
        else:
            json.dump(data, fh, indent=2)
