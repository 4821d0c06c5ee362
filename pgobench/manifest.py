"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root and the files of configurations, mixes, cells and metric readers
under this folder."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return _json(os.path.join(HERE, "mixes", name + ".json"))


def cell(name: str) -> dict:
    return _json(os.path.join(HERE, "cells", name + ".json"))


def reader(metric: str):
    """The module `metrics/<metric>.py`: LAYER, UNIT, MOVES and
    read(readings) -> float | None."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pgobench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    """The module `gen/<name>.py`, whose graph(seed, **params) makes the
    configuration's graph."""
    return importlib.import_module("pgobench.gen." + name)
