"""BENCHMARK.json against the contract's shape, the files it names, the
metric readers, and the imports of everything under pgobench/."""

import ast
import os
import re

import pytest

from pgobench import faults, manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
HERE = manifest.HERE


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pgobench"]
    assert BENCH["command"] == ["python3", "pgobench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contracts_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_names_units_and_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]), w["name"]
    for c in BENCH["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cells_files_exist():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        assert c["file"].startswith("pgobench/")
        assert manifest.config(BENCH, w["config"])["name"] == c["name"]
        assert "options" in manifest.mix(w["traffic"])
        cell = manifest.cell(w["name"])
        assert cell["steps_per_solve"] > 0 and cell["trace_solves"] > 0
        assert cell["warm_seconds"] >= 0
        assert set(cell["limits"]) == {"f_gap", "grad_rel", "tnt_off"}
        assert cell["control"] in faults.CONTROLS
    assert used == set(configs)
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)


def reports(m, cell):
    return cell in m.get("workloads", [cell])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = [w["name"] for w in BENCH["workloads"] if reports(m, w["name"])]
    assert cells
    for c in cells:
        assert reports(e2e[m["moves"]], c), (metric, c)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers
    r = manifest.reader(metric)
    assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"], m["moves"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, w["name"]) for m in BENCH["per_layer"])


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax_nor_the_jax_package(path):
    # Whole top-level names: dpgo_tpu_torch begins with dpgo_tpu.
    assert not set(top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                               "dpgo_tpu"}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            mods = set(top_level_imports(os.path.join(ref, f)))
            assert mods <= {"__future__", "numpy", "math"}, (f, mods)
