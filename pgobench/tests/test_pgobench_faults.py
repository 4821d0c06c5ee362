"""A whole run of the harness on the CPU at a small size (the look for a
card skipped): sound, it comes out correct; with each fault planted
under the timed path, not correct. And run.py on a machine without a
card: no result, a non-zero exit."""

import json
import os
import subprocess
import sys
import time

import pytest

from pgobench import cell, faults, manifest
from pgobench.tests.conftest import ROOT

BENCH = manifest.benchmark()
SEED = 2 ** 31 + 12345


def small(name):
    """The cell at 2 floors x 4 rows x 16 columns cut to 120 poses and
    350 edges (rim's edges per pose), 4 nodes."""
    spec = cell.CellSpec.load(BENCH, name)
    spec.config = dict(spec.config, num_nodes=4, graph=dict(
        spec.config["graph"], floors=2, rows=4, cols=16, num_poses=120,
        num_edges=350))
    spec.cell = dict(spec.cell, warm_seconds=0.1)
    return spec


def run(spec, plant=None, trace=False):
    import torch
    torch.set_num_threads(2)
    return cell.run(spec, SEED, 0.2, trace, torch.device("cpu"),
                    time.perf_counter(), plant=plant)


# The cells of one card; those on several are run by test_pgobench_sharded.
CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {m["name"] for m in
                                   cell.CellSpec.load(BENCH,
                                                      name).end_to_end}


@pytest.mark.parametrize("fault", sorted(faults.PLANTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    plant = faults.PLANTS[fault]
    out = run(small(name), plant=plant)
    assert not out["correct"], (fault, out["check"])
    assert out["failed"] >= 1


@pytest.mark.parametrize("name", [
    n for n in CELLS
    if cell.CellSpec.load(BENCH, n).mix["options"]["tnt"]["max_iterations"]])
def test_refinement_left_out_is_caught(name):
    """A refining mix whose steps skip the TNT (the proximal step alone):
    its answers are as good, but not the mix's algorithm."""
    out = run(small(name), plant=faults.plant_no_tnt)
    assert not out["correct"] and out["check"]["tnt_off"]["value"] == 1.0


def test_traced_run_on_the_cpu_reads_the_counters():
    out = run(small(CELLS[0]), trace=True)
    assert out["correct"]
    assert out["metrics"]["host_syncs_per_step"]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "pgobench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from pgobench import cell, manifest\n"
        "from pgobench.tests.test_pgobench_faults import small\n"
        f"spec = small({CELLS[0]!r})\n"
        "torch.set_num_threads(2)\n"
        "out = cell.run(spec, 3, 0.1, False, torch.device('cpu'),\n"
        "               time.perf_counter())\n"
        "from pgobench.run import forbidden_modules\n"
        "print(forbidden_modules(), out['correct'])\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-2] == "[] True"


@pytest.mark.cuda
def test_card_cells_print_the_contracts_line(card):
    """On the card: every cell this machine's cards can hold, for a few
    seconds through run.py; its last line has the contract's keys, with
    check last."""
    import torch
    for w in BENCH["workloads"]:
        if w["chips"] > torch.cuda.device_count():
            continue
        for trace in ("0", "1"):
            p = subprocess.run(
                [sys.executable, "pgobench/run.py", "--workload", w["name"],
                 "--seed", "20251018", "--seconds", "2", "--trace", trace],
                cwd=ROOT, capture_output=True, text=True, timeout=360)
            assert p.returncode == 0, p.stderr[-2000:]
            out = json.loads(p.stdout.strip().splitlines()[-1])
            assert {"correct", "attempted", "failed", "metrics",
                    "device"} <= set(out)
            assert list(out)[-1] == "check"
            assert out["device"]["platform"] == "gpu"
            if trace == "1":
                assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
def test_control_comes_out_not_correct(card, name):
    """On the card, at the cell's own size: a sound window is correct, the
    cell's lower-precision control (its cell file names it) is not, nor,
    in a refining mix, the refinement left out."""
    from pgobench import calibrate
    spec = cell.CellSpec.load(BENCH, name)
    bad = [spec.cell["control"]]
    if spec.mix["options"]["tnt"]["max_iterations"]:
        bad.append("no_tnt")
    rows = calibrate.readings(spec, 424242, 2.0, ["sound", *bad], card)
    assert rows[0]["failed"] == 0 and rows[0]["solves"] >= 1
    for row in rows[1:]:
        assert row["failed"] == row["solves"] >= 1, row
