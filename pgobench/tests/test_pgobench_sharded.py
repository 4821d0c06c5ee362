"""The harness's path for a cell on several cards, on the CPU: the ranks
over gloo at a small size (the look for cards skipped), sound and with
each fault planted under the timed path; run.py's choice of path; and on
a four-card host the cell itself."""

import json
import subprocess
import sys
import time

import pytest

from pgobench import calibrate, cell, faults, manifest, run, sharded
from pgobench.tests.conftest import ROOT

BENCH = manifest.benchmark()
SEED = 2 ** 31 + 12345
SHARDED_CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def small(name):
    """The cell at 2 floors x 4 rows x 16 columns cut to 120 poses and
    350 edges (rim's edges per pose), 2 nodes per rank."""
    spec = cell.CellSpec.load(BENCH, name)
    spec.config = dict(spec.config, num_nodes=2 * spec.chips, graph=dict(
        spec.config["graph"], floors=2, rows=4, cols=16, num_poses=120,
        num_edges=350))
    spec.cell = dict(spec.cell, warm_seconds=0.1)
    return spec


def run_small(name, plant=None):
    return sharded.run(small(name), SEED, 0.2, False, time.perf_counter(),
                       plant=plant, backend="gloo", devices="cpu")


@pytest.mark.parametrize("name", SHARDED_CELLS)
def test_sound_run_over_gloo_is_correct(name):
    spec = cell.CellSpec.load(BENCH, name)
    out = run_small(name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert list(out)[-1] == "check"
    assert out["device"]["count"] == spec.chips
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    # Rank 0's counters: the exchange of every step, the answers' gathers.
    per_step = out["window"]["counters_per_step"]
    assert per_step["collectives"] > 1 and per_step["collective_bytes"] > 0


@pytest.mark.parametrize("name", SHARDED_CELLS)
def test_no_exchange_is_caught(name):
    out = run_small(name, plant="no_exchange")
    assert not out["correct"] and out["failed"] >= 1, out["check"]


@pytest.mark.parametrize("name", SHARDED_CELLS)
def test_every_fault_and_the_control_fail_every_answer(name):
    """calibrate's readings in one group of ranks: the sound window
    passes; each fault the cell can have (a state unchanged, half the
    batch, no exchange, an answer altered, a pose moved on rank 2, rank
    3's nodes kept, the refinement left out) fails every answer."""
    spec = small(name)
    rows = sharded.calibrate(spec, [SEED], 0.2, 1, backend="gloo",
                             devices="cpu")
    by = {r["variant"]: r for r in rows}
    want = set(calibrate.variants_of(0, 1, spec))
    assert set(by) == want and {"moved_rank2", "rank3_kept"} <= want
    assert by["sound"]["failed"] == 0 and by["sound"]["solves"] >= 1
    # No product of this size reaches a TF32 unit on the CPU, nor any
    # bfloat16 rounding that the check can see: the controls are read on
    # the card (calibrate.py).
    for v in want - {"sound", *faults.CONTROLS}:
        assert by[v]["failed"] == by[v]["solves"] >= 1, by[v]


@pytest.mark.parametrize("chips,path", [(1, "cell"), (4, "sharded")])
def test_run_sends_a_cell_by_its_chips(monkeypatch, chips, path):
    """run.py: a cell of one card through cell.run, as before; one of
    several through sharded.run."""
    import torch

    class Called(Exception):
        pass

    def called(where):
        def fn(*args, **kw):
            raise Called(where)
        return fn

    name = next(w["name"] for w in BENCH["workloads"]
                if w["chips"] == chips)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(cell, "run", called("cell"))
    monkeypatch.setattr(sharded, "run", called("sharded"))
    with pytest.raises(Called) as got:
        run.main(["--workload", name, "--seed", "1", "--seconds", "1",
                  "--trace", "0"])
    assert str(got.value) == path


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHARDED_CELLS)
def test_sharded_cell_on_its_cards(card, name):
    """On a host with the cell's cards: a few seconds of the cell through
    run.py, correct, on every card."""
    import torch
    spec = cell.CellSpec.load(BENCH, name)
    if torch.cuda.device_count() < spec.chips:
        pytest.skip(f"needs {spec.chips} CUDA cards")
    p = subprocess.run(
        [sys.executable, "pgobench/run.py", "--workload", name, "--seed",
         "20251019", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["count"] == spec.chips
