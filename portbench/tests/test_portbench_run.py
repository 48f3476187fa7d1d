"""Whole runs at small sizes on the CPU: the result line, the refusal to
run without a card, the faults the check must catch, and the control."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, faults, harness
from portbench.spec import Spec
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KINDS = {name: Spec().cell(name) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_result_line(name, trace):
    cell = small.cell(name)
    result = harness.execute(cell, 2 ** 33 + 1, 0.05, trace, "cpu")
    assert list(result) [:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(result)
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]
        assert result["metrics"] == {}  # a CPU trace holds no device time
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]


def _run_py(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                           "3", "--seconds", "1", "--trace", "0", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run_py(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


PAIRS = [(name, fault) for name in CELLS for fault in KINDS[name].drive.FAULTS]


@pytest.mark.parametrize("name,fault", PAIRS)
def test_planted_fault_is_not_correct(name, fault):
    """The run's rest, past the look for a card, with the timed path broken
    underneath: ``correct`` comes out false."""
    cell = small.cell(name)
    with faults.plant(fault, cell.traffic["kind"]):
        result = harness.execute(cell, 77, 0.05, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


READOUTS = [name for name in CELLS if "verbs" in KINDS[name].traffic]


@pytest.mark.parametrize("name", READOUTS)
def test_a_pass_with_a_nan_counts_as_failed(name, monkeypatch):
    """A readout pass whose outputs are not all finite is a failed pass,
    wherever the NaN lies, and the run is not correct."""
    cell = small.cell(name)
    impute = cell.system.VERBS["impute"]

    def broken(model, ds):
        out = impute(model, ds).clone()
        out[-1, -1] = float("nan")
        return out

    monkeypatch.setitem(cell.system.VERBS, "impute", broken)
    result = harness.execute(cell, 78, 0.05, False, "cpu")
    assert result["failed"] == result["attempted"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    """The reference in TF32 in the program's place fails one of the cell's
    limits, at a size a test holds (on the card at the cell's own size:
    ``portbench/control.py``)."""
    cell = small.cell(name)
    cell.config.update({"rows": 8192, "output_size": 256, "state_size": 32})
    got = control.readings(cell, 91, "cpu", True, ())
    assert all(v <= cell.limits[k]["limit"] for k, v in got["program"].items())
    assert any(v > cell.limits[k]["limit"] for k, v in got["control"].items())


@pytest.mark.card
def test_cells_on_the_card(card):
    for name in CELLS:
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                               "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                              cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"


def test_streamed_setup_agrees_with_the_resident_one():
    """On the same inputs, the streamed set-up's steps (every chunk copied
    to the host and back through the streaming trainer) give the resident
    set-up's llks and parameters."""
    from portbench import compare
    from portbench.tracing import Tracer

    got = {}
    for name in ("masked_k64.train", "masked_k64.stream"):
        cell = small.cell(name)
        gen = torch.Generator().manual_seed(2 ** 33 + 5)
        inputs = cell.system.make_inputs(cell.config, gen, "cpu", train=True)
        session = cell.drive.setup(cell, inputs, "cpu", Tracer(False, "cpu"), 5)
        got[name] = cell.drive.outputs(session)
    want, streamed = got["masked_k64.train"], got["masked_k64.stream"]
    gaps = compare.train(streamed["llks"], streamed["params"], want["llks"], want["params"])
    assert len(streamed["llks"]) == 2
    assert gaps["llk_rel"] <= 1e-6 and gaps["param_rel"] <= 1e-6, gaps
