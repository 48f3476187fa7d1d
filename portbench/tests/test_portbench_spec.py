"""BENCHMARK.json, and the pieces the harness finds by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.spec import Spec
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = Spec().cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(Spec().reader(m["name"]).read)
    assert set(cell.limits) == set(cell.drive.NUMBERS)
    for entry in cell.limits.values():
        assert entry["lower"] < entry["limit"] < entry["upper"]
    assert cell.chips == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/configs/")
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert cfg["dtype"] == "float32"


def test_a_new_mix_is_taken_up_by_adding_files(tmp_path):
    """A traffic mix, its limits and a workload entry added as files and an
    entry, in a copy of the benchmark: found and run with no edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "traffic" / "short_readout.json").write_text(json.dumps(
        {"kind": "readout", "verbs": ["score", "impute"], "check_rows": 8,
         "trace_seconds": 0.5}))
    shutil.copy(ROOT / "portbench" / "limits" / "masked_k64.readout.json",
                tmp_path / "portbench" / "limits" / "masked_k64.short_readout.json")
    bench["workloads"].append({"name": "masked_k64.short_readout", "config": "masked_k64",
                               "traffic": "short_readout", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "masked_k64.readout" in m.get("workloads", []):
            m["workloads"].append("masked_k64.short_readout")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Spec(tmp_path).cell("masked_k64.short_readout")
    assert cell.traffic["check_rows"] == 8
    cell.config.update(small.SIZES["masked_k64"])
    result = harness.execute(cell, 5, 0.05, False, "cpu")
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"readout_rows_per_s", "peak_mem_gib", "setup_s"}


def test_a_new_configuration_and_kind_are_taken_up_by_adding_files(tmp_path, monkeypatch):
    """A configuration with a new name and a traffic kind with a new name,
    added to a copy of the benchmark as files and entries (the kind's drive
    and work modules registered under ``portbench.drives.<kind>`` and
    ``portbench.work.<kind>``): the cell is found, cut for the CPU, runs
    correct, and its faults and numbers come from its drive, with no file
    that was there edited."""
    import sys
    import types

    from portbench import faults
    from portbench.drives import train
    from portbench.work import train as train_work

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(json.loads((ROOT / "portbench" / "configs" / "masked_k64.json").read_text()),
               name="masked_d512_k32", output_size=512, state_size=32, rows=200000)
    (tmp_path / "portbench" / "configs" / "masked_d512_k32.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "masked_d512_k32", "source": "a test",
                             "file": "portbench/configs/masked_d512_k32.json", "reduced": [],
                             "why": "a test"})
    (tmp_path / "portbench" / "traffic" / "probe.json").write_text(json.dumps(
        {"kind": "probe", "check_steps": 2, "trace_seconds": 0.5}))
    shutil.copy(ROOT / "portbench" / "limits" / "masked_k64.train.json",
                tmp_path / "portbench" / "limits" / "masked_d512_k32.probe.json")
    bench["workloads"].append({"name": "masked_d512_k32.probe", "config": "masked_d512_k32",
                               "traffic": "probe", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "em_iter_s":
            m["workloads"].append("masked_d512_k32.probe")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    drive = types.ModuleType("portbench.drives.probe")
    drive.__dict__.update({k: v for k, v in vars(train).items() if not k.startswith("__")})
    drive.FAULTS = ("stuck",)

    def plant(name):
        return faults.plant("unchanged", "train")
    drive.plant = plant
    work = types.ModuleType("portbench.work.probe")
    work.__dict__.update({k: v for k, v in vars(train_work).items() if not k.startswith("__")})
    monkeypatch.setitem(sys.modules, "portbench.drives.probe", drive)
    monkeypatch.setitem(sys.modules, "portbench.work.probe", work)

    spec = Spec(tmp_path)
    cell = small.cell("masked_d512_k32.probe", spec)
    assert cell.drive is drive and cell.work is work
    assert (cell.config["rows"], cell.config["output_size"], cell.config["state_size"]) == (
        2048, 96, 16)
    assert set(cell.limits) == set(cell.drive.NUMBERS)
    result = harness.execute(cell, 2 ** 33 + 7, 0.05, False, "cpu")
    assert result["correct"] and result["attempted"] >= 2
    assert set(result["metrics"]) == {"em_iter_s", "peak_mem_gib", "setup_s"}
    assert list(cell.drive.FAULTS) == ["stuck"]
    with faults.plant("stuck", "probe"):
        broken = harness.execute(cell, 2 ** 33 + 7, 0.05, False, "cpu")
    assert broken["correct"] is False
    assert all(p.read_bytes() == b for p, b in before.items())
