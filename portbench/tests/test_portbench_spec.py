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
    numbers = {"train": {"llk_rel", "param_rel"}, "readout": {"score_rel", "impute_rel"}}
    assert set(cell.limits) == numbers[cell.traffic["kind"]]
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
