"""The port's pattern route trained through its normal path,
``PPCATrainer(Dataset.from_parts(data, mask)).train(...)``, against the
benchmark's plain float64 reference (``portbench/reference/ppca.py``) on
the rows of the benchmark's structured configuration
(``portbench/configs/pattern_k64.json``, ``portbench/systems/structured.py``)
cut to CPU sizes.

The reference knows nothing of patterns: the route is an exact regrouping
of the masked EM's sums, so in float64 the two agree to rounding (1e-9
relative, the JAX parity tests' tolerance).  In float32 the route is held
to the cell's own limits (``portbench/limits/pattern_k64.train.json``).
Both forms run: the per-segment EM over the rows sorted by pattern
(``pattern_dedup.em_stats_sorted``; at these sizes only with
``config.pat_sorted_min_rows`` lowered) and the grouped one
(``pattern_dedup.em_stats``).
"""

import json
import math
from pathlib import Path

import pytest
import torch

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.ops import pattern_dedup as tpd
from portbench import compare
from portbench.reference import ppca as ref
from portbench.reference.linalg import F64
from portbench.systems import structured

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "pattern_k64.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "limits" / "pattern_k64.train.json").read_text())
RTOL = 1e-9
STEPS = 2


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make(seed, rows, D, k, P):
    """The configuration's rows and start, cut to ``rows`` x ``D``, state
    size ``k`` and ``P`` patterns, from ``seed``."""
    cfg = dict(CFG, rows=rows, output_size=D, state_size=k, patterns=P)
    return structured.make_inputs(cfg, torch.Generator().manual_seed(seed), "cpu", train=True)


def run_port(inputs, dtype, form, monkeypatch):
    """``STEPS`` trainer iterations of the port from the inputs' start on
    the route of ``form``: (llk per row of each step, parameters)."""
    if form == "sorted":
        monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 8)
    ds = tp.Dataset.from_parts(inputs["data"].to(dtype), inputs["mask"])
    way = routes.route(ds)
    assert way.kind == "pattern"
    assert (way.order is not None) == (form == "sorted")
    start = inputs["start"]
    model = tp.PPCAModel(isotropic_noise=float(start["sigmas"][0]),
                         transform=start["Cs"][0].double().numpy(),
                         mean=start["means"][0].double().numpy(), device="cpu", dtype=dtype)
    llks = []
    tpd.reset_counts()
    fitted = tp.PPCATrainer(ds).train(start=model, n_iters=STEPS, quiet=True,
                                      state_size=model.state_size,
                                      callback=lambda it, m: llks.append(m.llk))
    P = way.pattern[1].shape[0]
    assert tpd.COUNTS["tables"] == STEPS
    assert tpd.COUNTS["segments"] == (STEPS * P if form == "sorted" else 0)
    assert tpd.COUNTS["rows"] == STEPS * len(ds)
    params = {"Cs": fitted.transform[None], "means": fitted.mean[None],
              "sigmas": fitted.isotropic_noise.reshape(1), "log_weights": None}
    return llks, params


def run_reference(inputs):
    llks, params = ref.em(F64, inputs["start"], inputs["data"], inputs["mask"], STEPS)
    n = inputs["data"].shape[0]
    return [v / n for v in llks], params


CASES = [(form, seed, rows, D, k, P)
         for form in ("sorted", "grouped")
         for seed, rows, D, k, P in ((2 ** 33 + 3, 512, 24, 4, 6),
                                     (2 ** 31 + 11, 1024, 96, 16, 8))]


@pytest.mark.parametrize("form,seed,rows,D,k,P", CASES)
def test_route_matches_the_reference_in_float64(form, seed, rows, D, k, P, monkeypatch):
    inputs = make(seed, rows, D, k, P)
    got = compare.train(*run_port(inputs, torch.float64, form, monkeypatch),
                        *run_reference(inputs))
    assert got["llk_rel"] <= RTOL and got["param_rel"] <= RTOL, got


@pytest.mark.parametrize("form", ["sorted", "grouped"])
def test_route_in_float32_within_the_cell_limits(form, monkeypatch):
    """What the benchmark's check computes, at a CPU size: each number at
    or below the cell's limit."""
    inputs = make(2 ** 32 + 21, 4096, 96, 16, 8)
    got = compare.train(*run_port(inputs, torch.float32, form, monkeypatch),
                        *run_reference(inputs))
    for name, value in got.items():
        assert math.isfinite(value) and value <= LIMITS[name]["limit"], (name, got)


def test_the_cell_takes_the_sorted_pattern_route():
    """At the configuration's rows and patterns, the structured rows take
    ``Route("pattern", (pidx, patterns), (data_sorted, perm, counts))``:
    the sorted copy's byte gate holds at the configuration's width, and the
    segment gate at its N / P.  The rows are made at a narrower width (32
    columns; the patterns stay distinct), and one statistics pass walks
    every segment, one block a segment (at the configuration's width too)."""
    rows, P = CFG["rows"], CFG["patterns"]
    assert rows * CFG["output_size"] * 4 <= tconfig.pat_sorted_max_bytes
    assert rows >= P * tconfig.pat_sorted_min_rows
    inputs = make(2 ** 33 + 9, rows, 32, 4, P)
    ds = tp.Dataset.from_parts(inputs["data"], inputs["mask"])
    way = routes.route(ds)
    assert way.kind == "pattern" and way.order is not None
    pidx, patterns = way.pattern
    data_sorted, perm, counts = way.order
    assert patterns.shape[0] == P and len(counts) == P and sum(counts) == rows
    assert torch.equal(patterns[pidx], ds.mask)
    assert torch.equal(data_sorted, ds.data[perm])
    model = tp.PPCAModel.init(4, ds, generator=torch.Generator().manual_seed(1))
    assert max(counts) <= tconfig.segment_rows(CFG["output_size"], 4)
    tpd.reset_counts()
    routes.em_stats(way, model.transform, model.mean, model.isotropic_noise, ds,
                    tconfig.block_size)
    assert tpd.COUNTS == {"tables": 1, "segments": P, "blocks": P, "rows": rows}


@pytest.mark.parametrize("block", [7, 64, 4096])
def test_sorted_blocks_are_a_regrouping(block):
    """The per-segment EM in blocks of ``block`` rows (several a segment,
    and a last short one, down to one a segment) gives the grouped EM's
    statistics over the rows in their own order, in float64."""
    inputs = make(2 ** 32 + 5, 600, 20, 3, 5)
    ds = tp.Dataset.from_parts(inputs["data"].double(), inputs["mask"])
    pidx, patterns = ds.pattern_info()
    perm = torch.argsort(pidx, stable=True)
    counts = tuple(torch.bincount(pidx, minlength=patterns.shape[0]).tolist())
    weights = torch.rand(len(ds), generator=torch.Generator().manual_seed(4),
                         dtype=torch.float64) + 0.5
    C = inputs["start"]["Cs"][0].double()
    mean = torch.linspace(-2.0, 3.0, 20, dtype=torch.float64)
    sigma = torch.tensor(0.7, dtype=torch.float64)
    want = tpd.em_stats(C, mean, sigma, ds.data, ds.mask, pidx, patterns, weights,
                        block_size=64)
    got = tpd.em_stats_sorted(C, mean, sigma, ds.data[perm], weights[perm], patterns, counts,
                              block_size=block)
    for name in want._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=1e-12,
                                   atol=1e-12 * float(getattr(want, name).abs().max()))
