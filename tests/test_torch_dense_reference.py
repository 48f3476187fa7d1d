"""The port's dense route trained through its normal path,
``PPCATrainer(Dataset.unmasked(data)).train(...)``, against the
benchmark's plain float64 reference (``portbench/reference/ppca.py``) on
the rows of the benchmark's fully observed configuration
(``portbench/configs/dense_k64.json``, ``portbench/systems/dense.py``) cut
to CPU sizes.

The reference knows nothing of the route's one shared factorization: it
runs the masked EM over an all-True mask (a broadcast view of one row), a
factorization a row.  In float64 the two agree to rounding (1e-9 relative,
the JAX parity tests' tolerance); in float32 the route is held to the
cell's own limits (``portbench/limits/dense_k64.train.json``).
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.ops import dense_fast as tdf
from portbench import compare
from portbench.reference import ppca as ref
from portbench.reference.linalg import F64
from portbench.systems import dense

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "dense_k64.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "limits" / "dense_k64.train.json").read_text())
RTOL = 1e-9
STEPS = 2


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make(seed, rows, D, k):
    """The configuration's rows and start, cut to ``rows`` x ``D`` and
    state size ``k``, from ``seed``."""
    cfg = dict(CFG, rows=rows, output_size=D, state_size=k)
    return dense.make_inputs(cfg, torch.Generator().manual_seed(seed), "cpu", train=True)


def run_port(inputs, dtype, block_rows=None, monkeypatch=None):
    """``STEPS`` trainer iterations of the port from the inputs' start on
    the dense route: (llk per row of each step, parameters).  With
    ``block_rows`` the route's blocks are cut to that many rows."""
    if block_rows is not None:
        monkeypatch.setattr(tconfig, "block_size", 1)
        monkeypatch.setattr(sys.modules["ppca_rs_tpu_torch.config"], "MIX_BLOCK_MAX_BYTES",
                            block_rows * inputs["data"].shape[1] * dtype.itemsize)
    ds = dense.dataset({"data": inputs["data"].to(dtype)})
    assert routes.route(ds).kind == "dense"
    start = inputs["start"]
    model = tp.PPCAModel(isotropic_noise=float(start["sigmas"][0]),
                         transform=start["Cs"][0].double().numpy(),
                         mean=start["means"][0].double().numpy(), device="cpu", dtype=dtype)
    llks = []
    tdf.reset_counts()
    fitted = tp.PPCATrainer(ds).train(start=model, n_iters=STEPS, quiet=True,
                                      state_size=model.state_size,
                                      callback=lambda it, m: llks.append(m.llk))
    block = tconfig.segment_rows(ds.output_size(), dtype.itemsize)
    assert tdf.COUNTS == {"posteriors": STEPS, "blocks": STEPS * -(-len(ds) // block),
                          "rows": STEPS * len(ds)}
    params = {"Cs": fitted.transform[None], "means": fitted.mean[None],
              "sigmas": fitted.isotropic_noise.reshape(1), "log_weights": None}
    return llks, params


def run_reference(inputs):
    llks, params = ref.em(F64, inputs["start"], inputs["data"], inputs["mask"], STEPS)
    n = inputs["data"].shape[0]
    return [v / n for v in llks], params


@pytest.mark.parametrize("seed,rows,D,k,block_rows", [(2 ** 33 + 3, 512, 24, 4, None),
                                                      (2 ** 31 + 11, 1024, 96, 16, None),
                                                      (2 ** 32 + 7, 1000, 40, 6, 96)])
def test_route_matches_the_reference_in_float64(seed, rows, D, k, block_rows, monkeypatch):
    inputs = make(seed, rows, D, k)
    got = compare.train(*run_port(inputs, torch.float64, block_rows, monkeypatch),
                        *run_reference(inputs))
    assert got["llk_rel"] <= RTOL and got["param_rel"] <= RTOL, got


def test_route_in_float32_within_the_cell_limits():
    """What the benchmark's check computes, at a CPU size: each number at
    or below the cell's limit."""
    inputs = make(2 ** 32 + 21, 4096, 96, 16)
    got = compare.train(*run_port(inputs, torch.float32), *run_reference(inputs))
    for name, value in got.items():
        assert math.isfinite(value) and value <= LIMITS[name]["limit"], (name, got)


def test_the_benchmark_holds_no_mask_of_its_own():
    """The reference's all-True mask is a broadcast view of one row; the
    program's dataset makes its own mask, as ``Dataset.unmasked`` does for
    users, and takes the rows without a copy."""
    inputs = make(2 ** 33 + 9, 300, 20, 3)
    mask = inputs["mask"]
    assert mask.shape == (300, 20) and mask.stride() == (0, 1) and bool(mask.all())
    ds = dense.dataset(inputs)
    assert ds.data.data_ptr() == inputs["data"].data_ptr()
    assert ds.mask.stride() == (20, 1) and ds.all_observed()


def test_the_cell_walks_80_blocks_an_iteration():
    """At the configuration's width the route's blocks are 131,072 rows
    (512 MiB of float32 values), so its 10,485,760 rows are 80 blocks."""
    block = tconfig.segment_rows(CFG["output_size"], 4)
    assert block == 131_072
    assert -(-CFG["rows"] // block) == 80
