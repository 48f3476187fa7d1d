"""The pattern route's named ranges and counters: ``ppca.block`` per row
block in both forms of the EM statistics pass (per segment over the rows
sorted by pattern, and grouped over the rows in their own order) and in
the readout verbs, ``ppca.pattern_tables`` once per step or verb,
``ppca.pattern_detect`` and ``ppca.pattern_order`` once per dataset, and
``pattern_dedup.COUNTS``.  The ranges are recorded only while a profiler
records, and change no result.  ``test_torch_spans.py`` holds the same for
the masked and mixture routes.
"""

import importlib
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import pattern_dedup as tpd
from ppca_rs_tpu_torch.utils import profiling

torch.set_num_threads(1)
config_module = importlib.import_module("ppca_rs_tpu_torch.config")

N, D, K, P = 150, 10, 2, 4
BLOCK = 16
FORMS = ("sorted", "grouped")


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """Blocks of BLOCK rows in every loop: the byte cap that widens the
    per-segment EM's blocks (``config.segment_rows``) lowered so far that
    its segments, too, take several."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    monkeypatch.setattr(tconfig, "block_size", BLOCK)
    monkeypatch.setattr(config_module, "MIX_BLOCK_MAX_BYTES", BLOCK * K * K * 8)
    assert tconfig.segment_rows(D, 8) == tconfig.block_rows(K, 8) == BLOCK


def dataset(form, monkeypatch, seed=3):
    """Rows whose masks are P patterns; the sorted form with the segment
    gate lowered to these sizes."""
    if form == "sorted":
        monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 8)
    rng = np.random.default_rng(seed)
    patterns = rng.random((P, D)) < 0.6
    patterns[:, 0] = True
    mask = patterns[np.arange(N) % P]
    data = rng.normal(size=(N, D))
    return interop.dataset_from_arrays(np.where(mask, data, 0.0), mask, rng.random(N) + 0.5)


def segments(ds):
    return np.bincount(ds.pattern_info()[0].numpy(), minlength=P)


def stats_blocks(form, ds):
    """Row blocks of one statistics pass."""
    if form == "sorted":
        return sum(math.ceil(c / BLOCK) for c in segments(ds))
    return math.ceil(N / BLOCK)


def recorded(fn):
    """``fn()``'s result and the ``ppca.*`` ranges it recorded, as (name,
    start ns, end ns) by start."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("ppca.")]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def inside(ranges, outer, name):
    return [r for r in ranges if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]]


def named(ranges, name):
    return [r for r in ranges if r[0] == name]


def train(ds, n_iters=1):
    return tp.PPCATrainer(ds).train(state_size=K, n_iters=n_iters, quiet=True,
                                    generator=torch.Generator().manual_seed(11))


@pytest.mark.parametrize("form", FORMS)
def test_em_iteration_ranges_and_counts(form, monkeypatch):
    """Three iterations on a new dataset: detection once and the sorted copy
    once (the sorted form's), in the first step; each ``ppca.em_stats``
    holds one ``ppca.pattern_tables`` and a ``ppca.block`` per row block;
    ``COUNTS`` adds up the same work."""
    ds = dataset(form, monkeypatch)
    tpd.reset_counts()
    _, ranges = recorded(lambda: train(ds, n_iters=3))
    steps = named(ranges, "ppca.em_step")
    assert len(steps) == 3
    assert len(named(ranges, "ppca.pattern_detect")) == 1
    assert len(inside(ranges, steps[0], "ppca.pattern_detect")) == 1
    assert len(named(ranges, "ppca.pattern_order")) == (form == "sorted")
    blocks = stats_blocks(form, ds)
    for step in steps:
        (stats,) = inside(ranges, step, "ppca.em_stats")
        assert len(inside(ranges, stats, "ppca.pattern_tables")) == 1
        assert len(inside(ranges, stats, "ppca.block")) == blocks
    assert len(named(ranges, "ppca.block")) == 3 * blocks
    assert len(named(ranges, "ppca.pattern_tables")) == 3
    assert tpd.COUNTS == {"tables": 3, "segments": 3 * P if form == "sorted" else 0,
                          "blocks": 3 * blocks, "rows": 3 * N}


@pytest.mark.parametrize("form", FORMS)
def test_detection_and_order_once_per_dataset(form, monkeypatch):
    """A dataset's table and sorted copy are cached: a second training
    records neither."""
    ds = dataset(form, monkeypatch)
    train(ds)
    _, ranges = recorded(lambda: train(ds))
    assert named(ranges, "ppca.pattern_detect") == named(ranges, "ppca.pattern_order") == []
    assert len(named(ranges, "ppca.pattern_tables")) == 1


VERBS = ("llks", "infer", "smooth", "extrapolate")


def _plain(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tp.Dataset):
        return [out.data]
    return [out.states(), out.covariances_array()]


@pytest.mark.parametrize("verb", VERBS)
def test_readout_ranges(verb, monkeypatch):
    """A readout verb on the pattern route: one ``ppca.readout`` holding one
    ``ppca.pattern_tables`` and a ``ppca.block`` per block of rows, counted
    in ``COUNTS``, with the same values as without a profiler."""
    ds = dataset("grouped", monkeypatch)
    model = train(ds)
    plain = getattr(model, verb)(ds)
    tpd.reset_counts()
    traced, ranges = recorded(lambda: getattr(model, verb)(ds))
    (entry,) = named(ranges, "ppca.readout")
    blocks = math.ceil(N / BLOCK)
    assert len(inside(ranges, entry, "ppca.block")) == len(named(ranges, "ppca.block")) == blocks
    assert len(inside(ranges, entry, "ppca.pattern_tables")) == 1
    assert tpd.COUNTS == {"tables": 1, "segments": 0, "blocks": blocks, "rows": N}
    for a, b in zip(_plain(plain), _plain(traced), strict=True):
        assert torch.equal(a, b)


def test_no_profiler_no_range(monkeypatch):
    """With no profiler recording, neither form's training, detection, sorted
    copy nor readout builds a ``record_function``; the counters count all
    the same."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    tpd.reset_counts()
    for form in ("grouped", "sorted"):   # the sorted form lowers the gate for good
        ds = dataset(form, monkeypatch)
        train(ds).llks(ds)
    assert made == []
    assert tpd.COUNTS["tables"] == 4 and tpd.COUNTS["segments"] == P
    assert profiling.span("ppca.pattern_tables") is profiling.NO_SPAN


@pytest.mark.parametrize("form", FORMS)
def test_em_is_the_same_under_a_profiler(form, monkeypatch):
    """Three iterations from one start, with and without a profiler: bit for
    bit the same parameters."""
    plain = train(dataset(form, monkeypatch), n_iters=3)
    traced, _ = recorded(lambda: train(dataset(form, monkeypatch), n_iters=3))
    for a, b in zip((plain.transform, plain.mean, plain.isotropic_noise),
                    (traced.transform, traced.mean, traced.isotropic_noise), strict=True):
        assert torch.equal(a, b)
