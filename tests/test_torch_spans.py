"""The port's named ranges (``utils/profiling.span``): ``ppca.em_step``
holding ``ppca.em_stats`` (one ``ppca.block`` per block of rows) and then
``ppca.em_finalize``; ``ppca.readout`` holding its ``ppca.block`` ranges.
They are recorded only while a profiler records, and change no result.

Ranges are read from a CPU ``torch.profiler.profile`` started and stopped
by hand (``start()`` / ``stop()``), as the benchmark's traced runs do, and
from a trainer's ``profile_dir`` Chrome trace.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, D, K, M = 100, 10, 2, 2
BLOCK = 16
BLOCKS = math.ceil(N / BLOCK)
KINDS = ("model", "mix")


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """On the CPU, with blocks of BLOCK rows (mixtures too: M * BLOCK * k^2
    is far below the mixture's cap)."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    monkeypatch.setattr(tconfig, "block_size", BLOCK)


def dataset(seed=5):
    """Random 30% missingness over D=10 columns: too many distinct masks for
    the pattern route, so every row takes the masked (mixture: general)
    route."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N, D)) > 0.3
    data = rng.normal(size=(N, D)) + 3.0 * (rng.random((N, 1)) < 0.5)
    ds = interop.dataset_from_arrays(np.where(mask, data, 0.0), mask, rng.random(N) + 0.5)
    assert ds.pattern_info(include_dense=True) is None
    return ds


def train(kind, ds, n_iters=1, **kw):
    gen = torch.Generator().manual_seed(11)
    if kind == "model":
        return tp.PPCATrainer(ds).train(state_size=K, n_iters=n_iters, quiet=True,
                                        generator=gen, **kw)
    return tp.PPCAMixTrainer(ds).train(n_models=M, state_size=K, n_iters=n_iters, quiet=True,
                                       generator=gen, **kw)


def recorded(fn):
    """``fn()``'s result and the ``ppca.*`` ranges it recorded, as (name,
    start ns, end ns) by start, under a profiler started and stopped by
    hand."""
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


def test_no_profiler_no_range(monkeypatch):
    """Off, ``span`` is one flag read and the shared no-op object, and no EM
    step or readout builds a ``record_function``; a started profiler turns
    it on, and its stop turns it off again."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    assert profiling.span("ppca.block") is profiling.NO_SPAN
    ds = dataset()
    model = train("model", ds)
    model.llks(ds)
    assert made == []

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.span("ppca.block") as on:
            assert on is not profiling.NO_SPAN
    finally:
        prof.stop()
    assert made == ["ppca.block"]
    assert profiling.span("ppca.block") is profiling.NO_SPAN


@pytest.mark.parametrize("kind", KINDS)
def test_em_iteration_ranges(kind):
    """One trainer iteration: one ``ppca.em_step`` holding ``ppca.em_stats``
    with one ``ppca.block`` per block of rows, then ``ppca.em_finalize``."""
    ds = dataset()
    _, ranges = recorded(lambda: train(kind, ds))
    (step,) = named(ranges, "ppca.em_step")
    (stats,) = inside(ranges, step, "ppca.em_stats")
    (final,) = inside(ranges, step, "ppca.em_finalize")
    assert stats[2] <= final[1]
    assert len(inside(ranges, stats, "ppca.block")) == len(named(ranges, "ppca.block")) == BLOCKS
    assert named(ranges, "ppca.readout") == []


VERBS = {"model": ("llks", "infer", "smooth", "extrapolate"),
         "mix": ("llks", "infer", "infer_cluster", "smooth", "extrapolate")}
CASES = [(kind, verb) for kind in KINDS for verb in VERBS[kind]]


def _plain(out):
    """The tensors of a readout's result."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tp.Dataset):
        return [out.data]
    if isinstance(out, tp.InferredMaskedMix):
        return [out.log_posteriors()] + [t for inf in out.sub_states()
                                         for t in (inf.states(), inf.covariances_array())]
    return [out.states(), out.covariances_array()]


@pytest.mark.parametrize("kind,verb", CASES)
def test_readout_ranges(kind, verb):
    """A readout verb records one ``ppca.readout`` holding one ``ppca.block``
    per block of rows, and reads out the same values as without a
    profiler."""
    ds = dataset()
    model = train(kind, ds)
    plain = getattr(model, verb)(ds)
    traced, ranges = recorded(lambda: getattr(model, verb)(ds))
    (entry,) = named(ranges, "ppca.readout")
    assert len(inside(ranges, entry, "ppca.block")) == len(named(ranges, "ppca.block")) == BLOCKS
    assert named(ranges, "ppca.em_step") == []
    for a, b in zip(_plain(plain), _plain(traced), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_profile_dir_trace_holds_the_ranges(kind, tmp_path):
    ds = dataset()
    train(kind, ds, profile_dir=str(tmp_path))
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"ppca.em_step", "ppca.em_stats", "ppca.em_finalize", "ppca.block"} <= names


def _params(fitted):
    models = fitted.models if isinstance(fitted, tp.PPCAMix) else [fitted]
    out = [t for m in models for t in (m.transform, m.mean, m.isotropic_noise)]
    return out + ([fitted.log_weights] if isinstance(fitted, tp.PPCAMix) else [])


@pytest.mark.parametrize("kind", KINDS)
def test_em_is_the_same_under_a_profiler(kind):
    """Three EM iterations from one start, with and without a profiler
    recording: bit for bit the same parameters."""
    ds = dataset()
    plain = train(kind, ds, n_iters=3)
    traced, ranges = recorded(lambda: train(kind, ds, n_iters=3))
    assert len(named(ranges, "ppca.em_step")) == 3
    for a, b in zip(_params(plain), _params(traced), strict=True):
        assert torch.equal(a, b)
