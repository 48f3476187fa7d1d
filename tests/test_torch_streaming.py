"""The port's out-of-core streaming EM (ppca_rs_tpu_torch.streaming) against
the JAX package's, both in float64 on the CPU.

Mirrors the single-device tests of tests/test_streaming.py: the streamed
iteration equals the single-shot one and the JAX package's
``iterate_streamed``, the trainer is monotone, lazy chunks resolve in
order, prefetch levels are bit-identical, dense, pattern and masked chunks
mix, mixtures stream, and the trainers checkpoint, resume and trace.  Both
packages get the same numpy inputs from a seed.  Tolerance: 1e-9 relative,
the parity budget of docs/DESIGN.md section 6.
"""

import functools

import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop, streaming
from ppca_rs_tpu_torch.config import Config
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.ops import mix_fused as tmf

torch.set_num_threads(1)

TOL = 1e-9


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=TOL):
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def make_data(rng, n=90, d=6, missing=0.3):
    data = rng.normal(size=(n, d)) + rng.normal(size=d)
    data[rng.random((n, d)) < missing] = np.nan
    return data


def both(data, weights=None):
    """The same NaN-holed array as a JAX and a port dataset (float64)."""
    return jp.Dataset(data, weights=weights), tp.Dataset(data, weights=weights, dtype=torch.float64)


def both_models(rng, d=6, k=2, noise=0.5):
    C, mean = rng.normal(size=(d, k)), rng.normal(size=d)
    return (jp.PPCAModel(isotropic_noise=noise, transform=C, mean=mean),
            interop.model_from_arrays(C, mean, noise))


def close_models(t, j, rtol=TOL):
    close(t.transform, j.transform, rtol)
    close(t.mean, j.mean, rtol)
    assert float(t.isotropic_noise) == pytest.approx(float(j.isotropic_noise), rel=rtol)


def engage_slicing(monkeypatch, block=8, segment_rows=20):
    """Every chunk counts as held on another device, so that it is copied
    (on the CPU: a new dataset over the same tensors), and slices hold
    ``segment_rows`` rounded down to whole blocks of ``block`` rows."""
    monkeypatch.setattr(streaming._Transfer, "brings", lambda self, ds: True)
    monkeypatch.setattr(tconfig, "block_size", block)
    monkeypatch.setattr(tconfig, "segment_rows", lambda D, itemsize: segment_rows)


def slicings(monkeypatch, **sizes):
    """Runs a test's body twice: with resident chunks (False), then with
    every chunk copied in slices (True, :func:`engage_slicing` with
    ``sizes``), ``streaming.COUNTS`` reset before each."""
    streaming.reset_counts()
    yield False
    with monkeypatch.context() as patched:
        engage_slicing(patched, **sizes)
        streaming.reset_counts()
        yield True


def test_streamed_iteration_matches_single_shot_and_jax(rng, monkeypatch):
    """With resident chunks and with chunks copied in slices (8 rows: 4
    chunks of 22-23 rows, 2 slices each, the tail joining the second)."""
    data, w = make_data(rng), rng.random(90) + 0.5
    jfull, tfull = both(data, w)
    jm, tm = both_models(rng)
    jprior = jp.Prior().with_isotropic_noise_prior(2.0, 2.0)
    tprior = tp.Prior().with_isotropic_noise_prior(2.0, 2.0)
    j_stream, j_llk = jp.iterate_streamed(jm, list(jfull.chunks(4)), jprior)

    for sliced in slicings(monkeypatch, segment_rows=10):
        t_stream, llk_stream = tp.iterate_streamed(tm, list(tfull.chunks(4)), tprior)
        t_full, llk_full = tm._iterate_with_llk(tfull, tprior)
        assert streaming.COUNTS["slices"] == (8 if sliced else 0)
        assert isinstance(llk_stream, float)
        assert llk_stream == pytest.approx(llk_full, rel=TOL)
        assert llk_stream == pytest.approx(j_llk, rel=TOL)
        close_models(t_stream, t_full)
        close_models(t_stream, j_stream)


def test_streaming_trainer_converges_like_jax(rng, monkeypatch):
    """Monotone llk, and from one start the JAX trainer's metrics and
    model; with resident chunks, and with chunks copied in slices (48
    rows: 5 chunks of 120 rows, 3 slices each, from the first pass on),
    each chunk's route decided once."""
    real = rng.normal(size=(8, 2))
    data = rng.normal(size=(600, 2)) @ real.T + 0.2 * rng.normal(size=(600, 8))
    data[rng.random(data.shape) < 0.2] = np.nan
    jfull, tfull = both(data)
    jm, tm = both_models(rng, d=8)
    seen_j = []
    ref = jp.StreamingPPCATrainer(list(jfull.chunks(5))).train(
        start=jm, state_size=2, n_iters=8, quiet=True, callback=lambda i, m: seen_j.append(m))
    for sliced in slicings(monkeypatch, segment_rows=50):
        seen_t = []
        trained = tp.StreamingPPCATrainer(list(tfull.chunks(5))).train(
            start=tm, state_size=2, n_iters=8, quiet=True, callback=lambda i, m: seen_t.append(m))
        # 8 iterations and the closing llk, which is no streamed pass
        assert streaming.COUNTS == ({"slices": 8 * 15, "routes": 5} if sliced
                                    else {"slices": 0, "routes": 0})
        llks = [m.llk for m in seen_t]
        assert llks[-1] > llks[0]
        assert all(b >= a - 1e-12 for a, b in zip(llks, llks[1:]))
        assert len(seen_t) == len(seen_j) == 8
        for a, b in zip(seen_t, seen_j):
            for f in ("llk", "aic", "bic"):
                assert getattr(a, f) == pytest.approx(getattr(b, f), rel=TOL)
        assert trained.state_size == 2
        close_models(trained, ref)


def test_lazy_chunk_callables_resolve_in_order(rng):
    data = make_data(rng, n=40)
    _, tfull = both(data)
    parts = [tfull.slice(0, 20), tfull.slice(20, 40)]
    calls = []

    def lazy(i):
        def load():
            calls.append(i)
            return parts[i]
        return load

    _, tm = both_models(rng)
    m1, llk1 = tp.iterate_streamed(tm, [lazy(0), lazy(1)])
    m2, llk2 = tm._iterate_with_llk(tfull, None)
    assert calls == [0, 1]
    assert llk1 == pytest.approx(llk2, rel=TOL)
    close_models(m1, m2)


def test_prefetch_levels_bitwise_identical(rng, monkeypatch):
    """prefetch changes when the host waits, never what is computed: every
    level reproduces prefetch=0 bit for bit, lazy and resident chunks
    alike, and chunks copied in slices too; a negative prefetch raises."""
    _, tfull = both(make_data(rng, n=60), rng.random(60) + 0.5)
    parts = [tfull.slice(i * 12, (i + 1) * 12) for i in range(5)]
    _, tm = both_models(rng, k=3)

    def run(prefetch, lazy):
        chunks = [(lambda p=p: p) for p in parts] if lazy else parts
        return tp.iterate_streamed(tm, chunks, prefetch=prefetch)

    for sliced in (False, True):
        if sliced:
            engage_slicing(monkeypatch, block=4, segment_rows=4)
        for lazy in (False, True):
            streaming.reset_counts()
            m0, llk0 = run(0, lazy)
            assert streaming.COUNTS == {"slices": 10 if sliced else 0, "routes": 0}
            for prefetch in (1, 2, 7):
                m, llk = run(prefetch, lazy)
                assert llk == llk0
                for a, b in zip(m._params(), m0._params()):
                    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="prefetch"):
        run(-1, True)
    with pytest.raises(ValueError, match="chunk"):
        tp.iterate_streamed(tm, [])


def kind_chunk(rng, kind, n=70, d=12):
    """A float64 host chunk of ``n`` rows taking route ``kind``: every entry
    observed, rows from two mask patterns, or 30% missing at random."""
    data = rng.normal(size=(n, d)) + rng.normal(size=d)
    if kind == "pattern":
        pat = rng.random((2, d)) < 0.4
        data[pat[rng.integers(0, 2, size=n)]] = np.nan
    elif kind == "masked":
        data[rng.random((n, d)) < 0.3] = np.nan
    return tp.Dataset(data, weights=rng.random(n) + 0.5, dtype=torch.float64)


def pass_fns(rng, model, d=12):
    """``(stats_fn, add_fn)`` of a streamed pass of a single model or of a
    two-component mixture with state sizes 2 and 3."""
    if model == "single":
        _, tm = both_models(rng, d=d, k=3)
        return (lambda ds: streaming._chunk_stats(tm, ds)), streaming._stats_add
    mix = interop.mix_from_arrays([rng.normal(size=(d, k)) for k in (2, 3)],
                                  [rng.normal(size=d) for _ in range(2)], [0.4, 0.6],
                                  rng.normal(size=2))
    params = mix._stacked_params()
    return (lambda ds: mix._em_stats(ds, *params, **mix._route_args(ds, params[0]))), \
        tmf._accumulate


@pytest.mark.parametrize("kind,model", [("masked", "single"), ("pattern", "single"),
                                        ("dense", "single"), ("masked", "mix"),
                                        ("pattern", "mix"), ("dense", "mix")])
def test_slices_sum_to_the_whole_chunk_without_deciding_a_route(rng, monkeypatch, kind, model):
    """A host chunk is copied in slices (16 rows: 20 rounded down to blocks
    of 8; the 6-row tail joins the slice before) from its first pass on,
    whose statistics add up to the whole chunk's in float64.  The first
    pass decides the chunk's route once, on its mask, and records it on the
    chunk; the next decides none: no pattern detection, no look at the mask
    for ``all_observed``."""
    from ppca_rs_tpu_torch import dataset as tdataset

    engage_slicing(monkeypatch)
    chunk = kind_chunk(rng, kind)
    stats_fn, add_fn = pass_fns(rng, model)
    whole = stats_fn(tp.Dataset.from_parts(chunk.data, chunk.mask, chunk.weights_dev))
    streaming.reset_counts()
    first, n = streaming._accumulate([chunk], torch.device("cpu"), stats_fn, add_fn, 1)
    assert streaming.COUNTS == {"slices": 4, "routes": 1} and n == 70
    assert chunk._all_observed is (kind == "dense")
    assert (chunk._patterns is False) if kind == "masked" else True
    assert bool(chunk._patterns) is (kind == "pattern")

    decided = []
    detect, observed = tdataset._detect_patterns, tp.Dataset.all_observed
    monkeypatch.setattr(tdataset, "_detect_patterns",
                        lambda *a: decided.append("patterns") or detect(*a))
    monkeypatch.setattr(tp.Dataset, "all_observed", lambda self: (
        self._all_observed is None and decided.append("all_observed")) or observed(self))
    blocks = []
    real_blocks = tml._blocks
    monkeypatch.setattr(tml, "_blocks", lambda n, size: blocks.append(n) or real_blocks(n, size))
    streaming.reset_counts()
    sliced, n = streaming._accumulate([chunk], torch.device("cpu"), stats_fn, add_fn, 1)
    assert streaming.COUNTS == {"slices": 4, "routes": 0} and n == 70
    assert decided == []
    if (kind, model) == ("masked", "single"):
        assert blocks == [16, 16, 16, 22]   # the masked route's block loop, once a slice
    for field in whole._fields:
        close(getattr(first, field), getattr(whole, field), 1e-12)
        assert torch.equal(getattr(sliced, field), getattr(first, field))


class Event:
    """Stands in for a card's event after the statistics of piece ``i``:
    the host's wait for it is logged."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def synchronize(self):
        self.log.append(("wait", self.i))


def log_events(monkeypatch, log):
    """``_Transfer.event`` returns an :class:`Event` after the statistics
    logged so far."""
    monkeypatch.setattr(streaming._Transfer, "event", lambda self: Event(
        log, sum(what == "stats" for what, _ in log) - 1))


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_copies_run_ahead_of_the_statistics(rng, monkeypatch, prefetch):
    """The order of a pass's copies, statistics and waits (events stand in
    for the card's): the host copies slice i + 1 before it enqueues slice
    i's statistics (at ``prefetch >= 1``), the compute stream waiting for
    slice i's copy alone just before them, then waits for slice i -
    ``prefetch``'s, so that at most ``prefetch + 2`` slices are held (one
    at ``prefetch=0``); the first pass as the next, each chunk's route
    decided when its first slice is looked at, and a new chunk's the
    same."""
    engage_slicing(monkeypatch)
    log = []
    log_events(monkeypatch, log)
    copy, decide = streaming._Transfer.__call__, streaming._Transfer.decide_route

    def copying(self, ds):
        log.append(("copy", len(ds)))
        out = copy(self, ds)
        self.copied = ("copied", sum(what == "copy" for what, _ in log))   # for the event
        return out

    monkeypatch.setattr(streaming._Transfer, "__call__", copying)
    monkeypatch.setattr(streaming._Transfer, "wait",
                        lambda self, copied: log.append(("use", copied[1])))

    def deciding(self, ds):
        if not streaming._route_known(ds):
            log.append(("route", len(ds)))
        decide(self, ds)

    monkeypatch.setattr(streaming._Transfer, "decide_route", deciding)
    _, tm = both_models(rng, d=12, k=3)
    chunks = [kind_chunk(rng, "masked", n=64) for _ in range(2)]

    def stats(ds):
        log.append(("stats", len(ds)))
        return streaming._chunk_stats(tm, ds)

    def run():
        log.clear()
        streaming.reset_counts()
        streaming._accumulate(chunks, torch.device("cpu"), stats, streaming._stats_add, prefetch)
        # the compute stream waits for a slice's copy just before its statistics
        uses = [i for what, i in log if what == "use"]
        assert uses == list(range(1, len(uses) + 1))
        assert all(log[at + 1][0] == "stats" for at, (what, _) in enumerate(log) if what == "use")
        return [what if what != "wait" else i for what, i in log if what != "use"]

    def check(order, pieces, routes):
        assert order.count("copy") == order.count("stats") == pieces
        assert order.count("route") == routes
        copied = finished = reduced = 0
        for what in order:
            if what == "copy":
                copied += 1
                assert copied - finished <= (prefetch + 2 if prefetch else 1)
                assert reduced - finished <= prefetch
            elif what == "stats":
                assert copied - reduced == (min(2, pieces - reduced) if prefetch else 1)
                reduced += 1
            elif what != "route":
                assert what == finished and what < reduced
                finished += 1

    first = run()
    assert streaming.COUNTS == {"slices": 8, "routes": 2}
    check(first, 8, 2)
    again = run()
    assert streaming.COUNTS == {"slices": 8, "routes": 0}
    assert [what for what in first if what != "route"] == again
    if prefetch == 1:
        assert first[:10] == ["route", "copy", "copy", "stats", "copy", "stats", 0, "copy",
                              "stats", 1]
    # a new chunk between the two: its route decided when the slice before
    # it looks one ahead, then copied in slices like the others
    chunks.insert(1, kind_chunk(rng, "masked", n=64))
    order = run()
    assert streaming.COUNTS == {"slices": 12, "routes": 1}
    check(order, 12, 1)
    at = order.index("route")
    assert order[:at].count("copy") == 4 and order[at + 1] == "copy"
    assert order[:at].count("stats") == (3 if prefetch else 4)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_chunks_made_by_callables_are_held_one_past_prefetch(rng, monkeypatch, prefetch):
    """A callable that makes its chunk on the device is called when the
    pass reaches it, not one ahead as a slice is copied: the host has
    waited for all but ``prefetch`` of the chunks made before, so at most
    ``prefetch + 1`` are held."""
    log = []
    log_events(monkeypatch, log)
    _, tm = both_models(rng, d=12, k=3)
    parts = [kind_chunk(rng, "masked", n=16) for _ in range(6)]

    def make(i):
        log.append(("make", i))
        return parts[i]

    def stats(ds):
        log.append(("stats", len(ds)))
        return streaming._chunk_stats(tm, ds)

    chunks = [functools.partial(make, i) for i in range(6)]
    streaming.reset_counts()
    streaming._accumulate(chunks, torch.device("cpu"), stats, streaming._stats_add, prefetch)
    assert streaming.COUNTS == {"slices": 0, "routes": 0}
    made = finished = 0
    for what, i in log:
        if what == "make":
            made += 1
            assert made - finished <= prefetch + 1
        elif what == "wait":
            finished += 1
    order = [what for what, _ in log if what != "wait"]
    assert made == 6 and order == ["make", "stats"] * 6


@pytest.mark.parametrize("n,d,dtype", [(1_048_576, 1024, torch.float32),
                                       (1_048_577, 1024, torch.float32),
                                       (1_000_003, 1024, torch.float32),
                                       (700_000, 512, torch.bfloat16)])
def test_slices_are_whole_blocks(n, d, dtype):
    """At the default sizes a slice holds 512 MiB of values in whole blocks
    of 8,192 rows (131,072 rows at D=1024 in float32, 524,288 at D=512 in
    bfloat16), so its blocks are the chunk's for every route's block rows;
    the slices tile the chunk, a tail under 8 rows joining the one
    before."""
    data = torch.zeros((), dtype=dtype).expand(n, d)
    chunk = tp.Dataset.from_parts(data, torch.ones((), dtype=torch.bool).expand(n, d))
    chunk._all_observed = False
    chunk._patterns = (torch.arange(n), torch.ones((1, d), dtype=torch.bool))
    pieces = streaming._slices(chunk)
    starts = [p.weights_dev.storage_offset() for p in pieces]
    lengths = [len(p) for p in pieces]
    step = tconfig.segment_rows(d, data.element_size())
    assert step % tconfig.block_size == 0 and step == (1 << 29) // (d * data.element_size())
    assert starts == list(range(0, n - 8, step)) and sum(lengths) == n
    assert all(start % tconfig.block_rows(k, 4) == 0 for start in starts for k in (64, 128, 256))
    assert all(length == step for length in lengths[:-1]) and lengths[-1] < step + 8
    for p, start in zip(pieces, starts):
        assert torch.equal(p._patterns[0], torch.arange(start, start + len(p)))
        assert p._patterns[1] is chunk._patterns[1] and p._all_observed is False


def test_dense_pattern_and_masked_chunks_mix(rng, monkeypatch):
    """A fully observed chunk takes the dense pass, a chunk with repeating
    masks the pattern tables, the rest the masked pass: together they give
    the single-shot iteration on the concatenation and the JAX package's
    streamed one."""
    from ppca_rs_tpu_torch.streaming import _chunk_stats

    d = 6
    dense_part = rng.normal(size=(32, d))
    pat = rng.random((2, d)) < 0.4
    pdata = rng.normal(size=(32, d))
    pdata[pat[rng.integers(0, 2, size=32)]] = np.nan
    masked_part = make_data(rng, n=32, d=d)
    jparts = [jp.Dataset(x) for x in (dense_part, pdata, masked_part)]
    jm, tm = both_models(rng, d=d)
    j_stream, j_llk = jp.iterate_streamed(jm, jparts)

    # resident, then copied in slices of 16 rows (2 a chunk), whose routes
    # are their chunk's: decided once on each chunk's mask, recorded on it
    for sliced in slicings(monkeypatch):
        tparts = [tp.Dataset(x, dtype=torch.float64) for x in (dense_part, pdata, masked_part)]
        t_stream, t_llk = tp.iterate_streamed(tm, tparts)
        assert streaming.COUNTS == ({"slices": 6, "routes": 3} if sliced
                                    else {"slices": 0, "routes": 0})
        assert tparts[0].all_observed() and tparts[1].pattern_info() is not None
        assert tparts[2].pattern_info() is None
        t_full, t_full_llk = tm._iterate_with_llk(tp.Dataset.concat(tparts), None)
        assert t_llk == pytest.approx(j_llk, rel=TOL)
        assert t_llk == pytest.approx(t_full_llk, rel=TOL)
        close_models(t_stream, j_stream)
        close_models(t_stream, t_full)
    # the dense pass in the common form: every row of S is S_common
    st = _chunk_stats(tm, tparts[0])
    assert torch.equal(st.S, st.S[:1].expand_as(st.S))
    assert torch.equal(st.totals, st.totals[:1].expand_as(st.totals))


def test_streamed_chunks_launch_no_kernel_on_cpu(rng):
    _, tfull = both(make_data(rng))
    _, tm = both_models(rng)
    tk.reset_launch_counts()
    tp.StreamingPPCATrainer(list(tfull.chunks(3))).train(start=tm, state_size=2, n_iters=2,
                                                         quiet=True)
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def test_mix_streamed_matches_jax(rng, monkeypatch):
    """Streamed mixture EM against the JAX package's and the single-shot
    fused EM (resp_max max-combines across chunks), with priors and
    heterogeneous component state sizes; with resident chunks, and with
    chunks copied in slices (16 rows: 3 chunks of 40 rows, 3 slices
    each)."""
    data, w = make_data(rng, n=120), rng.random(120) + 0.3
    jfull, tfull = both(data, w)
    Cs = [rng.normal(size=(6, k)) for k in (2, 3)]
    means = [rng.normal(size=6) for _ in Cs]
    noises, logw = [0.4, 0.5], rng.normal(size=2)
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=mu)
                       for C, mu, s in zip(Cs, means, noises)], logw)
    tmix = interop.mix_from_arrays(Cs, means, noises, logw)
    jprior = jp.Prior().with_isotropic_noise_prior(3.0, 2.0).with_transformation_precision(0.05)
    tprior = tp.Prior().with_isotropic_noise_prior(3.0, 2.0).with_transformation_precision(0.05)

    j1, jl1 = jp.iterate_mix_streamed(jmix, list(jfull.chunks(3)), jprior)
    t2, tl2 = tmix._iterate_with_llk(tfull, tprior)

    for sliced in slicings(monkeypatch):
        t1, tl1 = tp.iterate_mix_streamed(tmix, list(tfull.chunks(3)), tprior)
        assert streaming.COUNTS["slices"] == (9 if sliced else 0)
        assert tl1 == pytest.approx(jl1, rel=TOL)
        assert tl1 == pytest.approx(tl2, rel=TOL)
        for a, b, c in zip(t1.models, j1.models, t2.models):
            close_models(a, b)
            close_models(a, c)
        close(t1.log_weights, j1.log_weights)

        trained = tp.StreamingPPCAMixTrainer(list(tfull.chunks(3))).train(
            n_models=2, state_size=2, n_iters=3, quiet=True,
            generator=torch.Generator().manual_seed(3))
        assert np.isfinite(trained.llk(tfull))


def test_trainer_checkpoint_resume_and_profile(rng, tmp_path):
    """The streaming trainers checkpoint, resume from a checkpoint as a warm
    start, and trace into profile_dir."""
    _, tfull = both(make_data(rng))
    chunks = list(tfull.chunks(3))
    path = tmp_path / "stream.ppca"
    trained = tp.StreamingPPCATrainer(chunks).train(
        state_size=2, n_iters=4, quiet=True, checkpoint_path=str(path), checkpoint_every=2,
        profile_dir=str(tmp_path / "trace"), generator=torch.Generator().manual_seed(5))
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    restored = tp.PPCAModel.load(path.read_bytes(), dtype=torch.float64)
    assert restored.state_size == 2
    # the final checkpoint is the state before canonicalization
    close(restored.to_canonical().transform, trained.transform, 1e-12)
    resumed = tp.StreamingPPCATrainer(chunks).train(start=restored, state_size=2, n_iters=1,
                                                    quiet=True)
    assert np.isfinite(resumed.llk(tfull))

    mpath = tmp_path / "stream_mix.ppca"
    tp.StreamingPPCAMixTrainer(chunks).train(n_models=2, state_size=2, n_iters=3, quiet=True,
                                             checkpoint_path=str(mpath), checkpoint_every=2)
    rmix = tp.PPCAMix.load(mpath.read_bytes(), dtype=torch.float64)
    assert len(rmix.models) == 2
    resumed_mix = tp.StreamingPPCAMixTrainer(chunks).train(start=rmix, n_models=2, state_size=2,
                                                           n_iters=1, quiet=True)
    assert np.isfinite(resumed_mix.llk(tfull))


def test_trainer_printout(rng, capsys):
    _, tfull = both(make_data(rng))
    tp.StreamingPPCATrainer(list(tfull.chunks(2))).train(state_size=2, n_iters=2, metric="llk")
    tp.StreamingPPCAMixTrainer(list(tfull.chunks(2))).train(n_models=2, state_size=1, n_iters=1)
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out if "iteration" in line] == [
        "Masked PPCA iteration 1", "Masked PPCA iteration 2", "Masked PPCA mix iteration 1"]


@pytest.mark.parametrize("trainer", ["single", "mix"])
def test_host_chunks_without_a_card_raise(monkeypatch, trainer):
    """With the default device and no card, training on host chunks
    raises: the model is built on config.device, never on the chunks' CPU."""
    chunks = list(tp.Dataset(np.ones((8, 3)), device="cpu").chunks(2))
    monkeypatch.setattr(tconfig, "device", Config().device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if trainer == "single":
            tp.StreamingPPCATrainer(chunks).train(state_size=1, n_iters=1, quiet=True)
        else:
            tp.StreamingPPCAMixTrainer(chunks).train(n_models=2, state_size=1, n_iters=1,
                                                     quiet=True)


def test_chunks_follow_the_model_device(rng, monkeypatch):
    """Chunks move to the model's device: a model on the meta device takes
    the chunks there (no computation falls back to the chunks' CPU)."""
    from ppca_rs_tpu_torch.streaming import _Transfer

    _, tfull = both(make_data(rng, n=12))
    moved = _Transfer(torch.device("meta"))(tfull)
    assert moved.device.type == "meta" and moved.mask.device.type == "meta"
    assert _Transfer(torch.device("cpu"))(tfull) is tfull


def example_chunks(seed0=0, chunk=2000, n_chunks=3):
    """examples/streaming_out_of_core.py's data at its smoke size: 64
    dimensions, a rank-4 model plus noise 0.3, 20% missing; one array per
    chunk."""
    rng = np.random.default_rng(seed0)
    C_true = rng.normal(size=(64, 4))
    out = []
    for s in range(n_chunks):
        r = np.random.default_rng(s)
        data = r.normal(size=(chunk, 4)) @ C_true.T + 0.3 * r.normal(size=(chunk, 64))
        data[r.random(data.shape) < 0.2] = np.nan
        out.append(data)
    return out


def test_example_shapes_through_both_packages(rng):
    """The example's shapes (3 lazy chunks of 2,000 rows, D=64, k=4, 20%
    missing) from one start through both packages' streaming trainers."""
    arrays = example_chunks()
    jm, tm = both_models(rng, d=64, k=4, noise=1.0)
    seen_t, seen_j = [], []
    t = tp.StreamingPPCATrainer([(lambda a=a: tp.Dataset(a, dtype=torch.float64)) for a in arrays]
                                ).train(start=tm, state_size=4, n_iters=3, quiet=True,
                                        callback=lambda i, m: seen_t.append(m.llk))
    j = jp.StreamingPPCATrainer([(lambda a=a: jp.Dataset(a)) for a in arrays]).train(
        start=jm, state_size=4, n_iters=3, quiet=True, callback=lambda i, m: seen_j.append(m.llk))
    np.testing.assert_allclose(seen_t, seen_j, rtol=TOL)
    close_models(t, j)

