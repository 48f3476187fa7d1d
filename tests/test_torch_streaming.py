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

import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import Config
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk

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


def test_streamed_iteration_matches_single_shot_and_jax(rng):
    data, w = make_data(rng), rng.random(90) + 0.5
    jfull, tfull = both(data, w)
    jm, tm = both_models(rng)
    jprior = jp.Prior().with_isotropic_noise_prior(2.0, 2.0)
    tprior = tp.Prior().with_isotropic_noise_prior(2.0, 2.0)

    t_stream, llk_stream = tp.iterate_streamed(tm, list(tfull.chunks(4)), tprior)
    t_full, llk_full = tm._iterate_with_llk(tfull, tprior)
    j_stream, j_llk = jp.iterate_streamed(jm, list(jfull.chunks(4)), jprior)
    assert isinstance(llk_stream, float)
    assert llk_stream == pytest.approx(llk_full, rel=TOL)
    assert llk_stream == pytest.approx(j_llk, rel=TOL)
    close_models(t_stream, t_full)
    close_models(t_stream, j_stream)


def test_streaming_trainer_converges_like_jax(rng):
    """Monotone llk, and from one start the JAX trainer's metrics and
    model."""
    real = rng.normal(size=(8, 2))
    data = rng.normal(size=(600, 2)) @ real.T + 0.2 * rng.normal(size=(600, 8))
    data[rng.random(data.shape) < 0.2] = np.nan
    jfull, tfull = both(data)
    jm, tm = both_models(rng, d=8)
    seen_t, seen_j = [], []
    trained = tp.StreamingPPCATrainer(list(tfull.chunks(5))).train(
        start=tm, state_size=2, n_iters=8, quiet=True, callback=lambda i, m: seen_t.append(m))
    ref = jp.StreamingPPCATrainer(list(jfull.chunks(5))).train(
        start=jm, state_size=2, n_iters=8, quiet=True, callback=lambda i, m: seen_j.append(m))
    llks = [m.llk for m in seen_t]
    assert llks[-1] > llks[0]
    assert all(b >= a - 1e-12 for a, b in zip(llks, llks[1:]))
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


def test_prefetch_levels_bitwise_identical(rng):
    """prefetch changes when the host waits, never what is computed: every
    level reproduces prefetch=0 bit for bit, lazy and resident chunks
    alike; a negative prefetch raises."""
    _, tfull = both(make_data(rng, n=60), rng.random(60) + 0.5)
    parts = [tfull.slice(i * 12, (i + 1) * 12) for i in range(5)]
    _, tm = both_models(rng, k=3)

    def run(prefetch, lazy):
        chunks = [(lambda p=p: p) for p in parts] if lazy else parts
        return tp.iterate_streamed(tm, chunks, prefetch=prefetch)

    for lazy in (False, True):
        m0, llk0 = run(0, lazy)
        for prefetch in (1, 2, 7):
            m, llk = run(prefetch, lazy)
            assert llk == llk0
            for a, b in zip(m._params(), m0._params()):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="prefetch"):
        run(-1, True)
    with pytest.raises(ValueError, match="chunk"):
        tp.iterate_streamed(tm, [])


def test_dense_pattern_and_masked_chunks_mix(rng):
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
    tparts = [tp.Dataset(x, dtype=torch.float64) for x in (dense_part, pdata, masked_part)]
    assert tparts[0].all_observed() and tparts[1].pattern_info() is not None
    assert tparts[2].pattern_info() is None
    jm, tm = both_models(rng, d=d)

    t_stream, t_llk = tp.iterate_streamed(tm, tparts)
    j_stream, j_llk = jp.iterate_streamed(jm, jparts)
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


def test_mix_streamed_matches_jax(rng):
    """Streamed mixture EM against the JAX package's and the single-shot
    fused EM (resp_max max-combines across chunks), with priors and
    heterogeneous component state sizes."""
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

    t1, tl1 = tp.iterate_mix_streamed(tmix, list(tfull.chunks(3)), tprior)
    j1, jl1 = jp.iterate_mix_streamed(jmix, list(jfull.chunks(3)), jprior)
    t2, tl2 = tmix._iterate_with_llk(tfull, tprior)
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

