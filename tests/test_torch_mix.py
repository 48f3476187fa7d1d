"""The port's PPCA mixtures (ppca_rs_tpu_torch: PPCAMix, InferredMaskedMix,
PosteriorSamplerMix, PPCAMixTrainer) against the JAX package, both in
float64 on the CPU.

Both packages get identical state: numpy inputs from a seed, the port's
mixture through ppca_rs_tpu_torch.interop.mix_from_arrays.  The data holds
an all-masked row and a zero-weight row.  Each route is held: the general
masked route (random masks), the table route (rows drawn from P=3 mask
patterns) and the dense route (fully observed data: the table route with
P=1).  Tolerance: 1e-9 relative, the parity budget of docs/DESIGN.md
section 6.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
ROUTES = ("masked", "table", "dense")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=TOL):
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def make_data(rng, route="masked", N=60, D=7):
    """(data zero-filled where masked, mask, weights) for ``route``: a
    zero-weight row always, an all-masked row on the masked and table
    routes (on the table route it is one of the three patterns)."""
    data = rng.normal(size=(N, D)) + 2.0 * rng.normal(size=(1, D)) * (rng.random((N, 1)) < 0.5)
    if route == "masked":
        mask = rng.random((N, D)) > 0.3
        mask[4] = False
    elif route == "table":
        patterns = rng.random((3, D)) > 0.35
        patterns[0] = True
        patterns[2] = False
        mask = patterns[rng.integers(0, 3, size=N)]
        mask[:3] = patterns
    else:
        mask = np.ones((N, D), dtype=bool)
    weights = rng.random(N) + 0.5
    weights[7] = 0.0
    return np.where(mask, data, 0.0), mask, weights


def both_datasets(data, mask, weights):
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(weights))
    return jds, interop.dataset_from_arrays(data, mask, weights)


def make_params(rng, M=3, D=7, ks=None):
    ks = ks or [2] * M
    return ([rng.normal(size=(D, k)) for k in ks], [rng.normal(size=D) for _ in ks],
            [0.4 + 0.15 * i for i in range(len(ks))], rng.normal(size=len(ks)))


def both_mixes(params):
    Cs, means, noises, lw = params
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in zip(Cs, means, noises)], lw)
    return jmix, interop.mix_from_arrays(Cs, means, noises, lw)


def assert_mix_close(tmix, jmix, rtol=TOL):
    assert tmix.state_sizes == jmix.state_sizes
    close(tmix.log_weights, jmix.log_weights, rtol)
    for a, b in zip(tmix.models, jmix.models):
        close(a.transform, b.transform, rtol)
        close(a.mean, b.mean, rtol)
        assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=rtol)


def make_prior(kind, rng, D=7):
    tprior, jprior = tp.Prior(), jp.Prior()
    if kind in ("noise", "all"):
        tprior, jprior = (p.with_isotropic_noise_prior(2.0, 3.0) for p in (tprior, jprior))
    if kind in ("transformation", "all"):
        tprior, jprior = (p.with_transformation_precision(0.3) for p in (tprior, jprior))
    if kind in ("mean", "all"):
        pm, pcov = rng.normal(size=D), np.eye(D) * 0.8
        tprior, jprior = (p.with_mean_prior(pm, pcov) for p in (tprior, jprior))
    return tprior, jprior


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("M", [1, 3])
def test_readouts_match(rng, route, M):
    data, mask, weights = make_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng, M))
    assert (routes.route(tds, mixture=True).kind == "masked") == (route == "masked")
    close(tmix.llks(tds), jmix.llks(jds))
    assert tmix.llk(tds) == pytest.approx(jmix.llk(jds), rel=TOL)
    close(tmix.infer_cluster(tds), jmix.infer_cluster(jds))
    ti, ji = tmix.infer(tds), jmix.infer(jds)
    close(ti.log_posteriors(), ji.log_posteriors())
    for a, b in zip(ti.sub_states(), ji.sub_states()):
        close(a.states(), b.states())
        close(a.covariances_array(), b.covariances_array())
    close(tmix.smooth(tds).numpy(), jmix.smooth(jds).numpy())
    close(tmix.extrapolate(tds).numpy(), jmix.extrapolate(jds).numpy())


@pytest.mark.parametrize("reference_log_weighting", [False, True])
def test_inferred_mix_readouts_match(rng, reference_log_weighting):
    data, mask, weights = make_data(rng)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng))
    ti, ji = tmix.infer(tds), jmix.infer(jds)
    close(ti.states(reference_log_weighting=reference_log_weighting),
          ji.states(reference_log_weighting=reference_log_weighting))
    close(ti.posteriors(), ji.posteriors())
    close(torch.stack(ti.covariances()), np.stack(ji.covariances()))
    close(torch.stack(ti.second_moments()), np.stack(ji.second_moments()))
    close(ti.smoothed(tmix).numpy(), ji.smoothed(jmix).numpy())
    close(ti.extrapolated(tmix, tds).numpy(), ji.extrapolated(jmix, jds).numpy())
    close(torch.stack(ti.smoothed_covariances(tmix)), np.stack(ji.smoothed_covariances(jmix)))
    close(ti.smoothed_covariances_diagonal(tmix).numpy(),
          ji.smoothed_covariances_diagonal(jmix).numpy())
    close(torch.stack(ti.extrapolated_covariances(tmix, tds)),
          np.stack(ji.extrapolated_covariances(jmix, jds)))
    close(ti.extrapolated_covariances_diagonal(tmix, tds).numpy(),
          ji.extrapolated_covariances_diagonal(jmix, jds).numpy())
    assert len(ti) == len(tds)


@pytest.mark.parametrize("prior", ["none", "noise", "transformation", "mean", "all"])
@pytest.mark.parametrize("route", ROUTES)
def test_em_step_matches(rng, route, prior):
    """One fused EM step on each route, with each prior alone and all three."""
    data, mask, weights = make_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng))
    tprior, jprior = make_prior(prior, rng)
    tnew, tllk = tmix._iterate_with_llk(tds, tprior)
    jnew, jllk = jmix._iterate_with_llk(jds, jprior)
    assert tllk == pytest.approx(jllk, rel=TOL)
    assert_mix_close(tnew, jnew)
    assert_mix_close(tmix.iterate_with_prior(tds, tprior), jnew)


@pytest.mark.parametrize("route", ROUTES)
def test_fused_step_matches_own_loop(rng, route):
    """The fused step against the port's reference-shaped loop over its own
    single-model EM, with all three priors (the weight scaling sets their
    strength)."""
    data, mask, weights = make_data(rng, route)
    tds = interop.dataset_from_arrays(data, mask, weights)
    _, tmix = both_mixes(make_params(rng))
    tprior, _ = make_prior("all", rng)
    fused, llk_f = tmix._iterate_with_llk(tds, tprior)
    loop, llk_l = tmix._iterate_loop(tds, tprior)
    assert llk_f == pytest.approx(llk_l, rel=TOL)
    assert_mix_close(fused, loop)


def test_heterogeneous_state_sizes(rng):
    """Components of k = 1 and 3 ride one fused pass zero-padded; every
    result is sliced back and matches the JAX package."""
    data, mask, weights = make_data(rng)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng, ks=[1, 3]))
    close(tmix.llks(tds), jmix.llks(jds))
    ti, ji = tmix.infer(tds), jmix.infer(jds)
    for a, b, k in zip(ti.sub_states(), ji.sub_states(), (1, 3)):
        assert a.states().shape == (len(tds), k)
        close(a.covariances_array(), b.covariances_array())
    close(tmix.smooth(tds).numpy(), jmix.smooth(jds).numpy())
    tprior, jprior = make_prior("all", rng)
    for tp_, jp_ in ((tp.Prior(), jp.Prior()), (tprior, jprior)):
        tnew, tllk = tmix._iterate_with_llk(tds, tp_)
        jnew, jllk = jmix._iterate_with_llk(jds, jp_)
        assert tnew.state_sizes == [1, 3] and tllk == pytest.approx(jllk, rel=TOL)
        assert_mix_close(tnew, jnew)
        assert_mix_close(tnew, tmix._iterate_loop(tds, tp_)[0])
    with pytest.raises(ValueError, match="share a state size"):
        ti.states()


@pytest.mark.parametrize("route", ROUTES)
def test_state_size_zero_components(rng, route):
    """Every component at state size 0 (noise-only clusters) on each route:
    the readouts match the JAX package, and one EM step matches the port's
    per-component loop and, on the masked route, the JAX package (whose
    table route fails on it).  ``smooth`` and the table route's EM step
    used to fail reshaping 0 elements."""
    data, mask, weights = make_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng, ks=[0, 0]))
    close(tmix.llks(tds), jmix.llks(jds))
    close(tmix.smooth(tds).numpy(), jmix.smooth(jds).numpy())
    close(tmix.extrapolate(tds).numpy(), jmix.extrapolate(jds).numpy())
    tnew, tllk = tmix._iterate_with_llk(tds, tp.Prior())
    refs = [tmix._iterate_loop(tds, tp.Prior())]
    if route == "masked":
        refs.append(jmix._iterate_with_llk(jds, jp.Prior()))
    for ref, ref_llk in refs:
        assert tnew.state_sizes == ref.state_sizes == [0, 0]
        assert tllk == pytest.approx(ref_llk, rel=TOL)
        close(tnew.log_weights, ref.log_weights)
        for a, b in zip(tnew.models, ref.models):
            close(a.mean, b.mean)
            assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=TOL)


@pytest.mark.parametrize("exact_rnorm", [False, True])
def test_dead_component_keeps_params(rng, monkeypatch, exact_rnorm):
    """A component ~1e6 away from every row gets responsibility exactly 0:
    it keeps its parameters, its weight goes to 0, the other component is
    whole and matches the JAX package, with and without priors.

    The average of the means sits 5e5 from the data, so the default block's
    expanded |r|^2 cancels from ~1e12 (config.mix_exact_rnorm) in both
    packages, each in its own summation order: there dev_sq agrees to ~1e-5
    and the noise (and, through the mean prior, the mean) to 1e-4 relative.  With mix_exact_rnorm in both, to 1e-9
    (the JAX package reads the flag when it traces, hence the cleared
    caches)."""
    import jax
    from ppca_rs_tpu.config import config as jconfig

    monkeypatch.setattr(tconfig, "mix_exact_rnorm", exact_rnorm)
    noise_tol = TOL if exact_rnorm else 1e-4
    D = 4
    data = rng.normal(size=(50, D))
    mask = rng.random((50, D)) > 0.2
    jds, tds = both_datasets(np.where(mask, data, 0.0), mask, np.ones(50))
    params = ([rng.normal(size=(D, 2)), rng.normal(size=(D, 2))],
              [np.zeros(D), np.full(D, 1e6)], [0.4, 0.4], np.zeros(2))
    jmix, tmix = both_mixes(params)
    old, jconfig.mix_exact_rnorm = jconfig.mix_exact_rnorm, exact_rnorm
    jax.clear_caches()
    try:
        for tprior, jprior in ((tp.Prior(), jp.Prior()), make_prior("all", rng, D)):
            tnew = tmix.iterate_with_prior(tds, tprior)
            jnew = jmix.iterate_with_prior(jds, jprior)
            dead = tnew.models[1]
            assert torch.equal(dead.transform, tmix.models[1].transform)
            assert torch.equal(dead.mean, tmix.models[1].mean)
            assert float(dead.isotropic_noise) == 0.4
            assert float(tnew.weights[1]) == 0.0
            close(tnew.models[0].transform, jnew.models[0].transform)
            close(tnew.models[0].mean, jnew.models[0].mean, noise_tol)   # the mean prior reads the noise
            assert float(tnew.models[0].isotropic_noise) == pytest.approx(
                jnew.models[0].isotropic_noise, rel=noise_tol)
            assert np.isfinite(tnew.llk(tds)) and np.isfinite(tnew.iterate(tds).llk(tds))
    finally:
        jconfig.mix_exact_rnorm = old
        jax.clear_caches()


def test_iterate_n_llks_match(rng):
    data, mask, weights = make_data(rng)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng))
    tnew, tllks = tmix.iterate_n(tds, 4)
    jnew, jllks = jmix.iterate_n(jds, 4)
    close(tllks, jllks)
    assert_mix_close(tnew, jnew)
    assert all(b >= a - 1e-9 * abs(a) for a, b in zip(tllks.tolist(), tllks.tolist()[1:]))
    assert tmix.iterate_n(tds, 0)[1].shape == (0,)
    with pytest.raises(ValueError):
        tmix.iterate_n(tp.Dataset(np.zeros((0, 7))), 1)


def test_trainer_metrics_and_callback_match(rng):
    data, mask, weights = make_data(rng)
    jds, tds = both_datasets(data, mask, weights)
    jmix, tmix = both_mixes(make_params(rng))
    j_hist, t_hist = [], []
    jm = jp.PPCAMixTrainer(jds).train(start=jmix, n_models=3, state_size=2, n_iters=5,
                                      quiet=True, callback=lambda i, m: j_hist.append((i, m)))
    tm = tp.PPCAMixTrainer(tds).train(start=tmix, n_models=3, state_size=2, n_iters=5,
                                      quiet=True, callback=lambda i, m: t_hist.append((i, m)))
    assert [i for i, _ in t_hist] == [1, 2, 3, 4, 5]
    for (_, tmet), (_, jmet) in zip(t_hist, j_hist):
        for f in ("llk", "aic", "bic"):
            assert getattr(tmet, f) == pytest.approx(getattr(jmet, f), rel=TOL)
    assert_mix_close(tm, jm)     # canonical components


def test_trainer_printout_and_checkpoint(rng, tmp_path, capsys):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    path = tmp_path / "mix.bin"
    mix = tp.PPCAMixTrainer(tds).train(
        n_models=2, state_size=2, n_iters=3, metric="bic", checkpoint_path=str(path),
        checkpoint_every=2, generator=torch.Generator().manual_seed(3))
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [f"Masked PPCA mix iteration {i}" for i in (1, 2, 3)]
    assert all("bic=" in line for line in out)
    saved = tp.PPCAMix.load(path.read_bytes(), dtype=torch.float64)
    assert_mix_close(saved.to_canonical(), mix, 1e-12)
    again = tp.PPCAMixTrainer(tds).train(n_models=2, state_size=2, n_iters=3, quiet=True,
                                         generator=torch.Generator().manual_seed(3))
    assert_mix_close(again, mix, 0)


def test_dump_load_across_packages_and_pickle(rng):
    jmix, tmix = both_mixes(make_params(rng, ks=[2, 1]))
    from_j = tp.PPCAMix.load(jmix.dump(), dtype=torch.float64)
    assert_mix_close(from_j, jmix, 0)
    back = jp.PPCAMix.load(tmix.dump())
    assert_mix_close(tmix, back, 0)
    again = pickle.loads(pickle.dumps(tmix))
    assert isinstance(again, tp.PPCAMix)
    assert_mix_close(again, jmix, 1e-7)     # loads in config.dtype, float32
    with pytest.raises(ValueError, match="expected 'ppca_mix'"):
        tp.PPCAMix.load(jmix.models[0].dump())


def test_accessors_and_construction(rng):
    jmix, tmix = both_mixes(make_params(rng, ks=[2, 3]))
    assert tmix.n_parameters == jmix.n_parameters
    assert tmix.output_size == 7 and tmix.state_sizes == [2, 3]
    close(tmix.weights, jmix.weights)
    assert float(tmix.weights.sum()) == pytest.approx(1.0)
    assert len(tmix.models) == 2 and "n_models=2" in repr(tmix)
    with pytest.raises(ValueError):
        tp.PPCAMix([], [])
    with pytest.raises(ValueError, match="output sizes"):
        interop.mix_from_arrays([np.ones((3, 1)), np.ones((4, 1))], [np.zeros(3), np.zeros(4)],
                                [1.0, 1.0], [0.0, 0.0])
    with pytest.raises(ValueError, match="log_weights"):
        tp.PPCAMix(tmix.models, [0.0])


def test_init_is_seeded_and_to_canonical_keeps_llk(rng):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    a = tp.PPCAMix.init(3, 2, tds, generator=torch.Generator().manual_seed(5))
    b = tp.PPCAMix.init(3, 2, tds, generator=torch.Generator().manual_seed(5))
    assert_mix_close(a, b, 0)
    assert not torch.equal(a.models[0].transform, a.models[1].transform)
    close(a.weights, np.full(3, 1 / 3))
    trained = a.iterate_n(tds, 3)[0]
    assert trained.to_canonical().llk(tds) == pytest.approx(trained.llk(tds), rel=TOL)


def test_uninferred_and_inferred_one(rng):
    jmix, tmix = both_mixes(make_params(rng))
    un = tmix.uninferred(4)
    close(un.log_posteriors(), np.broadcast_to(jmix.log_weights, (4, 3)))
    close(un.states(), np.zeros((4, 2)))
    close(torch.stack(un.covariances()), np.broadcast_to(np.eye(2), (4, 2, 2)))
    one = tmix.inferred_one(np.log([0.2, 0.3, 0.5]), [m.uninferred(1) for m in tmix.models])
    assert one.log_posteriors().shape == (1, 3) and len(one) == 1


def test_sample_and_posterior_sampler(rng):
    """Ancestral samples follow the mask rate and the component weights;
    posterior draws are seeded, finite, and average to smooth."""
    Cs = [np.ones((5, 1)), -np.ones((5, 1))]
    means = [np.full(5, -20.0), np.full(5, 20.0)]
    tmix = interop.mix_from_arrays(Cs, means, [0.1, 0.1], np.log([0.25, 0.75]))
    ds = tmix.sample(4000, 0.3, generator=torch.Generator().manual_seed(0))
    assert ds.data.shape == (4000, 5)
    assert abs(float(ds.mask.double().mean()) - 0.7) < 0.03
    seen = ds.data[ds.mask]
    assert abs(float((seen > 0).double().mean()) - 0.75) < 0.03
    inferred = tmix.infer(ds)
    sampler = inferred.posterior_sampler()
    draws = [sampler.sample(generator=torch.Generator().manual_seed(s)).data for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert bool(torch.isfinite(draws[0]).all())
    mean = sum(sampler.sample(generator=torch.Generator().manual_seed(10 + s)).data
               for s in range(64)) / 64
    sd = inferred.smoothed_covariances_diagonal(tmix).data.sqrt()
    assert float(((mean - tmix.smooth(ds).data).abs() / (sd / 8)).max()) < 6.0


def test_pattern_info_include_dense():
    dense = tp.Dataset(np.arange(24.0).reshape(12, 2))
    assert dense.pattern_info() is None
    pidx, pats = dense.pattern_info(include_dense=True)
    assert pidx.dtype == torch.int64 and torch.equal(pidx, torch.zeros(12, dtype=torch.int64))
    assert pats.shape == (1, 2) and bool(pats.all())
    assert dense.pattern_info() is None and dense._patterns is None
    assert tp.Dataset(np.ones((4, 2))).pattern_info(include_dense=True) is None   # too short


def test_main_path_never_launches_on_cpu(rng):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    tk.reset_launch_counts()
    mix = tp.PPCAMixTrainer(tds).train(n_models=2, state_size=2, n_iters=2, quiet=True)
    mix.infer(tds).posterior_sampler().sample()
    mix.smooth(tds)
    mix.llk(tds)
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def test_port_imports_no_jax():
    """Training and reading out a mixture, streaming both model kinds over
    bfloat16 chunks and a round trip through the DataFrame adapter with the
    port alone load no JAX and nothing of the JAX package."""
    code = (
        "import sys, numpy as np, pandas as pd, torch\n"
        "import ppca_rs_tpu_torch as tp\n"
        "tp.config.device = torch.device('cpu')\n"
        "ds = tp.Dataset(np.random.default_rng(0).normal(size=(40, 5)))\n"
        "mix = tp.PPCAMixTrainer(ds).train(n_models=2, state_size=1, n_iters=2, quiet=True)\n"
        "mix.infer(ds).posterior_sampler().sample(); mix.extrapolate(ds)\n"
        "chunks = list(ds.astype(torch.bfloat16).chunks(3))\n"
        "tp.StreamingPPCATrainer(chunks).train(state_size=1, n_iters=2, quiet=True)\n"
        "tp.StreamingPPCAMixTrainer(chunks).train(n_models=2, state_size=1, n_iters=1, quiet=True)\n"
        "df = pd.DataFrame({'k': [0, 0, 1], 'd': [0, 1, 0], 'v': [1.0, 2.0, 3.0]})\n"
        "a = tp.DataFrameAdapter.from_pandas(df, keys=['k'], dimensions=['d'], metric='v')\n"
        "fit = tp.PPCATrainer(a.dataset).train(state_size=1, n_iters=1, quiet=True)\n"
        "a.convert_dataset(fit.extrapolate(a.dataset), column_name='v')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ppca_rs_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
