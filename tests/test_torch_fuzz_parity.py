"""Randomized parity fuzz through the port: tests/test_fuzz_parity.py's
draws (random shapes, masks, weights and priors through the EM step, the
llks and the posteriors) in float64 on the CPU, held against the
brute-force formulas of tests/reference_impl.py at the JAX test's
tolerances, and against the JAX package on the same draws at 1e-9.

The seeds are the JAX test's: 8 of the general family, 4 of the pattern
family and 4 of the dense family; each family adds one draw at state
size 0 (the draw of the next seed with k forced to 0).  The JAX package's
pattern route cannot infer at k = 0, so that draw's posteriors are held
against the JAX package on the masked route.  chip_smoke.py phase 14
runs a fuzz of its own through the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
import reference_impl as ref
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models.routes import route as route_of

torch.set_num_threads(1)

TOL_JAX = 1e-9


@pytest.fixture(autouse=True)
def _on_the_cpu_in_float64(monkeypatch):
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    monkeypatch.setattr(tconfig, "dtype", torch.float64)


def cases(n_seeds):
    """The JAX test's seeds, then one draw with k forced to 0."""
    return [pytest.param(s, False, id=str(s)) for s in range(n_seeds)] + [
        pytest.param(n_seeds, True, id="k0")]


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_jax(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    if got.size:
        np.testing.assert_allclose(got, want, rtol=TOL_JAX,
                                   atol=TOL_JAX * max(1.0, np.abs(want).max()))


def reference_llks(C, mean, sigma, data, mask):
    return np.array([ref.llk_one(C, mean, sigma, np.nan_to_num(data[i]), mask[i])
                     for i in range(data.shape[0])])


def check_posteriors(tinf, jinf, C, mean, sigma, data, mask, step):
    for i in range(0, data.shape[0], step):
        s, cov = ref.infer_one(C, mean, sigma, np.nan_to_num(data[i]), mask[i])
        np.testing.assert_allclose(np_(tinf.states()[i]), s, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np_(tinf.covariances_array()[i]), cov, rtol=1e-7, atol=1e-9)
    close_jax(tinf.states(), jinf.states())
    close_jax(tinf.covariances_array(), jinf.covariances_array())


def check_model(tnew, jnew, want_C, want_mean, want_sigma):
    np.testing.assert_allclose(np_(tnew.transform), want_C, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np_(tnew.mean), want_mean, rtol=1e-6, atol=1e-7)
    assert np.isclose(float(tnew.isotropic_noise), want_sigma, rtol=1e-7)
    close_jax(tnew.transform, jnew.transform)
    close_jax(tnew.mean, jnew.mean)
    assert float(tnew.isotropic_noise) == pytest.approx(float(jnew.isotropic_noise), rel=TOL_JAX)


@pytest.mark.parametrize("seed, k0", cases(8))
def test_fuzz_em_llk_posterior(seed, k0):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(5, 60))
    d = int(rng.integers(1, 12))
    k = int(rng.integers(0, min(d, 5) + 1))
    k = 0 if k0 else k
    mask_prob = float(rng.uniform(0.0, 0.7))

    C = rng.normal(size=(d, k)) * rng.uniform(0.3, 3.0)
    mean = rng.normal(size=d)
    sigma = float(rng.uniform(0.05, 2.0))
    data = rng.normal(size=(n, d)) * 2.0 + mean
    mask = rng.random((n, d)) > mask_prob
    if n > 3 and rng.random() < 0.5:
        mask[2] = False                       # all-masked row
    if d > 2 and rng.random() < 0.5:
        mask[:, 1] = False                    # empty dimension
        C = C.copy()
        C[1] = 0.0
    weights = rng.random(n) + 0.1
    data = np.where(mask, data, np.nan)

    tm = tp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    jm = jp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    tds, jds = tp.Dataset(data, weights=weights), jp.Dataset(data, weights=weights)

    got = tm.llks(tds)
    np.testing.assert_allclose(np_(got), reference_llks(C, mean, sigma, data, mask),
                               rtol=1e-8, atol=1e-8)
    close_jax(got, jm.llks(jds))

    if k > 0 or route_of(tds).kind != "pattern":
        check_posteriors(tm.infer(tds), jm.infer(jds), C, mean, sigma, data, mask,
                         max(1, n // 5))

    kwargs = {}
    tprior, jprior = tp.Prior(), jp.Prior()
    if rng.random() < 0.5:
        a, b = float(rng.uniform(0.5, 20)), float(rng.uniform(0.5, 20))
        tprior, jprior = (p.with_isotropic_noise_prior(a, b) for p in (tprior, jprior))
        kwargs["noise_prior"] = (a, b)
    if rng.random() < 0.5:
        lam = float(rng.uniform(0.0, 2.0))
        tprior, jprior = (p.with_transformation_precision(lam) for p in (tprior, jprior))
        kwargs["transformation_precision"] = lam
    if rng.random() < 0.5:
        pm = rng.normal(size=d)
        pc = np.eye(d) * rng.uniform(0.2, 2.0)
        tprior, jprior = (p.with_mean_prior(pm, pc) for p in (tprior, jprior))
        kwargs["mean_prior"] = (pm, np.linalg.inv(pc))

    want = ref.em_iterate(C, mean, sigma, np.nan_to_num(data), mask, weights, **kwargs)
    check_model(tm.iterate_with_prior(tds, tprior), jm.iterate_with_prior(jds, jprior), *want)


@pytest.mark.parametrize("seed, k0", cases(4))
def test_fuzz_pattern_path_parity(seed, k0, monkeypatch):
    """Structured missingness (P patterns << N): the pattern route."""
    rng = np.random.default_rng(2000 + seed)
    n = int(rng.integers(120, 300))
    d = int(rng.integers(4, 14))
    k = int(rng.integers(1, min(d, 5) + 1))
    k = 0 if k0 else k
    P = int(rng.integers(1, 5))

    pats = rng.random((P, d)) < rng.uniform(0.0, 0.6)
    pats[:, int(rng.integers(0, d))] = False        # one dim missing in some
    pats[0, 0] = True                               # >=1 genuinely masked entry
    pidx = rng.integers(0, P, size=n)
    pidx[0] = 0                                     # (else the draw can be fully
                                                    # observed -> dense path)
    mask = ~pats[pidx]                               # pattern True = missing
    C = rng.normal(size=(d, k))
    mean = rng.normal(size=d) * 3.0
    sigma = float(rng.uniform(0.1, 1.5))
    data = np.where(mask, rng.normal(size=(n, d)) + mean, np.nan)
    weights = rng.random(n) + 0.1

    tds, jds = tp.Dataset(data, weights=weights), jp.Dataset(data, weights=weights)
    assert route_of(tds).kind == "pattern"
    tm = tp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    jm = jp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)

    got = tm.llks(tds)
    np.testing.assert_allclose(np_(got), reference_llks(C, mean, sigma, data, mask),
                               rtol=1e-8, atol=1e-8)
    close_jax(got, jm.llks(jds))

    tnew = tm.iterate(tds)
    jnew = jm.iterate(jds)
    want = ref.em_iterate(C, mean, sigma, np.nan_to_num(data), mask, weights)
    check_model(tnew, jnew, *want)

    if k == 0:     # the JAX package's pattern route cannot infer at k = 0
        monkeypatch.setattr(jp.config, "use_pattern_dedup", False)
        jds = jp.Dataset(data, weights=weights)
    check_posteriors(tm.infer(tds), jm.infer(jds), C, mean, sigma, data, mask, max(1, n // 7))


@pytest.mark.parametrize("seed, k0", cases(4))
def test_fuzz_dense_path_parity(seed, k0):
    """Fully observed data: the dense route, with large mean offsets."""
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(50, 200))
    d = int(rng.integers(2, 14))
    k = int(rng.integers(1, min(d, 5) + 1))
    k = 0 if k0 else k
    offset = rng.normal(size=d) * float(rng.choice([1.0, 50.0, 500.0]))

    C = rng.normal(size=(d, k))
    mean = offset + rng.normal(size=d)
    sigma = float(rng.uniform(0.1, 1.5))
    data = rng.normal(size=(n, d)) + offset
    weights = rng.random(n) + 0.1
    mask = np.ones((n, d), bool)

    tds, jds = tp.Dataset(data, weights=weights), jp.Dataset(data, weights=weights)
    assert route_of(tds).kind == "dense"
    tm = tp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    jm = jp.PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)

    got = tm.llks(tds)
    np.testing.assert_allclose(np_(got), reference_llks(C, mean, sigma, data, mask),
                               rtol=1e-8, atol=1e-8)
    close_jax(got, jm.llks(jds))

    n_steps = 3
    fast, tllks = tm.iterate_n(tds, n_steps)
    jfast, jllks = jm.iterate_n(jds, n_steps)
    close_jax(tllks, jllks)
    want_C, want_mean, want_sigma = np.asarray(C), np.asarray(mean), sigma
    for _ in range(n_steps):
        want_C, want_mean, want_sigma = ref.em_iterate(
            want_C, want_mean, want_sigma, data, mask, weights)
    check_model(fast, jfast, want_C, want_mean, want_sigma)
    check_posteriors(tm.infer(tds), jm.infer(jds), C, mean, sigma, data, mask, max(1, n // 7))
