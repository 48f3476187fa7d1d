"""Near-noiseless float32 through the port: tests/test_small_sigma.py's
cases on models built with ``dtype=torch.float32``, on the CPU.

The EM statistics compute |dev|^2 = rnorm - b.s - sigma^2 |s|^2 (exact via
M s = b) instead of materializing residuals.  With the model AT the truth
of exact low-rank data and sigma = 1e-4 (sigma^2 = 1e-8 beside Gram
entries of order D), the true |dev|^2 is ~0 and the float32 cancellation
can dip below 0; an unclamped sum would make the sigma^2 update negative
and NaN the model.  Three EM steps on each route (dense, masked, pattern,
the general mixture route, and the mixture's per-segment route at N/P =
``config.pat_sorted_min_rows``) must keep sigma finite, >= 0 and (where
the JAX test says so) < 1e-2, and every transform finite.  The float32
large-mean-offset case holds the float32 llk within 1e-5 relative of
float64, and the float64 pass equals the JAX package's at 1e-9.
chip_smoke.py phase 14 runs the same regime through the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models.routes import route as route_of
from ppca_rs_tpu_torch.ops import mix_fused as mf

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def f32_model(U, sigma=1e-4):
    return tp.PPCAModel(isotropic_noise=sigma, transform=U, mean=np.zeros(U.shape[0]),
                        dtype=F32)


def lowrank_data(rng, n, d, k):
    U = rng.normal(size=(d, k)).astype(np.float32)
    z = rng.normal(size=(n, k)).astype(np.float32)
    return np.asarray(z @ U.T, np.float64), U


def assert_finite_step(model, check_transform=True):
    sig = float(model.isotropic_noise)
    assert np.isfinite(sig) and sig >= 0.0
    if check_transform:
        assert bool(torch.isfinite(model.transform).all())
    return sig


def test_dense_iterate_noiseless_stays_finite(rng):
    n, d, k = 4096, 64, 4
    data, U = lowrank_data(rng, n, d, k)
    ds = tp.Dataset(data, dtype=F32)
    assert route_of(ds).kind == "dense"
    model = f32_model(U)
    assert model.transform.dtype == F32
    for _ in range(3):
        model = model.iterate(ds)
        sig = assert_finite_step(model)
    assert sig < 1e-2


def test_masked_iterate_noiseless_stays_finite(rng):
    n, d, k = 4096, 64, 4
    data, U = lowrank_data(rng, n, d, k)
    data[rng.random((n, d)) < 0.3] = np.nan
    ds = tp.Dataset(data, dtype=F32)
    assert route_of(ds).kind == "masked"
    model = f32_model(U)
    for _ in range(3):
        model = model.iterate(ds)
        assert_finite_step(model)


def test_pattern_iterate_noiseless_stays_finite(rng):
    n, d, k, P = 4096, 64, 4, 5
    data, U = lowrank_data(rng, n, d, k)
    patterns = rng.random((P, d)) < 0.3
    data[patterns[rng.integers(0, P, size=n)]] = np.nan
    ds = tp.Dataset(data, dtype=F32)
    assert route_of(ds).kind == "pattern"
    model = f32_model(U)
    for _ in range(3):
        model = model.iterate(ds)
        assert_finite_step(model, check_transform=False)


def test_mix_iterate_noiseless_stays_finite(rng):
    n, d, k, M = 2048, 32, 3, 2
    data, U = lowrank_data(rng, n, d, k)
    data[rng.random((n, d)) < 0.2] = np.nan
    ds = tp.Dataset(data, dtype=F32)
    assert ds.pattern_info(include_dense=True) is None        # the general route
    mix = tp.PPCAMix([f32_model(U + 0.01 * i) for i in range(M)], np.zeros(M))
    for _ in range(3):
        mix = mix.iterate(ds)
        for m in mix.models:
            assert_finite_step(m, check_transform=False)
    assert np.isfinite(mix.llk(ds))


def test_sorted_mix_iterate_noiseless_stays_finite(rng, monkeypatch):
    """The mixture's per-segment EM (``mix_fused.mix_em_stats_pat_sorted``):
    P = 2 structured patterns with exactly ``pat_sorted_min_rows`` rows each."""
    d, k, M, P = 32, 3, 2, 2
    n = P * tconfig.pat_sorted_min_rows
    data, U = lowrank_data(rng, n, d, k)
    patterns = rng.random((P, d)) < 0.3
    patterns[0, 0] = True
    pidx = np.repeat(np.arange(P), n // P)
    rng.shuffle(pidx)
    data[patterns[pidx]] = np.nan
    ds = tp.Dataset(data, dtype=F32)
    calls = []
    inner = mf.mix_em_stats_pat_sorted
    monkeypatch.setattr(mf, "mix_em_stats_pat_sorted",
                        lambda *a, **kw: (calls.append(1), inner(*a, **kw))[1])
    mix = tp.PPCAMix([f32_model(U + 0.01 * i) for i in range(M)], np.zeros(M))
    for _ in range(3):
        mix = mix.iterate(ds)
        for m in mix.models:
            assert_finite_step(m)
    assert len(calls) == 3
    assert np.isfinite(mix.llk(ds))


def test_dense_large_mean_offset_f32_accuracy(rng):
    """Dense-route statistics stay accurate in float32 when the data mean
    is large against the residual spread (offset 1e3): the llk within 1e-5
    relative of float64, one EM step within the JAX test's bounds; the
    float64 pass equals the JAX package's."""
    n, d, k = 2048, 64, 4
    U = rng.normal(size=(d, k))
    offset = 1000.0 * (1.0 + rng.random(d))
    data = rng.normal(size=(n, k)) @ U.T + offset + 0.1 * rng.normal(size=(n, d))

    ds32, ds64 = tp.Dataset(data, dtype=F32), tp.Dataset(data, dtype=F64)
    m32 = tp.PPCAModel(isotropic_noise=0.5, transform=U, mean=offset, dtype=F32)
    m64 = tp.PPCAModel(isotropic_noise=0.5, transform=U, mean=offset, dtype=F64)
    assert route_of(ds32).kind == "dense"

    llk32, llk64 = m32.llk(ds32), m64.llk(ds64)
    assert abs(llk32 - llk64) / abs(llk64) < 1e-5

    a32, _ = m32._iterate_with_llk(ds32, None)
    a64, l64 = m64._iterate_with_llk(ds64, None)
    assert abs(float(a32.isotropic_noise) - float(a64.isotropic_noise)) < 1e-4
    np.testing.assert_allclose(a32.mean.double().numpy(), a64.mean.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(a32.transform.double().numpy(), a64.transform.numpy(),
                               rtol=5e-4, atol=1e-4)

    jm = jp.PPCAModel._from_params(jnp.asarray(U), jnp.asarray(offset), jnp.asarray(0.5))
    jnew, jllk = jm._iterate_with_llk(jp.Dataset(data), None)
    assert l64 == pytest.approx(jllk, rel=1e-9)
    np.testing.assert_allclose(a64.transform.numpy(), jnew.transform, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(a64.mean.numpy(), jnew.mean, rtol=1e-9)
    assert float(a64.isotropic_noise) == pytest.approx(float(jnew.isotropic_noise), rel=1e-9)
