"""Statistical recovery through the port: tests/test_statistical.py's six
cases, with the port's own ``torch.Generator`` streams and the JAX test's
thresholds, on the CPU.

Float64 except where a case pins float32 or bfloat16 storage.  The
thresholds are the JAX test's: largest principal angle < 0.05 and sigma
within 0.05, singular values at rtol 0.1, the sampler's moments (mean
within 0.15, variance at rtol 0.35 / atol 0.05 over 600 draws), more than
95% of imputations within 3 predicted standard deviations, the float32
pipeline within 1e-4..5e-3 of float64, and bfloat16 storage within
3e-3..5e-2.  chip_smoke.py phase 14 runs the recovery at full width.
"""

import numpy as np
import pytest
import torch

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _on_the_cpu_in_float64(monkeypatch):
    """The port builds on the card in float32 by default; these tests ask
    for the CPU and, like the JAX package's tests, float64."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    monkeypatch.setattr(tconfig, "dtype", F64)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def principal_angle(A, B):
    """Largest principal angle (radians) between the column spaces."""
    Qa, _ = np.linalg.qr(np.asarray(A))
    Qb, _ = np.linalg.qr(np.asarray(B))
    s = np.clip(np.linalg.svd(Qa.T @ Qb, compute_uv=False), -1.0, 1.0)
    return float(np.arccos(s.min()))


def test_subspace_recovery(rng):
    """EM recovers the true subspace up to rotation, and sigma."""
    C_true = rng.normal(size=(12, 3)) * 2.0
    real = tp.PPCAModel(isotropic_noise=0.2, transform=C_true, mean=rng.normal(size=12))
    data = real.sample(4000, 0.2, generator=gen(3))
    model = tp.PPCATrainer(data).train(state_size=3, n_iters=60, quiet=True, generator=gen(4))
    angle = principal_angle(model.transform, C_true)
    assert angle < 0.05, f"subspace angle {angle}"
    assert abs(float(model.isotropic_noise) - 0.2) < 0.05
    np.testing.assert_allclose(model.mean.numpy(), real.mean.numpy(), atol=0.15)


def test_singular_values_recovered(rng):
    """Canonical singular values match the true spectrum: the ML column
    norms are sqrt(lambda_i - sigma^2) = [4, 2]."""
    C_true = np.linalg.qr(rng.normal(size=(20, 2)))[0] * np.array([4.0, 2.0])
    real = tp.PPCAModel(isotropic_noise=1.0, transform=C_true, mean=np.zeros(20))
    data = real.sample(6000, 0.0, generator=gen(5))
    model = tp.PPCATrainer(data).train(state_size=2, n_iters=80, quiet=True, generator=gen(6))
    got = np.sort(model.singular_values.numpy() ** 2)[::-1]
    np.testing.assert_allclose(got, [4.0, 2.0], rtol=0.1)


def test_posterior_sampler_statistics(rng):
    """Posterior draws (output noise included, as the reference code does)
    average to smoothed, with the smoothed covariances' diagonal as their
    variance."""
    C = rng.normal(size=(6, 2))
    model = tp.PPCAModel(isotropic_noise=0.3, transform=C, mean=rng.normal(size=6))
    data = model.sample(50, 0.3, generator=gen(7))
    inf = model.infer(data)
    sampler = inf.posterior_sampler()
    draws = np.stack([sampler.sample(generator=gen(100 + i)).numpy() for i in range(600)])
    np.testing.assert_allclose(draws.mean(axis=0), inf.smoothed(model).numpy(), atol=0.15)
    np.testing.assert_allclose(draws.var(axis=0),
                               inf.smoothed_covariances_diagonal(model).numpy(),
                               rtol=0.35, atol=0.05)


def test_extrapolation_accuracy(rng):
    """Imputed values lie within their predicted intervals."""
    C_true = rng.normal(size=(10, 2)) * 2.0
    real = tp.PPCAModel(isotropic_noise=0.05, transform=C_true, mean=np.zeros(10))
    truth = real.sample(2000, 0.0, generator=gen(8)).numpy()
    holes = rng.random(truth.shape) < 0.3
    ds = tp.Dataset(np.where(holes, np.nan, truth))
    model = tp.PPCATrainer(ds).train(state_size=2, n_iters=40, quiet=True, generator=gen(9))
    err = np.abs(model.extrapolate(ds).numpy() - truth)[holes]
    ci = model.infer(ds).extrapolated_covariances_diagonal(model, ds).numpy() ** 0.5
    frac = np.mean(err <= 3 * ci[holes] + 1e-6)
    assert frac > 0.95, frac
    assert np.median(err) < 0.5


def test_f32_pipeline(rng):
    """The verbs in float32 stay within the JAX test's bounds of float64."""
    C = rng.normal(size=(8, 2))
    mean = rng.normal(size=8)
    data = rng.normal(size=(200, 8)) + mean
    data[rng.random((200, 8)) < 0.3] = np.nan
    ds64, ds32 = tp.Dataset(data), tp.Dataset(data, dtype=F32)
    model64 = tp.PPCAModel(isotropic_noise=0.5, transform=C, mean=mean)
    model32 = tp.PPCAModel(isotropic_noise=0.5, transform=C, mean=mean, dtype=F32)
    assert ds32.dtype == model32.transform.dtype == F32
    np.testing.assert_allclose(model32.llk(ds32), model64.llk(ds64), rtol=1e-4)
    np.testing.assert_allclose(model32.infer(ds32).states().double().numpy(),
                               model64.infer(ds64).states().numpy(), rtol=1e-3, atol=1e-4)
    m32, m64 = model32.iterate(ds32), model64.iterate(ds64)
    np.testing.assert_allclose(m32.transform.double().numpy(), m64.transform.numpy(),
                               rtol=5e-3, atol=5e-4)
    assert np.isclose(float(m32.isotropic_noise), float(m64.isotropic_noise), rtol=1e-3)


def test_bf16_storage_pipeline(rng):
    """bfloat16 storage (the math in float32) stays within the JAX test's
    envelope of the float64 pipeline, and EM converges to the same model."""
    C = rng.normal(size=(8, 2))
    mean = rng.normal(size=8)
    data = rng.normal(size=(2000, 8)) + mean
    data[rng.random((2000, 8)) < 0.3] = np.nan
    ds64 = tp.Dataset(data)
    ds16 = tp.Dataset(data, dtype=F32).astype(torch.bfloat16)
    assert ds16.dtype == torch.bfloat16
    model64 = tp.PPCAModel(isotropic_noise=0.5, transform=C, mean=mean)
    model16 = tp.PPCAModel(isotropic_noise=0.5, transform=C, mean=mean, dtype=F32)
    assert model16.iterate(ds16).transform.dtype == F32
    np.testing.assert_allclose(model16.llk(ds16), model64.llk(ds64), rtol=3e-3)
    np.testing.assert_allclose(model16.infer(ds16).states().double().numpy(),
                               model64.infer(ds64).states().numpy(), rtol=2e-2, atol=2e-2)
    m16, m64 = model16.iterate(ds16), model64.iterate(ds64)
    np.testing.assert_allclose(m16.transform.double().numpy(), m64.transform.numpy(),
                               rtol=2e-2, atol=2e-3)
    assert np.isclose(float(m16.isotropic_noise), float(m64.isotropic_noise), rtol=1e-2)
    t16, _ = model16.iterate_n(ds16, 30)
    t64, _ = model64.iterate_n(ds64, 30)
    np.testing.assert_allclose(np.abs(t16.to_canonical().transform.double().numpy()),
                               np.abs(t64.to_canonical().transform.numpy()),
                               rtol=5e-2, atol=5e-2)
