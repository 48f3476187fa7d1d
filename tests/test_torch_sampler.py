"""The port's posterior sampler (InferredMasked.posterior_sampler,
PosteriorSampler, ops.kernels.spd_chol) and the posterior-batch
constructors against the JAX package, on the CPU.

spd_chol's plain version is held against the Pallas kernel in interpret
mode (float32, its tolerance) and against numpy (float64, 1e-12).  The
sampler's factor is held against the JAX sampler's factor on the masked,
pattern and dense paths' covariances (float64, 1e-9 relative).  Draws come
from torch generators and cannot match JAX's: the draw formula is
recomputed from the same generator, and the draws' moments are checked
against the analytic posterior, as tests/test_statistical.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu.ops import kernels as jk
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

RTOL = 1e-9


def spd_batch(rng, B, k):
    V = rng.normal(size=(B, k, 2 * k)) / np.sqrt(2 * k)
    return V @ np.swapaxes(V, -1, -2) + 0.1 * np.eye(k)


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                               atol=rtol * max(1.0, np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("k", [1, 3, 13, 64, 128])
def test_chol_reference_matches_pallas_and_numpy(rng, k):
    B = 100   # not a multiple of the TPU kernel's 128 lanes
    M = spd_batch(rng, B, k)
    got64 = tk.spd_chol_reference(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got64, np.linalg.cholesky(M), rtol=1e-12, atol=1e-12)
    assert np.all(np.triu(got64, 1) == 0)
    M32 = M.astype(np.float32)
    got32 = tk.spd_chol(torch.from_numpy(M32)).numpy()
    pallas = np.transpose(np.asarray(jk.spd_chol(jnp.asarray(np.transpose(M32, (1, 2, 0))),
                                                 interpret=True)), (2, 0, 1))
    np.testing.assert_allclose(got32, pallas, rtol=3e-5, atol=3e-6)


def test_chol_non_spd_sample_fails_alone(rng):
    M = spd_batch(rng, 12, 5)
    M[4] = -M[4]                 # negative definite
    M[9, 2, 2] = -1.0            # indefinite
    L = tk.spd_chol(torch.from_numpy(M)).numpy()
    bad = [4, 9]
    assert not np.isfinite(L[bad]).all(axis=(1, 2)).any()
    keep = [i for i in range(12) if i not in bad]
    np.testing.assert_allclose(L[keep], np.linalg.cholesky(M[keep]), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tk.spd_chol(torch.eye(4).expand(3, 4, 4).contiguous()),
                                  np.broadcast_to(np.eye(4), (3, 4, 4)))


def make_case(rng, kind, n=160, d=8, k=3):
    """(torch dataset, JAX dataset, torch model, JAX model) for one route."""
    C, mean = rng.normal(size=(d, k)), rng.normal(size=d)
    data = rng.normal(size=(n, k)) @ C.T + mean + 0.5 * rng.normal(size=(n, d))
    if kind == "masked":
        mask = rng.random((n, d)) > 0.3
    elif kind == "pattern":
        mask = (rng.random((4, d)) < 0.6)[rng.integers(0, 4, size=n)]
    else:
        mask = np.ones((n, d), bool)
    data = np.where(mask, data, 0.0)
    tds = interop.dataset_from_arrays(data, mask)
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask))
    C0 = C + 0.2 * rng.normal(size=(d, k))
    return (tds, jds, interop.model_from_arrays(C0, mean, 0.7),
            jp.PPCAModel(isotropic_noise=0.7, transform=C0, mean=mean))


@pytest.mark.parametrize("kind", ["masked", "pattern", "dense"])
def test_sampler_factor_matches_jax(rng, monkeypatch, kind):
    tds, jds, tm, jm = make_case(rng, kind)
    assert (tds.pattern_info() is not None) == (kind == "pattern")
    assert tds.all_observed() == (kind == "dense")

    def no_launch(*args):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(tk, "launch_chol", no_launch)
    sampler = tm.infer(tds).posterior_sampler()
    want = jm.infer(jds).posterior_sampler()
    assert isinstance(sampler, tp.PosteriorSampler)
    close(sampler._chol, want._chol)
    close(sampler._states, want._states)


def test_draw_formula(rng):
    tds, _, tm, _ = make_case(rng, "masked", n=40)
    sampler = tm.infer(tds).posterior_sampler()
    got = sampler.sample(generator=torch.Generator().manual_seed(3)).data
    gen = torch.Generator().manual_seed(3)
    z1 = torch.randn((40, 3), generator=gen, dtype=torch.float64)
    z2 = torch.randn((40, 8), generator=gen, dtype=torch.float64)
    C, mean, sigma = tm.transform, tm.mean, tm.isotropic_noise
    s = sampler._states + torch.einsum("nkl,nl->nk", sampler._chol, z1)
    close(got, sigma * z2 + mean + s @ C.T, 1e-12)
    again = sampler.sample(generator=torch.Generator().manual_seed(3)).data
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert not torch.equal(sampler.sample(generator=torch.Generator().manual_seed(4)).data, got)


def test_posterior_sampler_statistics(rng):
    """Draws match the analytic posterior moments: mean ~= smoothed,
    variance ~= smoothed covariance diagonal (the draw includes the output
    noise, ppca_model.rs:603-626)."""
    model = tp.PPCAModel(isotropic_noise=0.3, transform=rng.normal(size=(6, 2)),
                         mean=rng.normal(size=6), dtype=torch.float64)
    data = model.sample(50, 0.3, generator=torch.Generator().manual_seed(7))
    inferred = model.infer(data)
    sampler = inferred.posterior_sampler()
    gen = torch.Generator().manual_seed(100)
    draws = torch.stack([sampler.sample(generator=gen).data for _ in range(600)])
    assert draws.shape == (600, 50, 6)
    np.testing.assert_allclose(draws.mean(0).numpy(), inferred.smoothed(model).numpy(), atol=0.15)
    np.testing.assert_allclose(draws.var(0).numpy(),
                               inferred.smoothed_covariances_diagonal(model).numpy(),
                               rtol=0.35, atol=0.05)


def test_non_pd_covariance_raises():
    model = interop.model_from_arrays(np.ones((4, 2)), np.zeros(4), 0.5)
    bad = model.inferred_one(np.zeros(2), np.array([[1.0, 2.0], [2.0, 1.0]]))
    with pytest.raises(ValueError, match="posterior covariance not PD"):
        bad.posterior_sampler()


def test_uninferred_and_inferred_one_match_jax(rng):
    C, mean = rng.normal(size=(5, 3)), rng.normal(size=5)
    tm = interop.model_from_arrays(C, mean, 0.4)
    jm = jp.PPCAModel(isotropic_noise=0.4, transform=C, mean=mean)
    tu, ju = tm.uninferred(4), jm.uninferred(4)
    assert len(tu) == 4 and tu.states().dtype == torch.float64
    close(tu.states(), ju.states())
    close(tu.covariances_array(), ju.covariances_array())
    close(tu.posterior_sampler()._chol, ju.posterior_sampler()._chol)
    close(tu.smoothed_covariances_diagonal(tm).numpy(), ju.smoothed_covariances_diagonal(jm).numpy())
    state, cov = rng.normal(size=3), spd_batch(rng, 1, 3)[0]
    one_t, one_j = tm.inferred_one(state, cov), jm.inferred_one(state, cov)
    assert len(one_t) == 1
    close(one_t.states(), one_j.states())
    close(one_t.covariances_array(), one_j.covariances_array())
    close(one_t.posterior_sampler()._chol, one_j.posterior_sampler()._chol)
    stacked = tm.inferred_one(rng.normal(size=(2, 3)), spd_batch(rng, 2, 3))
    assert stacked.states().shape == (2, 3) and stacked.covariances_array().shape == (2, 3, 3)
