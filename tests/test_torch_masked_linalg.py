"""The port's blocked masked algebra (ppca_rs_tpu_torch.ops.masked_linalg)
against the JAX package's, both in float64 on the CPU.

The same numpy inputs go to both.  The datasets have a ragged last block,
an all-masked row, a zero-weight row and an empty dimension.  Tolerance is
1e-9 relative, the parity budget of docs/DESIGN.md section 6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppca_rs_tpu.ops import masked_linalg as jml
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

RTOL = 1e-9
N, D, K, BLOCK = 150, 12, 3, 64  # 150 = 2 full blocks of 64 + a ragged 22
EMPTY_DIM = 4


@pytest.fixture
def problem(rng):
    C = rng.normal(size=(D, K))
    C[EMPTY_DIM] = 0.0
    mean = rng.normal(size=D)
    sigma = 0.6
    data = rng.normal(size=(N, K)) @ C.T + mean + sigma * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.35
    mask[:, EMPTY_DIM] = False   # an empty dimension
    mask[9] = False              # an all-masked row
    data = np.where(mask, data, 0.0)
    weights = rng.random(N) + 0.5
    weights[20] = 0.0            # a zero-weight row
    return C, mean, sigma, data, mask, weights


def as_jax(C, mean, sigma, data, mask, weights=None):
    out = [jnp.asarray(C), jnp.asarray(mean), jnp.asarray(sigma, jnp.float64),
           jnp.asarray(data), jnp.asarray(mask)]
    return out + ([jnp.asarray(weights)] if weights is not None else [])


def as_torch(C, mean, sigma, data, mask, weights=None):
    out = [torch.from_numpy(C), torch.from_numpy(mean), torch.tensor(sigma, dtype=torch.float64),
           torch.from_numpy(data), torch.from_numpy(mask)]
    return out + ([torch.from_numpy(weights)] if weights is not None else [])


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def test_outer_flat(rng):
    C = rng.normal(size=(5, 3))
    close(tml.outer_flat(torch.from_numpy(C)), jml.outer_flat(jnp.asarray(C)))


def test_llks(problem):
    C, mean, sigma, data, mask, _ = problem
    got = tml.llks(*as_torch(C, mean, sigma, data, mask), block_size=BLOCK)
    want = jml.llks(*as_jax(C, mean, sigma, data, mask), block_size=BLOCK)
    assert got.shape == (N,)
    assert float(got[9]) == pytest.approx(0.0, abs=1e-12)
    close(got, want)


def test_infer(problem):
    C, mean, sigma, data, mask, _ = problem
    s, cov = tml.infer(*as_torch(C, mean, sigma, data, mask), block_size=BLOCK)
    s_j, cov_j = jml.infer(*as_jax(C, mean, sigma, data, mask), block_size=BLOCK)
    assert s.shape == (N, K) and cov.shape == (N, K, K)
    close(s, s_j)
    close(cov, cov_j)
    np.testing.assert_allclose(cov[9].numpy(), np.eye(K), atol=1e-12)


def test_states(problem):
    C, mean, sigma, data, mask, _ = problem
    got = tml.states(*as_torch(C, mean, sigma, data, mask), block_size=BLOCK)
    want = jml.states(*as_jax(C, mean, sigma, data, mask), block_size=BLOCK)
    close(got, want)


@pytest.mark.parametrize("block", [BLOCK, 1000])
def test_em_stats(problem, block):
    C, mean, sigma, data, mask, weights = problem
    got = tml.em_stats(*as_torch(C, mean, sigma, data, mask, weights), block_size=block)
    want = jml.em_stats(*as_jax(C, mean, sigma, data, mask, weights), block_size=block)
    for name in jml.EMStats._fields:
        close(getattr(got, name), getattr(want, name))


def test_em_stats_neutral_rows(problem):
    """All-masked zero-weight rows change no statistic."""
    C, mean, sigma, data, mask, weights = problem
    ref = tml.em_stats(*as_torch(C, mean, sigma, data, mask, weights), block_size=BLOCK)
    pad = 30
    data_p = np.concatenate([data, np.zeros((pad, D))])
    mask_p = np.concatenate([mask, np.zeros((pad, D), bool)])
    w_p = np.concatenate([weights, np.zeros(pad)])
    got = tml.em_stats(*as_torch(C, mean, sigma, data_p, mask_p, w_p), block_size=BLOCK)
    for name in tml.EMStats._fields:
        close(getattr(got, name), getattr(ref, name), rtol=1e-12)


PRIORS = {
    "none": dict(),
    "transformation_precision": dict(transformation_precision=0.7),
    "noise": dict(noise_prior=(2.0, 0.5)),
    "mean": "mean",
    "all": "all",
}


@pytest.mark.parametrize("prior", list(PRIORS))
def test_em_finalize(problem, rng, prior):
    C, mean, sigma, data, mask, weights = problem
    kw = PRIORS[prior]
    if kw in ("mean", "all"):
        A = rng.normal(size=(D, D))
        prec = A @ A.T / D + np.eye(D)
        kw = dict(mean_prior=(rng.normal(size=D), prec))
        if prior == "all":
            kw.update(transformation_precision=0.7, noise_prior=(2.0, 0.5))
    tprec = kw.get("transformation_precision", 0.0)

    def jax_kw():
        out = dict(transformation_precision=jnp.asarray(tprec))
        if "noise_prior" in kw:
            out["noise_prior"] = tuple(jnp.asarray(x, jnp.float64) for x in kw["noise_prior"])
        if "mean_prior" in kw:
            out["mean_prior"] = tuple(jnp.asarray(x) for x in kw["mean_prior"])
        return out

    def torch_kw():
        out = dict(transformation_precision=torch.tensor(tprec, dtype=torch.float64))
        if "noise_prior" in kw:
            out["noise_prior"] = tuple(torch.tensor(x, dtype=torch.float64) for x in kw["noise_prior"])
        if "mean_prior" in kw:
            out["mean_prior"] = tuple(torch.from_numpy(x) for x in kw["mean_prior"])
        return out

    tj = as_torch(C, mean, sigma, data, mask, weights)
    jj = as_jax(C, mean, sigma, data, mask, weights)
    t_stats = tml.em_stats(*tj, block_size=BLOCK)
    j_stats = jml.em_stats(*jj, block_size=BLOCK)
    got = tml.em_finalize(*tj[:3], t_stats, **torch_kw())
    want = jml.em_finalize(*jj[:3], j_stats, **jax_kw())
    for g, w in zip(got, want):
        close(g, w)
    new_C = got[0].numpy()
    if tprec == 0.0:
        # the empty dimension's row solve is singular at lambda = 0: the
        # old row is kept (ppca_model.rs:313-321)
        np.testing.assert_array_equal(new_C[EMPTY_DIM], C[EMPTY_DIM])
    assert np.all(np.isfinite(new_C))


def test_em_finalize_keeps_old_row_on_failed_solve(rng):
    """A nonzero old row survives a singular S[d] at lambda = 0."""
    Dd, k = 6, 4
    V = rng.normal(size=(Dd, k, 2 * k))
    S = V @ np.swapaxes(V, -1, -2)
    S[2] = 0.0
    cross = rng.normal(size=(Dd, k))
    cross[2] = 0.0
    C_old = rng.normal(size=(Dd, k))
    stats = tml.EMStats(
        cross=torch.from_numpy(cross), S=torch.from_numpy(S.reshape(Dd, k * k)),
        square_error=torch.tensor(1.0, dtype=torch.float64),
        dev_sq=torch.tensor(1.0, dtype=torch.float64),
        total_dev=torch.zeros(Dd, dtype=torch.float64),
        totals=torch.full((Dd,), 5.0, dtype=torch.float64),
        llk=torch.tensor(0.0, dtype=torch.float64),
    )
    new_C, _, _ = tml.em_finalize(torch.from_numpy(C_old), torch.zeros(Dd, dtype=torch.float64),
                                  torch.tensor(1.0, dtype=torch.float64), stats,
                                  transformation_precision=0.0)
    np.testing.assert_array_equal(new_C[2].numpy(), C_old[2])
    keep = np.arange(Dd) != 2
    want = np.linalg.solve(S[keep], cross[keep][..., None])[..., 0]
    np.testing.assert_allclose(new_C[keep].numpy(), want, rtol=1e-10)
