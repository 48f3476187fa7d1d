"""The port's fully-observed path (ppca_rs_tpu_torch.ops.dense_fast and the
model's routing) against the JAX package's ops/dense_fast and against the
port's own masked path under an all-True mask, in float64 on the CPU.

Tolerance: 1e-9 relative (docs/DESIGN.md section 6).  The blocks are
ragged (N = 150 rows in blocks of 64) and one row has zero weight.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu.ops import dense_fast as jdf
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.ops import dense_fast as tdf
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

RTOL = 1e-9
N, D, K, BLOCK = 150, 10, 3, 64


@pytest.fixture
def problem(rng):
    C = rng.normal(size=(D, K))
    mean = rng.normal(size=D) * 3.0
    data = rng.normal(size=(N, K)) @ C.T + mean + 0.5 * rng.normal(size=(N, D))
    weights = rng.random(N) + 0.5
    weights[20] = 0.0
    return C, mean, 0.6, data, weights


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def both(C, mean, sigma, *arrays):
    t = [torch.from_numpy(C), torch.from_numpy(mean), torch.tensor(sigma, dtype=torch.float64)]
    j = [jnp.asarray(C), jnp.asarray(mean), jnp.float64(sigma)]
    return t + [torch.from_numpy(a) for a in arrays], j + [jnp.asarray(a) for a in arrays]


def priors(rng, kind):
    """(torch kwargs, jax kwargs) of em_finalize for no prior or every prior."""
    if kind == "none":
        return (dict(transformation_precision=torch.tensor(0.0, dtype=torch.float64)),
                dict(transformation_precision=jnp.float64(0.0)))
    A = rng.normal(size=(D, D))
    pm, prec = rng.normal(size=D), A @ A.T / D + np.eye(D)
    return (dict(transformation_precision=torch.tensor(0.4, dtype=torch.float64),
                 noise_prior=(torch.tensor(2.0, dtype=torch.float64),
                              torch.tensor(0.5, dtype=torch.float64)),
                 mean_prior=(torch.from_numpy(pm), torch.from_numpy(prec))),
            dict(transformation_precision=jnp.float64(0.4),
                 noise_prior=(jnp.float64(2.0), jnp.float64(0.5)),
                 mean_prior=(jnp.asarray(pm), jnp.asarray(prec))))


@pytest.mark.parametrize("verb", ["llks", "states", "infer"])
def test_verbs_match_jax(problem, verb):
    C, mean, sigma, data, _ = problem
    t, j = both(C, mean, sigma, data)
    got = getattr(tdf, verb)(*t, block_size=BLOCK)
    want = getattr(jdf, verb)(*j)
    for g, w in zip(got if verb == "infer" else [got], want if verb == "infer" else [want]):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def test_dense_posterior_matches_jax(problem):
    C, _, sigma, _, _ = problem
    got = tdf.dense_posterior(torch.from_numpy(C), torch.tensor(sigma, dtype=torch.float64))
    want = jdf.dense_posterior(jnp.asarray(C), jnp.float64(sigma))
    for name in tdf.DensePosterior._fields:
        close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("block", [BLOCK, 1000])
def test_em_stats_match_jax(problem, block):
    C, mean, sigma, data, weights = problem
    t, j = both(C, mean, sigma, data, weights)
    got = tdf.em_stats(*t, block_size=block)
    want = jdf.em_stats(*j, block_size=block)
    for name in tdf.DenseEMStats._fields:
        close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("prior", ["none", "all"])
def test_em_finalize_matches_jax(problem, rng, prior):
    C, mean, sigma, data, weights = problem
    t, j = both(C, mean, sigma, data, weights)
    t_kw, j_kw = priors(rng, prior)
    got = tdf.em_finalize(*t[:3], tdf.em_stats(*t, block_size=BLOCK), **t_kw)
    want = jdf.em_finalize(*j[:3], jdf.em_stats(*j, block_size=BLOCK), **j_kw)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("prior", ["none", "all"])
def test_dense_equals_masked_all_true(problem, rng, prior):
    """The dense path is the masked path under an all-True mask."""
    C, mean, sigma, data, weights = problem
    t, _ = both(C, mean, sigma, data, weights)
    mask = torch.ones((N, D), dtype=torch.bool)
    t_kw, _ = priors(rng, prior)
    close(tdf.llks(*t[:4], block_size=BLOCK), tml.llks(*t[:4], mask, block_size=BLOCK))
    for g, w in zip(tdf.infer(*t[:4], block_size=BLOCK), tml.infer(*t[:4], mask, block_size=BLOCK)):
        close(g, w)
    dense = tdf.em_finalize(*t[:3], tdf.em_stats(*t, block_size=BLOCK), **t_kw)
    masked_stats = tml.em_stats(*t[:4], mask, t[4], block_size=BLOCK)
    masked = tml.em_finalize(*t[:3], masked_stats, **t_kw)
    for g, w in zip(dense, masked):
        close(g, w)
    close(tdf.em_stats(*t, block_size=BLOCK).llk, masked_stats.llk)


def test_routing_and_training_match_jax(problem, monkeypatch):
    """A fully-observed dataset routes to the dense path (no kernel, no
    masked or pattern EM), and five trainer iterations match the JAX
    package's."""
    C, mean, sigma, data, weights = problem
    calls = []
    orig = tdf.em_stats
    monkeypatch.setattr(tdf, "em_stats", lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    monkeypatch.setattr(tml, "em_stats", None)
    tds = interop.dataset_from_arrays(data, np.ones((N, D), bool), weights)
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.ones((N, D), bool), jnp.asarray(weights))
    assert tds.all_observed() and tds.pattern_info() is None
    C0 = C + 0.3
    t_hist, j_hist = [], []
    tk.reset_launch_counts()
    tm = tp.PPCATrainer(tds).train(start=interop.model_from_arrays(C0, mean, 1.1), state_size=K,
                                   n_iters=5, quiet=True, callback=lambda i, m: t_hist.append(m))
    jm = jp.PPCATrainer(jds).train(start=jp.PPCAModel(isotropic_noise=1.1, transform=C0, mean=mean),
                                   state_size=K, n_iters=5, quiet=True,
                                   callback=lambda i, m: j_hist.append(m))
    assert len(calls) == 5
    for tmet, jmet in zip(t_hist, j_hist):
        for f in ("llk", "aic", "bic"):
            assert getattr(tmet, f) == pytest.approx(getattr(jmet, f), rel=RTOL)
    close(tm.transform, jm.transform)
    close(tm.mean, jm.mean)
    assert float(tm.isotropic_noise) == pytest.approx(jm.isotropic_noise, rel=RTOL)
    close(tm.llks(tds), jm.llks(jds))
    close(tm.infer(tds).covariances_array(), jm.infer(jds).covariances_array())
    close(tm.smooth(tds).numpy(), jm.smooth(jds).numpy())
    close(tm.extrapolate(tds).numpy(), data, 1e-15)
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def test_empty_dataset_routes_dense():
    model = interop.model_from_arrays(np.ones((3, 2)), np.zeros(3), 0.5)
    empty = tp.Dataset(np.zeros((0, 3)), dtype=torch.float64)
    assert model.llks(empty).shape == (0,)
    inferred = model.infer(empty)
    assert inferred.states().shape == (0, 2) and inferred.covariances_array().shape == (0, 2, 2)


# --------------------------------------------------------------------- #
# the route's spans, counters and failure mode


def recorded(fn):
    """``fn()``'s result and the names of the ``ppca.*`` ranges it recorded,
    under a CPU profiler started and stopped by hand."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("ppca.")]


def verb_call(verb, t):
    """``verb`` of dense_fast on the problem's tensors ``t``: em_stats takes
    the weights, the readout verbs do not."""
    if verb == "em_stats":
        return tdf.em_stats(*t, block_size=BLOCK)
    return getattr(tdf, verb)(*t[:4], block_size=BLOCK)


@pytest.mark.parametrize("verb", ["em_stats", "llks", "states"])
def test_one_block_span_a_block(problem, verb):
    """N = 150 rows in blocks of 64: three ``ppca.block`` ranges, and what
    the verb returns is the same as with no profiler recording."""
    C, mean, sigma, data, weights = problem
    t, _ = both(C, mean, sigma, data, weights)
    got, names = recorded(lambda: verb_call(verb, t))
    assert names.count("ppca.block") == -(-N // BLOCK) == 3
    want = verb_call(verb, t)
    for g, w in zip(got if verb == "em_stats" else [got], want if verb == "em_stats" else [want]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("verb,posteriors", [("em_stats", 1), ("llks", 1), ("states", 1),
                                              ("infer", 2)])
def test_counts_a_pass(problem, verb, posteriors):
    """One shared factorization a call (``infer``: its states' and its
    covariance's), and the blocks and rows the pass walks."""
    C, mean, sigma, data, weights = problem
    t, _ = both(C, mean, sigma, data, weights)
    tdf.reset_counts()
    if verb in ("em_stats", "llks", "states"):
        verb_call(verb, t)
    else:
        tdf.infer(*t[:4], block_size=BLOCK)
    assert tdf.COUNTS == {"posteriors": posteriors, "blocks": 3, "rows": N}
    tdf.reset_counts()
    assert tdf.COUNTS == {"posteriors": 0, "blocks": 0, "rows": 0}


def test_step_counts_and_spans_through_the_trainer(problem, monkeypatch):
    """One trainer iteration on the dense route walks every row once, in
    blocks of ``config.segment_rows`` rows (here lowered to 40 rows: four
    blocks of N = 150), under one factorization; with a profiler recording,
    each block is a ``ppca.block`` range inside ``ppca.em_stats``, and the
    model is the same as with none."""
    import sys

    C, mean, sigma, data, weights = problem
    monkeypatch.setattr(tconfig, "block_size", 16)
    monkeypatch.setattr(sys.modules["ppca_rs_tpu_torch.config"], "MIX_BLOCK_MAX_BYTES", 40 * D * 8)
    assert tconfig.segment_rows(D, 8) == 40
    tds = interop.dataset_from_arrays(data, np.ones((N, D), bool), weights)
    start = interop.model_from_arrays(C + 0.3, mean, 1.1)

    def step():
        return tp.PPCATrainer(tds).train(start=start, state_size=K, n_iters=1, quiet=True)

    tdf.reset_counts()
    plain = step()
    assert tdf.COUNTS == {"posteriors": 1, "blocks": 4, "rows": N}
    traced, names = recorded(step)
    assert names.count("ppca.block") == 4 and names.count("ppca.em_stats") == 1
    for name in ("transform", "mean", "isotropic_noise"):
        assert torch.equal(getattr(traced, name), getattr(plain, name))


def test_a_precision_that_does_not_factor_gives_nan_and_keeps_the_transform():
    """sigma = 0 with a zero column of C: M = C^T C has a zero pivot, so the
    shared factor is NaN (no exception, as the JAX package's Cholesky gives
    NaN), the statistics are not finite, and the M-step keeps the old
    transform and returns a NaN mean and sigma, as the JAX package's does."""
    C = np.array([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    data, weights = np.arange(12.0).reshape(4, 3), np.ones(4)
    t, j = both(C, np.zeros(3), 0.0, data, weights)
    post = tdf.dense_posterior(t[0], t[2])
    assert torch.isnan(post.Minv).all() and torch.isnan(post.logdet)
    stats = tdf.em_stats(*t, block_size=BLOCK)
    assert not torch.isfinite(stats.llk)
    got = tdf.em_finalize(*t[:3], stats,
                          transformation_precision=torch.tensor(0.0, dtype=torch.float64))
    want = jdf.em_finalize(*j[:3], jdf.em_stats(*j, block_size=BLOCK),
                           transformation_precision=jnp.float64(0.0))
    assert torch.equal(got[0], t[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_a_singular_m_step_keeps_the_transform(problem):
    """A second-moment matrix that does not solve (all weights 0, no
    transformation prior): the solve gives NaN, not an exception, and the
    old transform is kept."""
    C, mean, sigma, data, _ = problem
    t, _ = both(C, mean, sigma, data, np.zeros(N))
    stats = tdf.em_stats(*t, block_size=BLOCK)
    new_C, new_mean, _ = tdf.em_finalize(*t[:3], stats,
                                         transformation_precision=torch.tensor(0.0,
                                                                               dtype=torch.float64))
    assert torch.equal(new_C, t[0])
    assert torch.equal(new_mean, t[1])
