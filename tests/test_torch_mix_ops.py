"""The port's fused mixture operations (ppca_rs_tpu_torch.ops.mix_fused)
against the JAX package's (ppca_rs_tpu.ops.mix_fused), both in float64 on
the CPU, called directly on the same numpy inputs; plus the launch
structure on the batch axis (which kernel variant, how many launches, how
many samples each), ``config.mix_exact_rnorm`` on both routes, and float32
against float64.  Tolerance 1e-9 relative unless a test states another.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppca_rs_tpu.config import config as jconfig
from ppca_rs_tpu.ops import mix_fused as jmf
from ppca_rs_tpu_torch.config import MIX_BLOCK_MAX_BYTES, Config
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.ops import mix_fused as tmf

torch.set_num_threads(1)

TOL = 1e-9
F64 = torch.float64


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def close(got, want, rtol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def make_inputs(rng, route="masked", M=3, N=70, D=9, k=3):
    """numpy (Cs, means, sigmas, log_weights, data, mask, weights, pidx,
    patterns); pidx/patterns are None on the masked route.  An all-masked
    row (on the table route: an all-masked pattern) and a zero-weight row."""
    Cs = rng.normal(size=(M, D, k))
    means = rng.normal(size=(M, D))
    sigmas = 0.5 + rng.random(M)
    lw = np.log(rng.dirichlet(np.ones(M)))
    pidx = patterns = None
    if route == "masked":
        mask = rng.random((N, D)) > 0.3
        mask[3] = False
    else:
        patterns = rng.random((4, D)) > 0.3
        patterns[1] = False
        if route == "dense":
            patterns = np.ones((1, D), dtype=bool)
        pidx = rng.integers(0, patterns.shape[0], size=N)
        pidx[:patterns.shape[0]] = np.arange(patterns.shape[0])
        mask = patterns[pidx]
    data = np.where(mask, rng.normal(size=(N, D)) + means[rng.integers(0, M, size=N)], 0.0)
    weights = rng.random(N) + 0.5
    weights[5] = 0.0
    return Cs, means, sigmas, lw, data, mask, weights, pidx, patterns


def as_torch(arrays, dtype=F64):
    return [None if a is None else
            torch.as_tensor(a, dtype=None if a.dtype in (bool, np.int64) else dtype)
            for a in arrays]


def as_jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def symmetric(S, k):
    """The lower triangle of each (k, k) square, mirrored (what
    mix_em_finalize reads)."""
    S = np.asarray(S, np.float64).reshape(*np.shape(S)[:-1], k, k)
    low = np.tril(S)
    return low + np.swapaxes(np.tril(S, -1), -1, -2)


def stats_both(inputs, exact, block=32):
    """The port's and the JAX package's statistics of one fused pass."""
    Cs, means, sigmas, lw, data, mask, w, pidx, pats = inputs
    t, j = as_torch(inputs), as_jax(inputs)
    old = jconfig.mix_exact_rnorm
    jconfig.mix_exact_rnorm = tconfig.mix_exact_rnorm = exact
    try:
        if pidx is None:
            got = tmf.mix_em_stats(*t[:7], block_size=block)
            want = jmf.mix_em_stats(*j[:7], block_size=block)
        else:
            got = tmf.mix_em_stats_pat(*t[:6], t[7], t[8], t[6], block_size=block)
            want = jmf.mix_em_stats_pat(*j[:6], j[7], j[8], j[6], block_size=block)
    finally:
        jconfig.mix_exact_rnorm = old
        tconfig.mix_exact_rnorm = False
    return got, want


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("route", ["masked", "table", "dense"])
def test_em_stats_match(rng, route, exact, k):
    """Every MixEMStats field of mix_em_stats (masked route) or
    mix_em_stats_pat (table and dense routes), with and without
    config.mix_exact_rnorm.  The table route's P=4 patterns take the
    index_add_ grouping at k=3 and the one-hot matmuls at k=5 (P <= k), as
    dense data's one pattern always does."""
    inputs = make_inputs(rng, route, k=k)
    got, want = stats_both(inputs, exact)
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "S":
            g, w = symmetric(g, k), symmetric(w, k)
        close(g, w)


def test_compute_mix_tables_match(rng):
    Cs, _, sigmas, _, _, _, _, _, pats = make_inputs(rng, "table")
    got = tmf.compute_mix_tables(torch.from_numpy(Cs), torch.from_numpy(sigmas),
                                 torch.from_numpy(pats).to(F64))
    want = jmf.compute_mix_tables(jnp.asarray(Cs), jnp.asarray(sigmas), jnp.asarray(pats, jnp.float64))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("route", ["masked", "table"])
def test_readout_functions_match(rng, route):
    inputs = make_inputs(rng, route)
    Cs, means, sigmas, lw, data, mask, _, pidx, pats = as_torch(inputs)
    jCs, jmeans, jsig, jlw, jdata, jmask, _, jpidx, jpats = as_jax(inputs)
    kw = dict(block_size=16, pidx=pidx, patterns=pats)
    jkw = dict(block_size=16, pidx=jpidx, patterns=jpats)
    close(tmf.mix_llks(Cs, means, sigmas, data, mask, **kw),
          jmf.mix_llks(jCs, jmeans, jsig, jdata, jmask, **jkw))
    for g, w in zip(tmf.mix_infer(Cs, means, sigmas, lw, data, mask, **kw),
                    jmf.mix_infer(jCs, jmeans, jsig, jlw, jdata, jmask, **jkw)):
        close(g, w)
    for extrapolate in (False, True):
        close(tmf.mix_smooth(Cs, means, sigmas, lw, data, mask, extrapolate=extrapolate, **kw),
              jmf.mix_smooth(jCs, jmeans, jsig, jlw, jdata, jmask, extrapolate=extrapolate, **jkw))


def test_block_rows_do_not_change_results(rng):
    Cs, means, sigmas, lw, data, mask, w, _, _ = as_torch(make_inputs(rng))
    a = tmf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=7)
    b = tmf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=1024)
    for x, y in zip(a, b):
        close(x, y, 1e-12)


def test_estep_stacks_components_component_major(rng):
    """One launch over M x B samples with sigma repeated per component
    equals M launches with that component's scalar sigma."""
    M, B, k = 3, 11, 4
    V = torch.from_numpy(rng.normal(size=(M, B, k, 2 * k)))
    G = (V @ V.mT).reshape(M, B, k * k)
    b = torch.from_numpy(rng.normal(size=(M, B, k)))
    rnorm = (b * b).sum(-1) + 1.0
    d_obs = torch.full((B,), 6.0, dtype=F64)
    sigmas = torch.tensor([0.5, 1.0, 1.7], dtype=F64)
    for want in tk.WANTS:
        stacked = tmf._estep(sigmas, G, b, rnorm, d_obs, want)
        for m in range(M):
            one = tk.spd_estep(sigmas[m], G[m].reshape(B, k, k), b[m], rnorm[m], d_obs, want=want)
            got = [x[m] for x in stacked if x is not None]   # llks, s, mat, sq
            mats = {"llk": [0], "states": [1, 0]}.get(want, [2, 0, 1, 3])
            for g, i in zip(got, mats):
                close(g.reshape(one[i].shape), one[i], 1e-13)


class _Counting:
    """kernels.spd_estep that records (want, batch) of every call and runs
    the plain version, as the wrapper does on the CPU."""

    def __init__(self):
        self.calls = []

    def __call__(self, sigma, G, b, rnorm, d_obs, want="fullt"):
        self.calls.append((want, G.shape[0]))
        return tk.spd_estep_reference(sigma, G, b, rnorm, d_obs, want)


@pytest.mark.parametrize("route", ["masked", "dense"])
def test_launch_structure(rng, monkeypatch, route):
    """The general route launches fullt once per block of rows, on M x rows
    samples, and states once per EM step on M x D rows; each readout one
    launch per block.  Fully observed data takes the table route: one full
    launch of M x 1 samples per step and readout, no fullt."""
    from ppca_rs_tpu_torch import interop

    Cs, means, sigmas, lw, data, mask, w, _, _ = make_inputs(rng, route, M=3, N=70, D=9)
    mix = interop.mix_from_arrays(list(Cs), list(means), list(sigmas), lw)
    ds = interop.dataset_from_arrays(data, mask, w)
    counting = _Counting()
    monkeypatch.setattr(tk, "spd_estep", counting)
    monkeypatch.setattr(tconfig, "block_size", 32)
    mix.iterate(ds)
    mix.llk(ds)
    mix.infer(ds)
    mix.smooth(ds)
    if route == "masked":
        step = [("fullt", 96), ("fullt", 96), ("fullt", 18), ("states", 27)]
        reads = [(want, n) for want in ("llk", "infer", "states") for n in (96, 96, 18)]
    else:
        step = [("full", 3), ("states", 27)]
        reads = [("full", 3)] * 3
    assert counting.calls == step + reads


def test_mix_block_rows():
    cfg = Config(device=torch.device("cpu"))
    assert cfg.mix_block_rows(8, 32, 4) == 8192          # 256 MiB a (M rows, k, k) tensor
    assert cfg.mix_block_rows(8, 64, 4) == 4096          # 1 GiB at 8192 rows: halved
    assert cfg.mix_block_rows(8, 64, 8) == 2048
    assert cfg.mix_block_rows(1, 128, 4) == 8192         # the single-model route's own size
    assert 8 * cfg.mix_block_rows(8, 100, 4) * 100 * 100 * 4 <= MIX_BLOCK_MAX_BYTES


def test_exact_rnorm_envelope_float32(rng):
    """At a component-mean separation of 300 against noise 0.5, the default
    block's expanded |r|^2 cancels in float32; config.mix_exact_rnorm
    computes it from the residual and tracks float64 far closer (the
    envelope config.py states)."""
    M, B, D, k = 2, 256, 64, 4
    centers = np.stack([np.full(D, -150.0), np.full(D, 150.0)])
    data = centers[rng.integers(0, M, size=B)] + 0.5 * rng.normal(size=(B, D))
    mask = torch.from_numpy(rng.random((B, D)) > 0.3)
    C = rng.normal(size=(D, k))

    def stats(dtype, exact):
        args = (torch.as_tensor(np.tile(C, (M, 1, 1)) * 0.5, dtype=dtype),
                torch.as_tensor(centers, dtype=dtype), torch.full((M,), 0.5, dtype=dtype),
                torch.log(torch.full((M,), 1.0 / M, dtype=dtype)),
                torch.where(mask, torch.as_tensor(data, dtype=dtype), 0.0), mask,
                torch.ones(B, dtype=dtype))
        tconfig.mix_exact_rnorm = exact
        try:
            return tmf.mix_em_stats(*args, block_size=128)
        finally:
            tconfig.mix_exact_rnorm = False

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    oracle = stats(F64, False)
    fast, exact = stats(torch.float32, False), stats(torch.float32, True)
    err_fast, err_exact = rel(fast.dev_sq, oracle.dev_sq), rel(exact.dev_sq, oracle.dev_sq)
    assert err_exact < 1e-5, err_exact
    assert err_fast > 10 * err_exact, (err_fast, err_exact)
    assert err_fast < 1e-2, err_fast
    assert rel(exact.llk, oracle.llk) < 1e-6


def test_float32_step_matches_float64(rng):
    """One fused EM step in float32 against float64 on the same inputs.
    Bound 1e-4 relative to each quantity's largest magnitude: float32 sums
    over 200 rows, and the llk's quadratic form cancels."""
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop

    Cs, means, sigmas, lw, data, mask, w, _, _ = make_inputs(rng, N=200)
    out = {}
    for dtype in (torch.float32, F64):
        mix = interop.mix_from_arrays(list(Cs), list(means), list(sigmas), lw, dtype=dtype)
        ds = interop.dataset_from_arrays(data, mask, w, dtype=dtype)
        out[dtype] = mix._iterate_with_llk(ds, tp.Prior())
    (m32, l32), (m64, l64) = out[torch.float32], out[F64]
    assert m32.models[0].transform.dtype == torch.float32
    assert l32 == pytest.approx(l64, rel=1e-4)
    close(m32.log_weights.double(), m64.log_weights, 1e-4)
    for a, b in zip(m32.models, m64.models):
        close(a.transform.double(), b.transform, 1e-4)
        close(a.mean.double(), b.mean, 1e-4)
        assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=1e-4)


def test_finalize_singular_row_stays_alone(rng):
    """An empty dimension of one component (no observations, lambda = 0)
    makes its row solve non-finite: that row keeps its old value and every
    other row and component gets the solve, as separate M-steps would."""
    Cs, means, sigmas, lw, data, mask, w, _, _ = as_torch(make_inputs(rng, M=2, N=80))
    mask[:, 2] = False
    data[:, 2] = 0.0
    stats = tmf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=32)
    zero = torch.zeros((), dtype=F64)
    new_Cs, new_means, new_sigmas, _ = tmf.mix_em_finalize(
        Cs, means, sigmas, stats, transformation_precision=zero)
    assert torch.equal(new_Cs[:, 2], Cs[:, 2])
    assert bool(torch.isfinite(new_Cs).all() and torch.isfinite(new_sigmas).all())
    for m in range(2):
        c = 1.0 / stats.resp_max[m]
        one = tml.EMStats(*(x[m] * c for x in stats[:6]), llk=zero)
        want = tml.em_finalize(Cs[m], means[m], sigmas[m], one, transformation_precision=zero)
        close(new_Cs[m], want[0])
        close(new_means[m], want[1])
        close(new_sigmas[m], want[2])


def test_finalize_subnormal_component_keeps_params(rng):
    """A float32 component whose responsibilities are all subnormal (the
    reciprocal of its resp_max, the max-1 rescale, overflows) is dead: it
    keeps its parameters, finite, and the other component gets the M-step
    it gets beside a live one."""
    Cs, means, sigmas, lw, data, mask, w, _, _ = as_torch(make_inputs(rng, M=2, N=80),
                                                        torch.float32)
    stats = tmf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=32)
    shrink = torch.tensor([1.0, 1e-44])
    sub = tmf.MixEMStats(*(x * shrink.view(-1, *([1] * (x.ndim - 1))) for x in stats[:8]),
                         llk=stats.llk)
    assert 0.0 < float(sub.resp_max[1]) < torch.finfo(torch.float32).tiny
    zero = torch.zeros(())
    new = tmf.mix_em_finalize(Cs, means, sigmas, sub, transformation_precision=zero)
    live = tmf.mix_em_finalize(Cs, means, sigmas, stats, transformation_precision=zero)
    assert all(bool(torch.isfinite(x).all()) for x in new[:3])
    assert torch.equal(new[0][1], Cs[1]) and torch.equal(new[1][1], means[1])
    assert float(new[2][1]) == float(sigmas[1])
    for got, want in zip(new[:3], live[:3]):
        torch.testing.assert_close(got[0], want[0])
    assert float(torch.exp(new[3][1])) < 1e-30

def test_em_finalize_takes_transform_rows(rng):
    D, k = 6, 2
    C = torch.from_numpy(rng.normal(size=(D, k)))
    V = torch.from_numpy(rng.normal(size=(D, k, 3)))
    S = (V @ V.mT).reshape(D, k * k)
    stats = tml.EMStats(torch.from_numpy(rng.normal(size=(D, k))), S, torch.tensor(2.0, dtype=F64),
                        torch.tensor(3.0, dtype=F64), torch.from_numpy(rng.normal(size=D)),
                        torch.full((D,), 5.0, dtype=F64), torch.tensor(0.0, dtype=F64))
    mean, sigma, lam = torch.zeros(D, dtype=F64), torch.tensor(0.7, dtype=F64), torch.tensor(0.1, dtype=F64)
    plain = tml.em_finalize(C, mean, sigma, stats, transformation_precision=lam)
    rows = tml.rows_solve(tml.symmetric_from_lower(S.reshape(D, k, k)), stats.cross, lam)
    rows[1] = float("nan")
    given = tml.em_finalize(C, mean, sigma, stats, transformation_precision=lam, transform_rows=rows)
    close(given[0][[0, 2, 3, 4, 5]], plain[0][[0, 2, 3, 4, 5]], 1e-14)
    assert torch.equal(given[0][1], C[1])
    close(given[1], plain[1], 0)
    close(given[2], plain[2], 0)
