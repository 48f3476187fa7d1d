"""Large state sizes: the port against the JAX package on the CPU in float64
at k = 160 and 256 (past the register tiles, where the card runs the panel
design of csrc/spd_panel.cuh), the block-rows rule and the panel design's
scratch.

On the CPU every kernel call runs its plain version, so the parity tests
hold the port's large-k paths (masked and pattern EM, readouts, the row
solve at lambda = 0 with an empty dimension, heterogeneous mixtures, the
sampler) to the JAX package's at 1e-9 relative.  The kernel itself is held
against its plain version on the card (chip_smoke.py, phase 2).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch import streaming
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)
tconfig_module = importlib.import_module("ppca_rs_tpu_torch.config")

TOL = 1e-9
KS = (160, 256)
N, D = 64, 264


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def close(got, want, rtol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def make_case(k, kind="masked", empty_dim=None, seed=0):
    """(torch dataset, JAX dataset, torch model, JAX model) at state size k:
    N rows of a rank-k model plus noise at D, masked at random or by four
    patterns; ``empty_dim`` is a column never observed."""
    rng = np.random.default_rng(seed + k)
    C = rng.normal(size=(D, k)) / np.sqrt(k)
    mean = rng.normal(size=D)
    data = rng.normal(size=(N, k)) @ C.T + mean + 0.5 * rng.normal(size=(N, D))
    if kind == "pattern":
        mask = (rng.random((4, D)) < 0.6)[rng.integers(0, 4, size=N)]
    else:
        mask = rng.random((N, D)) > 0.5
    if empty_dim is not None:
        mask[:, empty_dim] = False
    data = np.where(mask, data, 0.0)
    C0 = C + 0.1 * rng.normal(size=(D, k))
    return (interop.dataset_from_arrays(data, mask),
            jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask)),
            interop.model_from_arrays(C0, mean, 0.8),
            jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean))


def assert_model_close(tm, jm):
    close(tm.transform, jm.transform)
    close(tm.mean, jm.mean)
    assert float(tm.isotropic_noise) == pytest.approx(float(jm.isotropic_noise), rel=TOL)


@pytest.mark.parametrize("k", KS)
def test_masked_em_step_matches_jax(k):
    tds, jds, tm, jm = make_case(k)
    assert tds.pattern_info() is None
    tnew, tllk = tm._iterate_with_llk(tds, None)
    jnew, jllk = jm._iterate_with_llk(jds, None)
    assert tllk == pytest.approx(jllk, rel=TOL)
    assert_model_close(tnew, jnew)


@pytest.mark.parametrize("k", KS)
def test_masked_readouts_match_jax(k):
    """llk (per sample), infer (states and covariances: the kernel's infer)
    and smooth (the kernel's states)."""
    tds, jds, tm, jm = make_case(k, seed=1)
    close(tm.llks(tds), jm.llks(jds))
    ti, ji = tm.infer(tds), jm.infer(jds)
    close(ti.states(), ji.states())
    close(ti.covariances_array(), ji.covariances_array())
    close(tm.smooth(tds).numpy(), jm.smooth(jds).numpy())


@pytest.mark.parametrize("k", KS)
def test_pattern_em_step_matches_jax(k):
    """The pattern route: ``full`` at the P tables, then the EM step."""
    tds, jds, tm, jm = make_case(k, kind="pattern", seed=2)
    assert tds.pattern_info() is not None and tds.pattern_info()[1].shape[0] == 4
    tnew, tllk = tm._iterate_with_llk(tds, None)
    jnew, jllk = jm._iterate_with_llk(jds, None)
    assert tllk == pytest.approx(jllk, rel=TOL)
    assert_model_close(tnew, jnew)


@pytest.mark.parametrize("k", KS)
def test_row_solve_with_an_empty_dimension(k):
    """lambda = 0 and a column never observed: that row's system is
    singular and goes non-finite alone in the row solve, the M-step keeps
    its old row, and the step matches the JAX package."""
    tds, jds, tm, jm = make_case(k, empty_dim=3, seed=3)
    tnew, jnew = tm.iterate(tds), jm.iterate(jds)
    assert_model_close(tnew, jnew)
    close(tnew.transform[3], tm.transform[3], 0.0)
    rng = np.random.default_rng(k)
    V = rng.normal(size=(5, k, 2 * k)) / np.sqrt(2 * k)
    S = torch.from_numpy(V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k))
    S[2] = 0.0
    cross = torch.from_numpy(rng.normal(size=(5, k)))
    zeros = torch.zeros(5, dtype=torch.float64)
    sol, _ = tk.spd_estep(0.0, S, cross, zeros, zeros, want="states")
    good = [0, 1, 3, 4]
    assert not torch.isfinite(sol[2]).any() and torch.isfinite(sol[good]).all()
    close(sol[good], np.linalg.solve(S[good].numpy(), cross[good].numpy()[..., None])[..., 0])


def make_mixes(seed=4):
    """A two-component mixture of state sizes 256 and 160, masked at
    random, in both packages."""
    rng = np.random.default_rng(seed)
    ks = (256, 160)
    comp = rng.integers(0, 2, size=N)
    Cs = [rng.normal(size=(D, k)) / np.sqrt(k) for k in ks]
    means = [3.0 * rng.normal(size=D) for _ in ks]
    data = np.stack([Cs[c] @ rng.normal(size=ks[c]) + means[c] for c in comp])
    data += 0.3 * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.4
    data = np.where(mask, data, 0.0)
    starts = [C + 0.1 * rng.normal(size=C.shape) for C in Cs]
    noises, lw = [0.5, 0.6], np.log([0.4, 0.6])
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in zip(starts, means, noises)], lw)
    tmix = interop.mix_from_arrays(starts, means, noises, lw)
    return (interop.dataset_from_arrays(data, mask),
            jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask)), tmix, jmix)


def test_heterogeneous_mixture_matches_jax():
    """Components of k = 256 and 160 ride one fused pass zero-padded to
    256 on the general route (fullt, llk and the row solve at M x rows
    samples): one EM step and infer_cluster against the JAX package."""
    tds, jds, tmix, jmix = make_mixes()
    assert routes.route(tds, mixture=True).kind == "masked"
    close(tmix.infer_cluster(tds), jmix.infer_cluster(jds))
    tnew, tllk = tmix._iterate_with_llk(tds, None)
    jnew, jllk = jmix._iterate_with_llk(jds, jp.Prior())
    assert tllk == pytest.approx(jllk, rel=TOL)
    assert tnew.state_sizes == jnew.state_sizes == [256, 160]
    close(tnew.log_weights, jnew.log_weights)
    for a, b in zip(tnew.models, jnew.models):
        close(a.transform, b.transform)
        close(a.mean, b.mean)
        assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=TOL)


def test_sampler_at_k256_matches_jax_moments():
    """The sampler's factor (spd_chol at k=256) against the JAX sampler's,
    and its draws' moments against the JAX package's posterior: mean ~=
    smoothed values, variance ~= the smoothed covariance diagonal."""
    tds, jds, tm, jm = make_case(256, seed=5)
    rows = 6
    tsub = tds.slice(0, rows)
    jsub = jp.Dataset.from_parts(jds.data[:rows], jds.mask[:rows])
    sampler = tm.infer(tsub).posterior_sampler()
    jinf = jm.infer(jsub)
    close(sampler._chol, jinf.posterior_sampler()._chol)
    gen = torch.Generator().manual_seed(11)
    draws = torch.stack([sampler.sample(generator=gen).data for _ in range(400)])
    smooth = np.asarray(jm.smooth(jsub).numpy())
    var = np.asarray(jinf.smoothed_covariances_diagonal(jm).numpy())
    se = np.sqrt(var / 400)
    assert np.all(np.abs(draws.mean(0).numpy() - smooth) <= 6 * se)
    ratio = float(draws.var(0).mean() / var.mean())
    assert abs(ratio - 1.0) <= 0.1


@pytest.mark.parametrize("k, itemsize, rows", [
    (64, 4, 8192), (128, 4, 8192), (256, 4, 2048), (512, 4, 512),
    (128, 8, 4096), (256, 8, 1024), (512, 8, 256)])
def test_block_rows_rule(k, itemsize, rows):
    """Single-model blocks halve from config.block_size until one
    (rows, k, k) tensor fits 512 MiB."""
    assert tconfig.block_rows(k, itemsize) == rows


def test_mixture_block_rule_unchanged():
    assert tconfig.mix_block_rows(8, 32, 4) == 8192
    assert tconfig.mix_block_rows(8, 64, 4) == 4096
    assert tconfig.mix_block_rows(2, 192, 4) == 1024
    assert tconfig.mix_block_rows(1, 256, 4) == tconfig.block_rows(256, 4)


@pytest.mark.parametrize("verb", ["iterate", "llks", "infer", "streamed"])
def test_block_rows_reach_the_blocked_loops(monkeypatch, verb):
    """With a 4 MiB budget a k=160 float64 model takes 16-row blocks
    (16 x 160 x 160 x 8 bytes = 3.1 MiB) in every single-model loop, and
    the results are those of one block."""
    tds, _, tm, _ = make_case(160, seed=6)
    whole = {"iterate": lambda: tm.iterate(tds).transform,
             "llks": lambda: tm.llks(tds),
             "infer": lambda: tm.infer(tds).covariances_array(),
             "streamed": lambda: streaming.iterate_streamed(tm, [tds.slice(0, 40),
                                                                 tds.slice(40, N)])[0].transform}
    want = whole[verb]()
    monkeypatch.setattr(tconfig_module, "MIX_BLOCK_MAX_BYTES", 4 << 20)
    assert tconfig.block_rows(160, 8) == 16
    seen = []
    plain = tk.spd_estep

    def spy(sigma, G, *args, **kw):
        seen.append(G.shape[0])
        return plain(sigma, G, *args, **kw)

    monkeypatch.setattr(tk, "spd_estep", spy)
    got = whole[verb]()
    # every sample block has 16 rows at most; the row solve has D rows
    assert 16 in seen and all(b <= 16 or b == D for b in seen)
    close(got, want)


@pytest.mark.parametrize("want", list(tk.WANTS))
def test_scratch_shapes(want):
    """llk and states give the panel design a (B, k+1, k) working matrix
    and right-hand side; the other variants work in their own k x k
    output."""
    expected = (7, 201, 200) if want in ("llk", "states") else None
    assert tk.scratch_shape(want, 7, 200) == expected


def test_empty_scratch_follows_the_design(monkeypatch):
    """The scratch is allocated only where the panel design serves k."""
    like = torch.zeros(1, dtype=torch.float32)
    monkeypatch.setattr(tk, "design", lambda k, kernel="estep", dtype=torch.float32:
                        "tile" if k <= 128 else "panel")
    assert tk.empty_scratch("llk", 4, 128, like) is None
    assert tk.empty_scratch("fullt", 4, 256, like) is None
    s = tk.empty_scratch("states", 4, 256, like)
    assert s.shape == (4, 257, 256) and s.dtype == torch.float32
    with pytest.raises(ValueError, match="want"):
        tk.scratch_shape("chol", 4, 256)
