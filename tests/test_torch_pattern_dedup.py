"""The port's pattern path (ppca_rs_tpu_torch: Dataset.pattern_info and
pattern_order, ops/pattern_dedup, the model's routing) against the JAX
package's, both in float64 on the CPU.

The data draw their masks from a small pool of patterns with an all-masked
pattern, an empty dimension, an all-masked row and a zero-weight row.  The
two packages may number the patterns differently, so detection is compared
by reconstruction and by the set of patterns, and the ops are handed the
SAME (pidx, patterns) arrays.  Tolerance: 1e-9 relative (docs/DESIGN.md
section 6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu.config import config as jconfig
from ppca_rs_tpu.ops import pattern_dedup as jpd
from ppca_rs_tpu_torch import dataset as tdataset
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import pattern_dedup as tpd

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

RTOL = 1e-9
BLOCK = 32


def make_patterned(rng, n=150, d=12, n_patterns=6, empty_dim=True):
    """(data zero-filled where masked, mask, weights) with masks from a
    pool of patterns."""
    pats = rng.random((n_patterns, d)) < 0.6
    if empty_dim:
        pats[:, 3] = False                 # dimension 3 never observed
    pats[0] = False                        # an all-masked pattern
    pats[1] = True
    pats[1, 3] = not empty_dim
    mask = pats[rng.integers(0, n_patterns, size=n)]
    mask[7] = False                        # an all-masked row
    data = np.where(mask, rng.normal(size=(n, d)) * 2.0 + 1.0, 0.0)
    weights = rng.random(n) + 0.25
    weights[11] = 0.0                      # a zero-weight row
    return data, mask, weights


def params(rng, d, k):
    return rng.normal(size=(d, k)), rng.normal(size=d), 0.45


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def as_torch(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def shared_patterns(mask):
    """The port's detection, also as the int32/bool arrays the JAX ops take."""
    pidx, pats = interop.dataset_from_arrays(np.zeros(mask.shape), mask).pattern_info()
    return pidx, pats, jnp.asarray(pidx.numpy().astype(np.int32)), jnp.asarray(pats.numpy())


@pytest.fixture
def no_slab(monkeypatch):
    """The JAX pattern em_stats then returns S whole, not its slab wedge."""
    monkeypatch.setattr(jconfig, "s_slab_stats", False)


# --------------------------------------------------------------------- #
# detection


def test_pattern_info_reconstructs_mask(rng):
    data, mask, weights = make_patterned(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    info = tds.pattern_info()
    assert info is not None
    pidx, pats = info
    assert pidx.dtype == torch.int64 and pats.dtype == torch.bool
    np.testing.assert_array_equal(pats.numpy()[pidx.numpy()], mask)
    jpidx, jpats = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask)).pattern_info()
    assert {r.tobytes() for r in pats.numpy()} == {r.tobytes() for r in np.asarray(jpats)}
    assert pats.shape == jpats.shape
    # cached; with_weights and to share the cache, slice does not
    assert tds.pattern_info() is info
    assert tds.with_weights(np.ones(len(tds))).pattern_info() is info
    moved = tds.to("cpu").pattern_info()
    assert all(torch.equal(a, b) for a, b in zip(moved, info))
    assert tds.slice(0, 100)._patterns is None


@pytest.mark.parametrize("d", [5, 64, 130])
def test_pack_mask_round_trips(rng, monkeypatch, d):
    """Packing is exact at widths below, at and above a 64-bit word, with
    bit 63 set, across packing chunks."""
    monkeypatch.setattr(tdataset, "_PACK_ROWS", 7)
    mask = torch.from_numpy(rng.random((40, d)) < 0.5)
    mask[3] = True
    words = tdataset._pack_mask(mask)
    assert words.shape == (40, -(-d // 64)) and words.dtype == torch.int64
    torch.testing.assert_close(tdataset._unpack_mask(words, d), mask)
    other = mask.clone()
    other[5, d - 1] = ~other[5, d - 1]
    assert not torch.equal(tdataset._pack_mask(other)[5], words[5])


@pytest.mark.parametrize("case", ["random", "short", "dense", "switch", "cap", "prefix"])
def test_pattern_info_gates(rng, monkeypatch, case):
    data, mask, weights = make_patterned(rng, n=200)
    if case == "random":          # every row its own pattern: not profitable
        mask = rng.random(mask.shape) < 0.5
    elif case == "short":         # N < 2 * pattern_min_ratio
        data, mask, weights = data[:7], mask[:7], weights[:7]
    elif case == "dense":         # the dense path owns fully observed data
        mask = np.ones_like(mask)
    elif case == "cap":           # P above config.pattern_max
        monkeypatch.setattr(tconfig, "pattern_max", 3)
    elif case == "prefix":        # random masks demote on the prefix alone
        monkeypatch.setattr(tdataset, "_PREFIX_CHECK_ROWS", 64)
        monkeypatch.setattr(tconfig, "pattern_max", 20)
        mask = rng.random(mask.shape) < 0.5
        calls = []
        orig = tdataset._pack_mask
        monkeypatch.setattr(tdataset, "_pack_mask", lambda m: (calls.append(len(m)), orig(m))[1])
    tds = interop.dataset_from_arrays(np.where(mask, data, 0.0), mask, weights)
    if case == "switch":
        monkeypatch.setattr(tconfig, "use_pattern_dedup", False)
        assert tds.pattern_info() is None and tds.pattern_order() is None
        monkeypatch.setattr(tconfig, "use_pattern_dedup", True)
        assert tds.pattern_info() is not None       # not poisoned by the off probe
        monkeypatch.setattr(tconfig, "use_pattern_dedup", False)
        assert tds.pattern_info() is None           # read on every call
        return
    assert tds.pattern_info() is None
    assert tds.pattern_order() is None
    if case == "prefix":
        assert calls == [32]


def test_prefix_check_passes_structured_data(rng, monkeypatch):
    monkeypatch.setattr(tdataset, "_PREFIX_CHECK_ROWS", 64)
    data, mask, weights = make_patterned(rng, n=300)
    pidx, pats = interop.dataset_from_arrays(data, mask, weights).pattern_info()
    np.testing.assert_array_equal(pats.numpy()[pidx.numpy()], mask)


def test_pattern_order(rng, monkeypatch):
    data, mask, weights = make_patterned(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    assert tds.pattern_order() is None       # 150 rows < 6 segments x 8192
    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 25)
    tds = interop.dataset_from_arrays(data, mask, weights)
    data_sorted, perm, counts = order = tds.pattern_order()
    pidx, pats = tds.pattern_info()
    assert len(counts) == pats.shape[0] and sum(counts) == len(tds)
    torch.testing.assert_close(data_sorted, tds.data[perm])
    assert bool((pidx[perm][1:] >= pidx[perm][:-1]).all())
    np.testing.assert_array_equal(np.bincount(pidx.numpy(), minlength=len(counts)), counts)
    assert tds.pattern_order() is order
    assert tds.with_weights(np.ones(len(tds))).pattern_order() is order
    monkeypatch.setattr(tconfig, "pat_sorted_max_bytes", 8)
    small = interop.dataset_from_arrays(data, mask, weights)
    assert small.pattern_order() is None and small.pattern_info() is not None


# --------------------------------------------------------------------- #
# ops against the JAX package, same (pidx, patterns)


@pytest.mark.parametrize("k", [1, 4])
def test_compute_tables(rng, k):
    _, mask, _ = make_patterned(rng)
    C, _, sigma = params(rng, mask.shape[1], k)
    _, pats, _, jpats = shared_patterns(mask)
    got = tpd.compute_tables(torch.from_numpy(C), torch.tensor(sigma, dtype=torch.float64),
                             pats.double())
    want = jpd.compute_tables(jnp.asarray(C), jnp.float64(sigma), jpats.astype(jnp.float64))
    for name in tpd.PatternTables._fields:
        close(getattr(got, name), getattr(want, name))
    # the all-masked pattern is neutral: Sigma = I, no llk term, no trace
    empty = int(np.flatnonzero(~pats.numpy().any(1))[0])
    close(got.Sigma[empty].reshape(k, k), np.eye(k))
    assert abs(float(got.pat_llk[empty])) < 1e-12 and abs(float(got.sq[empty])) < 1e-12


# P > k gathers each row's Sigma_p; P <= k takes the all-patterns matmul
FORMS = {"gather": dict(n_patterns=6, k=3), "candidates": dict(n_patterns=3, k=4)}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("verb", ["llks", "states", "infer"])
def test_verbs_match_jax(rng, verb, form):
    data, mask, _ = make_patterned(rng, n_patterns=FORMS[form]["n_patterns"])
    C, mean, sigma = params(rng, mask.shape[1], FORMS[form]["k"])
    pidx, pats, jpidx, jpats = shared_patterns(mask)
    got = getattr(tpd, verb)(*as_torch(C, mean, sigma, data, mask), pidx, pats, block_size=BLOCK)
    want = getattr(jpd, verb)(jnp.asarray(C), jnp.asarray(mean), jnp.float64(sigma),
                              jnp.asarray(data), jnp.asarray(mask), jpidx, jpats,
                              block_size=BLOCK)
    for g, w in zip(got if verb == "infer" else [got], want if verb == "infer" else [want]):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


@pytest.mark.parametrize("sorted_,form", [(False, "gather"), (False, "candidates"),
                                          (True, "gather")],
                         ids=["grouped", "grouped-candidates", "sorted"])
def test_em_stats_match_jax(rng, no_slab, sorted_, form):
    data, mask, weights = make_patterned(rng, n=333, d=16, n_patterns=FORMS[form]["n_patterns"])
    C, mean, sigma = params(rng, 16, FORMS[form]["k"])
    pidx, pats, jpidx, jpats = shared_patterns(mask)
    jx = [jnp.asarray(C), jnp.asarray(mean), jnp.float64(sigma)]
    want = jpd.em_stats(*jx, jnp.asarray(data), jnp.asarray(mask), jpidx, jpats,
                        jnp.asarray(weights), block_size=64)
    t = as_torch(C, mean, sigma, data, mask, weights)
    if sorted_:
        # whatever the buffer holds at masked entries must be inert
        poisoned = np.where(mask, data, 123.456)
        perm = torch.argsort(pidx, stable=True)
        counts = tuple(np.bincount(pidx.numpy(), minlength=pats.shape[0]).tolist())
        got = tpd.em_stats_sorted(*t[:3], torch.from_numpy(poisoned)[perm], t[5][perm], pats,
                                  counts, block_size=64)
    else:
        got = tpd.em_stats(*t[:5], pidx, pats, t[5], block_size=64)
    for name in got._fields:
        close(getattr(got, name), getattr(want, name))


def test_em_stats_sorted_checks_counts(rng):
    data, mask, weights = make_patterned(rng)
    C, mean, sigma = params(rng, mask.shape[1], 2)
    _, pats, _, _ = shared_patterns(mask)
    with pytest.raises(ValueError, match="partition"):
        tpd.em_stats_sorted(*as_torch(C, mean, sigma, data, weights), pats, (1, 2),
                            block_size=BLOCK)


# --------------------------------------------------------------------- #
# the model's routing and training


def spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: (calls.append(name), orig(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "grouped"])
def test_routing_and_training_match_jax(rng, monkeypatch, sorted_):
    """Five trainer iterations in both packages from the same start: the
    port goes through the sorted (or, with the sorted copy gated out, the
    grouped) pattern EM and never through the masked path."""
    data, mask, weights = make_patterned(rng, n=240, d=10)
    C0, mu0, s0 = params(rng, 10, 3)
    if sorted_:
        monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    used = spy(monkeypatch, tpd, "em_stats_sorted" if sorted_ else "em_stats")
    masked = spy(monkeypatch, tp.models.ppca.ml, "em_stats")
    tds = interop.dataset_from_arrays(data, mask, weights)
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(weights))
    t_hist, j_hist = [], []
    tm = tp.PPCATrainer(tds).train(start=interop.model_from_arrays(C0, mu0, s0), state_size=3,
                                   n_iters=5, quiet=True, callback=lambda i, m: t_hist.append(m))
    jm = jp.PPCATrainer(jds).train(start=jp.PPCAModel(isotropic_noise=s0, transform=C0, mean=mu0),
                                   state_size=3, n_iters=5, quiet=True,
                                   callback=lambda i, m: j_hist.append(m))
    assert len(used) == 5 and not masked
    for tmet, jmet in zip(t_hist, j_hist):
        for f in ("llk", "aic", "bic"):
            assert getattr(tmet, f) == pytest.approx(getattr(jmet, f), rel=RTOL)
    close(tm.transform, jm.transform)
    close(tm.mean, jm.mean)
    assert float(tm.isotropic_noise) == pytest.approx(jm.isotropic_noise, rel=RTOL)
    close(tm.llks(tds), jm.llks(jds))
    ti, ji = tm.infer(tds), jm.infer(jds)
    close(ti.states(), ji.states())
    close(ti.covariances_array(), ji.covariances_array())
    close(tm.extrapolate(tds).numpy(), jm.extrapolate(jds).numpy())


def test_pattern_path_equals_masked_path(rng, monkeypatch):
    data, mask, weights = make_patterned(rng, n=200, d=9)
    C0, mu0, s0 = params(rng, 9, 3)
    model = interop.model_from_arrays(C0, mu0, s0)
    prior = (tp.Prior().with_isotropic_noise_prior(2.0, 2.0).with_transformation_precision(0.2)
             .with_mean_prior(np.zeros(9), 0.5 * np.eye(9)))
    tds = interop.dataset_from_arrays(data, mask, weights)
    tk.reset_launch_counts()

    def readouts(ds):
        new, llk = model._em_step(ds, prior)
        return [model.llks(ds), model.extrapolate(ds).data, model.smooth(ds).data,
                model.infer(ds).covariances_array(), new.transform, new.mean,
                new.isotropic_noise, llk]

    pattern = readouts(tds)
    monkeypatch.setattr(tconfig, "use_pattern_dedup", False)
    masked = readouts(tds)
    for got, want in zip(pattern, masked):
        close(got, want.numpy())
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}
