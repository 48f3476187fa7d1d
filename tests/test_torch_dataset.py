"""The port's Dataset surface for out-of-core and low-precision work
(``chunks``, ``DatasetChunks``, ``concat``, ``astype``) against the JAX
package's, float64 on the CPU unless stated; tolerance 1e-9 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes

torch.set_num_threads(1)

TOL = 1e-9
ROUTES = ("dense", "pattern", "masked")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def make_data(rng, route="masked", N=48, D=6):
    """A NaN-holed (N, D) array that takes ``route``."""
    data = rng.normal(size=(N, D)) + rng.normal(size=D)
    if route == "pattern":
        patterns = rng.random((3, D)) > 0.4
        mask = patterns[rng.integers(0, 3, size=N)]
        mask[:3] = patterns
    elif route == "masked":
        mask = rng.random((N, D)) > 0.3
    else:
        mask = np.ones((N, D), dtype=bool)
    return np.where(mask, data, np.nan)


@pytest.mark.parametrize("n, chunks", [(10, 4), (10, 1), (10, 10), (10, 25), (9, 3), (10, 0)])
def test_chunks_stride_and_last_chunk(rng, n, chunks):
    """Stride ceil(len / chunks), the last chunk shorter, as the JAX
    package slices them."""
    data = make_data(rng, N=n)
    jparts = list(jp.Dataset(data).chunks(chunks))
    tparts = list(tp.Dataset(data, dtype=torch.float64).chunks(chunks))
    assert [len(p) for p in tparts] == [len(p) for p in jparts]
    stride = -(-n // chunks) if chunks > 0 else n
    assert [len(p) for p in tparts] == [min(stride, n - lo) for lo in range(0, n, stride)]
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert isinstance(tp.Dataset(data).chunks(2), tp.DatasetChunks)


def test_concat_matches_jax_and_refuses_mixed_devices(rng):
    data, w = make_data(rng), rng.random(48) + 0.5
    tds = tp.Dataset(data, weights=w, dtype=torch.float64)
    parts = list(tds.chunks(3))
    joined = tp.Dataset.concat(parts)
    jjoined = jp.Dataset.concat(list(jp.Dataset(data, weights=w).chunks(3)))
    np.testing.assert_array_equal(joined.numpy(), jjoined.numpy())
    np.testing.assert_array_equal(joined.weights(), np.asarray(jjoined.weights()))
    assert joined.device.type == "cpu"
    with pytest.raises(ValueError, match="different devices"):
        tp.Dataset.concat([parts[0], parts[1].to("meta")])
    with pytest.raises(ValueError, match="empty"):
        tp.Dataset.concat([])


@pytest.mark.parametrize("route", ROUTES)
def test_astype_bfloat16_matches_jax(rng, route):
    """astype(bfloat16) stores the values bit-equal to the JAX package's
    astype(jnp.bfloat16), keeps the mask and takes the weights as the JAX
    package does; one EM step of a float64 model on it matches the JAX
    package's."""
    data, w = make_data(rng, route), rng.random(48) + 0.5
    jds = jp.Dataset(data, weights=w).astype(jnp.bfloat16)
    base = tp.Dataset(data, weights=w, dtype=torch.float64)
    tds = base.astype(torch.bfloat16)
    assert tds.dtype == torch.bfloat16 and routes.route(tds).kind == route
    assert tds.mask.data_ptr() == base.mask.data_ptr()
    stored = tds.data.float().numpy()
    np.testing.assert_array_equal(stored, np.asarray(jds.data.astype(jnp.float32)))
    np.testing.assert_array_equal(tds.weights(), np.asarray(jds.weights()))
    assert tds.weights_dev.dtype == torch.float32

    C, mean = rng.normal(size=(6, 2)), rng.normal(size=6)
    jm, jllk = jp.PPCAModel(isotropic_noise=0.7, transform=C, mean=mean)._iterate_with_llk(jds, None)
    tm, tllk = interop.model_from_arrays(C, mean, 0.7)._iterate_with_llk(tds, None)
    assert tm.transform.dtype == torch.float64
    assert tllk == pytest.approx(jllk, rel=TOL)
    np.testing.assert_allclose(tm.transform.numpy(), np.asarray(jm.transform), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), rtol=TOL, atol=TOL)
    assert float(tm.isotropic_noise) == pytest.approx(float(jm.isotropic_noise), rel=TOL)


def test_astype_float32_model_on_bfloat16_storage(rng):
    """A float32 model trains on bfloat16 storage in float32: every product
    runs in the compute dtype, never in bfloat16, and the llk stays close
    to the float32 storage's."""
    data = make_data(rng, N=200)
    f32 = tp.Dataset(data)
    bf16 = f32.astype(torch.bfloat16)
    model = tp.PPCAModel.init(2, f32, generator=torch.Generator().manual_seed(0))
    a, llk_a = model._em_step(f32, None)
    b, llk_b = model._em_step(bf16, None)
    assert b.transform.dtype == torch.float32 and llk_b.dtype == torch.float32
    assert abs(float(llk_b) - float(llk_a)) <= 1e-2 * abs(float(llk_a))


def test_shared_pattern_caches(rng, monkeypatch):
    """astype, with_weights and to share the caches that depend on the mask
    alone; astype drops the sorted copy of the old values."""
    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 1)
    tds = tp.Dataset(make_data(rng, "pattern", N=64), dtype=torch.float64)
    info = tds.pattern_info()
    assert info is not None and tds.pattern_order() is not None
    bf16 = tds.astype(torch.bfloat16)
    assert bf16._patterns is tds._patterns and bf16._all_observed is tds._all_observed
    assert bf16._pattern_order is None
    assert tds.with_weights(np.ones(64))._patterns is tds._patterns
    moved = tds.to("cpu")
    assert all(torch.equal(a, b) for a, b in zip(moved._patterns, info))
    dense = tp.Dataset(make_data(rng, "dense"), dtype=torch.float64)
    assert dense.all_observed() and dense.astype(torch.bfloat16)._all_observed is True
