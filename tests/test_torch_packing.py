"""The port's native host packer (ppca_rs_tpu_torch.native.packing) against
its numpy plain version and the JAX package's packer, bit for bit, and the
callers that pack through it: ``Dataset()`` and the pandas adapter.

The library is built by g++ on first use, here as on the card's host.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu.native import packing as jpacking
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.native import packing

#: Elements a thread of the C++ pass gets at least (``kGrain``).
GRAIN = 1 << 16
BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def holes(shape, seed=0):
    """float64 values with NaN, +inf, -inf, -0.0, subnormals, values past
    the float32 range and ordinary values."""
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -2.2e-308, 1e-40, 3.5e38,
                         -1e300, np.finfo(np.float64).max])
    flat = arr.reshape(-1)
    if flat.size:
        at = rng.random(flat.size) < 0.3
        flat[at] = rng.choice(specials, size=int(at.sum()))
    return arr


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.view(BITS[a.dtype]), b.view(BITS[b.dtype])))


SHAPES = {"empty": (0, 5), "no_columns": (4, 0), "one_column": (37, 1), "small": (13, 7),
          "above_the_grain": (3 * GRAIN // 64 + 5, 64)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mask_non_finite_matches_the_plain_version(shape, dtype):
    """Values in the storage dtype and the mask, bit for bit: NaN and +-inf
    masked and zeroed, -0.0 and subnormals kept (float32 rounds them as
    numpy's cast does), across several threads above the grain."""
    arr = holes(SHAPES[shape])
    values, mask = packing.mask_non_finite(arr, dtype)
    want_values, want_mask = packing.mask_non_finite_reference(arr, dtype)
    assert values.device.type == "cpu" and mask.dtype == torch.bool
    assert bitwise_equal(values, want_values)
    assert bitwise_equal(mask, want_mask)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mask_non_finite_matches_jax(shape):
    """The float64 pass against the JAX package's packer, bit for bit."""
    arr = holes(SHAPES[shape], seed=1)
    values, mask = packing.mask_non_finite(arr, torch.float64)
    jvalues, jmask = jpacking.mask_non_finite(arr)
    assert bitwise_equal(values, torch.as_tensor(jvalues))
    assert bitwise_equal(mask, torch.as_tensor(jmask))


def test_mask_non_finite_reads_any_layout():
    """A non-contiguous or float32 input is made a float64 array first."""
    arr = holes((40, 30), seed=2)
    for view in (arr.T, arr[::2], np.clip(arr, -1e30, 1e30).astype(np.float32)):
        values, mask = packing.mask_non_finite(view, torch.float32)
        want_values, want_mask = packing.mask_non_finite_reference(view, torch.float32)
        assert bitwise_equal(values, want_values) and bitwise_equal(mask, want_mask)


@pytest.mark.parametrize("n", [0, 1, 1000, 2 * GRAIN + 3])
def test_scatter_long_to_dense(n):
    """Sequential and last-wins on duplicate (sample, dim) pairs, as numpy
    fancy assignment; the JAX package's packer gives the same array."""
    rng = np.random.default_rng(n)
    n_samples, n_dims = 97, 31
    s = rng.integers(0, n_samples, size=n)
    d = rng.integers(0, n_dims, size=n)
    v = rng.normal(size=n)
    if n > 1:
        s[-1], d[-1] = s[0], d[0]             # a duplicate pair: the last wins
    got = packing.scatter_long_to_dense(s, d, v, n_samples, n_dims)
    want = packing.scatter_long_to_dense_reference(s, d, v, n_samples, n_dims)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jpacking.scatter_long_to_dense(s, d, v, n_samples, n_dims))
    if n > 1:
        assert got[s[0], d[0]] == v[-1]


def test_scatter_refuses_indices_out_of_range():
    with pytest.raises(IndexError, match="sample index"):
        packing.scatter_long_to_dense([0, 5], [0, 0], [1.0, 2.0], 5, 2)
    with pytest.raises(IndexError, match="dim index"):
        packing.scatter_long_to_dense([0, 1], [0, -1], [1.0, 2.0], 5, 2)
    with pytest.raises(ValueError, match="lengths differ"):
        packing.scatter_long_to_dense([0, 1], [0], [1.0, 2.0], 5, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_dataset_packs_as_before(dtype):
    """``Dataset()`` holds what the numpy plain version gives (the values in
    the storage dtype, the mask), and the weights as before."""
    arr = holes((300, 9), seed=3)
    w = np.random.default_rng(4).random(300)
    ds = tp.Dataset(arr, weights=w, dtype=dtype)
    want_values, want_mask = packing.mask_non_finite_reference(arr, dtype)
    assert bitwise_equal(ds.data, want_values) and bitwise_equal(ds.mask, want_mask)
    assert torch.equal(ds.weights_dev, torch.as_tensor(w, dtype=dtype))
    np.testing.assert_array_equal(ds.numpy(), np.where(want_mask.numpy(),
                                                       want_values.double().numpy(), np.nan))


def test_pandas_adapter_packs_as_before():
    """The pandas adapter's dataset equals the one from numpy fancy
    assignment and ``Dataset()`` of its array."""
    rng = np.random.default_rng(5)
    n_samples, n_dims = 50, 6
    keep = rng.random(n_samples * n_dims) < 0.7
    df = pd.DataFrame({"s": np.repeat(np.arange(n_samples), n_dims)[keep],
                       "d": np.tile(np.arange(n_dims), n_samples)[keep],
                       "v": rng.normal(size=n_samples * n_dims)[keep]})
    df = df.sample(frac=1.0, random_state=6)
    adapter = tp.DataFrameAdapter.from_pandas(df, keys=["s"], dimensions=["d"], metric="v")
    dense = packing.scatter_long_to_dense_reference(df["s"].to_numpy(), df["d"].to_numpy(),
                                                    df["v"].to_numpy(), n_samples, n_dims)
    want_values, want_mask = packing.mask_non_finite_reference(dense, tconfig.dtype)
    assert bitwise_equal(adapter.dataset.data, want_values)
    assert bitwise_equal(adapter.dataset.mask, want_mask)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile, or does not exist, raises with the
    compiler's messages; ``Dataset()`` does not fall back to numpy."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        packing.build(bad)
    with pytest.raises(FileNotFoundError):
        packing.build(tmp_path / "missing.cpp")
    monkeypatch.setattr(packing, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(packing, "_lib", None)
    with pytest.raises(FileNotFoundError):
        tp.Dataset(np.ones((3, 2)))
