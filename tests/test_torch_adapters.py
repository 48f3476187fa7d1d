"""The port's DataFrame adapters against the JAX package's (mirrors
tests/test_adapters.py): from one long frame both give the same dense
array, the same ``description().to_json()`` and the same long frame back.
polars runs through tests/fake_polars.py where it is not installed."""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)

SPEC = dict(keys=["user"], dimensions=["city", "month"], metric="price")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card, in float32, by default; these tests ask
    for the CPU and float64, the JAX package's dtype here."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    monkeypatch.setattr(tconfig, "dtype", torch.float64)


def long_frame():
    rows = []
    for user in ["a", "b", "c"]:
        for city, month in [("nyc", 1), ("nyc", 2), ("par", 1), ("par", 2)]:
            if user == "b" and city == "par":
                continue  # missing entries for user b
            rows.append({"user": user, "city": city, "month": month,
                         "price": {"a": 1.0, "b": 2.0, "c": 3.0}[user] + month * 0.1})
    return pd.DataFrame(rows)


def test_from_pandas_matches_jax():
    df = long_frame()
    adapter = tp.DataFrameAdapter.from_pandas(df, **SPEC)
    ref = jp.DataFrameAdapter.from_pandas(df, **SPEC)
    arr = adapter.dataset.numpy()
    assert adapter.dataset.device.type == "cpu" and len(adapter.dataset) == 3
    np.testing.assert_array_equal(arr, ref.dataset.numpy())
    # dimension order is sorted (city, month): (nyc,1),(nyc,2),(par,1),(par,2)
    np.testing.assert_array_equal(arr[0], [1.1, 1.2, 1.1, 1.2])
    assert np.isnan(arr[1, 2:]).all()
    pd.testing.assert_frame_equal(adapter.sample_idx, ref.sample_idx)
    pd.testing.assert_frame_equal(adapter.dimension_idx, ref.dimension_idx)


def test_convert_dataset_back_matches_jax():
    df = long_frame()
    adapter = tp.DataFrameAdapter.from_pandas(df, **SPEC)
    ref = jp.DataFrameAdapter.from_pandas(df, **SPEC)
    out = adapter.convert_dataset(adapter.dataset, column_name="price")
    assert set(out.columns) == {"user", "city", "month", "price"}
    assert len(out) == 12  # 3 users x 4 dims, NaN rows included
    want = ref.convert_dataset(ref.dataset, column_name="price")
    pd.testing.assert_frame_equal(out.reset_index(drop=True), want.reset_index(drop=True))
    merged = out.merge(df, on=["user", "city", "month"], suffixes=("_out", "_in"))
    np.testing.assert_array_equal(merged["price_out"], merged["price_in"])


def test_description_and_readapt_match_jax():
    df = long_frame()
    adapter = tp.DataFrameAdapter.from_pandas(df, **SPEC)
    js = adapter.description().to_json()
    assert js == jp.DataFrameAdapter.from_pandas(df, **SPEC).description().to_json()
    desc = tp.DataFrameAdapterDescription.from_json(js)
    assert desc.dimensions == ["city", "month"] and len(desc.dimension_idx) == 4
    # re-adapting with the stored indexing keeps the dimension order
    again = desc.adapt_pandas(df)
    np.testing.assert_array_equal(again.dataset.numpy(), adapter.dataset.numpy())


def test_train_through_adapter():
    df = long_frame()
    adapter = tp.DataFrameAdapter.from_pandas(df, **SPEC)
    model = tp.PPCATrainer(adapter.dataset).train(state_size=1, n_iters=3, quiet=True,
                                                  generator=torch.Generator().manual_seed(0))
    out = adapter.convert_dataset(model.extrapolate(adapter.dataset), column_name="price_filled")
    assert not out["price_filled"].isna().any()


def _polars_or_shim():
    """Real polars when installed, else the pandas-backed shim of exactly
    the surface the adapters touch (tests/fake_polars.py)."""
    try:
        import polars as pl  # pragma: no cover - not installed here
        return pl, False
    except ImportError:
        import fake_polars

        sys.modules["polars"] = fake_polars
        return fake_polars, True


def test_polars_matches_pandas_and_jax():
    pl, shimmed = _polars_or_shim()
    try:
        df = pl.DataFrame(long_frame()) if shimmed else pl.from_pandas(long_frame())
        adapter = tp.DataFrameAdapter.from_polars(df, **SPEC)
        ref = jp.DataFrameAdapter.from_polars(df, **SPEC)
        assert adapter.origin == "polars" and adapter.dataset.output_size() == 4
        np.testing.assert_array_equal(adapter.dataset.numpy(), ref.dataset.numpy())
        np.testing.assert_array_equal(
            adapter.dataset.numpy(), tp.DataFrameAdapter.from_pandas(long_frame(), **SPEC).dataset.numpy())
        assert adapter.description().to_json() == ref.description().to_json()
        assert len(adapter.convert_dataset(adapter.dataset, column_name="price")) == 12
        desc = tp.DataFrameAdapterDescription.from_json(adapter.description().to_json())
        np.testing.assert_array_equal(desc.adapt_polars(df).dataset.numpy(),
                                      adapter.dataset.numpy())
    finally:
        if shimmed:
            sys.modules.pop("polars", None)
