"""Long-format DataFrame <-> Dataset adapters — port of
``ppca_rs_tpu/adapters.py`` (the reference's `python/ppca_rs/__init__.py:
121-433`).

A long frame with key columns, dimension columns and one metric column
becomes a dense NaN-filled ``(n_samples, n_dims)`` array, then a
:class:`Dataset` on ``config.device``, with reproducible dimension and
sample index tables and the inverse conversion back to a long frame.
pandas and polars are both supported, each imported only when used.  Keys
and dimensions are factorized to integer codes and every value is
scattered at once by the native packer
(``native/packing.scatter_long_to_dense``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Literal, Optional

import numpy as np

from .dataset import Dataset
from .native.packing import scatter_long_to_dense


def _dims_from_index(dimensions: Optional[List[str]], columns) -> List[str]:
    if dimensions is not None:
        return dimensions
    return [c for c in columns if c != "__dim_idx"]


@dataclass
class DataFrameAdapter:
    """Maps a long-format DataFrame into a Dataset
    (`python/ppca_rs/__init__.py:121-354`)."""

    keys: List[str]
    dimensions: List[str]
    metric: str
    dimension_idx: Any    # frame with the dimension columns + "__dim_idx"
    sample_idx: Any       # frame with the key columns + "__sample_idx"
    dataset: Dataset
    origin: Literal["pandas", "polars"]

    @classmethod
    def from_pandas(cls, df, *, keys: List[str], dimensions: Optional[List[str]] = None,
                    dimension_idx=None, metric: str) -> "DataFrameAdapter":
        import pandas as pd

        if dimension_idx is None:
            if dimensions is None:
                raise ValueError("either dimensions or dimension_idx must be given")
            dimension_idx = (df[dimensions].drop_duplicates().sort_values(dimensions)
                             .reset_index(drop=True))
            dimension_idx.index.name = "__dim_idx"
            dimension_idx = dimension_idx.reset_index()
        else:
            dimensions = _dims_from_index(dimensions, dimension_idx.columns)

        merged = df.merge(dimension_idx, on=dimensions)
        # sample codes in the sorted order of the key tuples, the order of
        # the reference's groupby(keys)
        codes, uniques = pd.factorize(pd.MultiIndex.from_frame(merged[keys]), sort=True)
        n_samples = len(uniques)
        dense = scatter_long_to_dense(codes, merged["__dim_idx"].to_numpy(dtype=np.int64),
                                      merged[metric].to_numpy(dtype=np.float64), n_samples,
                                      len(dimension_idx))
        sample_idx = pd.DataFrame(uniques.to_frame(index=False))
        sample_idx.columns = list(keys)
        sample_idx["__sample_idx"] = np.arange(n_samples, dtype=np.uint32)
        return cls(keys=list(keys), dimensions=list(dimensions), metric=metric,
                   dimension_idx=dimension_idx, sample_idx=sample_idx, dataset=Dataset(dense),
                   origin="pandas")

    @classmethod
    def from_polars(cls, df, *, keys: List[str], dimensions: Optional[List[str]] = None,
                    dimension_idx=None, metric: str) -> "DataFrameAdapter":
        if dimension_idx is None:
            if dimensions is None:
                raise ValueError("either dimensions or dimension_idx must be given")
            dimension_idx = (df.lazy().select(dimensions).unique(maintain_order=False)
                             .sort(dimensions).with_row_index("__dim_idx").collect())
        else:
            dimensions = _dims_from_index(dimensions, dimension_idx.columns)

        merged = df.lazy().join(dimension_idx.lazy(), on=dimensions).collect()
        sample_idx = (merged.lazy().select(keys).unique(maintain_order=False).sort(keys)
                      .with_row_index("__sample_idx").collect())
        merged = merged.join(sample_idx, on=keys)
        n_samples = len(sample_idx)
        dense = scatter_long_to_dense(merged["__sample_idx"].to_numpy(),
                                      merged["__dim_idx"].to_numpy(),
                                      merged[metric].to_numpy(), n_samples, len(dimension_idx))
        return cls(keys=list(keys), dimensions=list(dimensions), metric=metric,
                   dimension_idx=dimension_idx,
                   sample_idx=sample_idx.select([*keys, "__sample_idx"]),
                   dataset=Dataset(dense), origin="polars")

    def description(self) -> "DataFrameAdapterDescription":
        """Serializable spec of this adapter
        (`python/ppca_rs/__init__.py:272-296`)."""
        if self.origin == "pandas":
            ordered = self.dimension_idx.sort_values("__dim_idx")
            cols = [ordered[c].to_numpy().tolist() for c in self.dimensions]
        elif self.origin == "polars":
            ordered = self.dimension_idx.sort("__dim_idx")
            cols = [list(ordered[c]) for c in self.dimensions]
        else:
            raise ValueError(f"Unknown origin {self.origin}")
        return DataFrameAdapterDescription(keys=list(self.keys), dimensions=list(self.dimensions),
                                           metric=self.metric,
                                           dimension_idx=[list(t) for t in zip(*cols)])

    def convert_dataset(self, dataset: Dataset, *, column_name: str):
        return self.convert_datasets({column_name: dataset})

    def convert_datasets(self, datasets: Dict[str, Dataset]):
        """Back to a long frame: one row per (sample, dimension) pair, one
        value column per dataset (`python/ppca_rs/__init__.py:301-354`)."""
        data = {name: ds.numpy().reshape(-1) for name, ds in datasets.items()}
        n_samples, n_dims = len(self.sample_idx), len(self.dimension_idx)
        index = {"__sample_idx": np.repeat(np.arange(n_samples, dtype="uint32"), n_dims),
                 "__dim_idx": np.tile(np.arange(n_dims, dtype="uint32"), n_samples)}
        if self.origin == "pandas":
            import pandas as pd

            frame = pd.DataFrame({**data, **index})
            return (frame.merge(self.dimension_idx, on="__dim_idx")
                    .merge(self.sample_idx, on="__sample_idx")
                    [[*self.keys, *self.dimensions, *datasets.keys()]])
        if self.origin == "polars":
            import polars as pl

            frame = pl.DataFrame({**data, **index})
            return (frame.join(self.dimension_idx, on="__dim_idx")
                    .join(self.sample_idx, on="__sample_idx")
                    .select([*self.keys, *self.dimensions, *data.keys()]))
        raise ValueError(f"Unknown origin {self.origin}")


@dataclass
class DataFrameAdapterDescription:
    """Data-free, JSON-serializable adapter spec that re-adapts new frames
    with a stored dimension indexing (`python/ppca_rs/__init__.py:357-433`)."""

    keys: List[str]
    dimensions: List[str]
    metric: str
    dimension_idx: List[List]

    def _index_columns(self) -> dict:
        cols = {"__dim_idx": np.arange(len(self.dimension_idx), dtype="uint32")}
        for i, dim in enumerate(self.dimensions):
            cols[dim] = [row[i] for row in self.dimension_idx]
        return cols

    @property
    def dimension_idx_pandas(self) -> Any:
        import pandas as pd

        return pd.DataFrame(self._index_columns())

    @property
    def dimension_idx_polars(self) -> Any:
        import polars as pl

        return pl.DataFrame(self._index_columns())

    @classmethod
    def from_json(cls, value: dict) -> "DataFrameAdapterDescription":
        return cls(**value)

    def to_json(self) -> dict:
        return {"keys": self.keys, "dimensions": self.dimensions, "metric": self.metric,
                "dimension_idx": self.dimension_idx}

    def adapt_pandas(self, df) -> DataFrameAdapter:
        return DataFrameAdapter.from_pandas(df, keys=self.keys,
                                            dimension_idx=self.dimension_idx_pandas,
                                            metric=self.metric)

    def adapt_polars(self, df) -> DataFrameAdapter:
        return DataFrameAdapter.from_polars(df, keys=self.keys,
                                            dimension_idx=self.dimension_idx_polars,
                                            metric=self.metric)
