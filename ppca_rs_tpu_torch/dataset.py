"""Masked dataset container.

Port of the core of ``ppca_rs_tpu/dataset.py``: one dense zero-filled
``(N, D)`` value tensor, an ``(N, D)`` bool mask (True = observed) and an
``(N,)`` weight vector (default 1.0), all on one device.

``Dataset(ndarray, weights=None)`` masks non-finite entries, ``numpy()``
round-trips with NaN fill, ``dump``/``load``/pickle use the container the
JAX package uses, so a dataset dumped by either package loads in the other.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .config import config
from .utils.serialization import dump_bytes, load_bytes


class _WeightsView(np.ndarray):
    """numpy view of the dataset weights that is ALSO callable, so both
    spellings work: ``ds.weights`` and the reference's ``ds.weights()``."""

    def __call__(self) -> np.ndarray:
        return np.asarray(self)


def _as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class Dataset:
    """A dense masked dataset: values (zero-filled where masked), an
    observed-mask and per-sample weights, all tensors on one device.

    ``weights`` is a callable numpy copy; the tensor the computations use is
    ``weights_dev``."""

    __slots__ = ("data", "mask", "weights_dev", "_all_observed")

    def __init__(self, ndarray=None, weights=None, *, device=None, dtype=None):
        if ndarray is None:
            raise TypeError("Dataset() requires an (N, D) array")
        arr = np.asarray(ndarray, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError(f"expected a 2D (N, D) array, got shape {arr.shape}")
        device = torch.device(device) if device is not None else config.device
        dtype = dtype or config.dtype
        # Non-finite entries (NaN/inf) are masked out, mirroring
        # MaskedSample::mask_non_finite (ppca/src/dataset.rs:19-22).
        mask = np.isfinite(arr)
        self.data = torch.as_tensor(np.where(mask, arr, 0.0), dtype=dtype, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        if weights is not None:
            w = np.asarray(weights, dtype=np.float64).reshape(-1)
            if w.shape[0] != arr.shape[0]:
                raise ValueError("weights length must match number of samples")
            self.weights_dev = torch.as_tensor(w, dtype=dtype, device=device)
        else:
            self.weights_dev = torch.ones(arr.shape[0], dtype=dtype, device=device)
        self._all_observed = None

    # ------------------------------------------------------------------ #
    # constructors

    @classmethod
    def from_parts(cls, data, mask, weights=None) -> "Dataset":
        """Build from prepared arrays or tensors (data zero-filled at masked
        entries).  Everything is placed on the data's device."""
        data = _as_tensor(data)
        mask = _as_tensor(mask, dtype=torch.bool, device=data.device)
        if tuple(mask.shape) != tuple(data.shape):
            raise ValueError(f"mask shape {tuple(mask.shape)} != data shape {tuple(data.shape)}")
        wdtype = torch.promote_types(data.dtype, torch.float32)
        if weights is None:
            weights = torch.ones(data.shape[0], dtype=wdtype, device=data.device)
        else:
            weights = _as_tensor(weights, dtype=wdtype, device=data.device).reshape(-1)
            if weights.shape[0] != data.shape[0]:
                raise ValueError("weights length must match number of samples")
        obj = object.__new__(cls)
        obj.data, obj.mask, obj.weights_dev = data, mask, weights
        obj._all_observed = None
        return obj

    @classmethod
    def unmasked(cls, data, weights=None) -> "Dataset":
        """Fully-observed dataset (MaskedSample::unmasked, dataset.rs:29-35)."""
        data = _as_tensor(data)
        new = cls.from_parts(data, torch.ones(data.shape, dtype=torch.bool, device=data.device),
                             weights)
        new._all_observed = True
        return new

    def with_weights(self, weights) -> "Dataset":
        """Same data, new weights (`dataset.rs:169-176`; the data and mask
        tensors are shared, not copied)."""
        new = Dataset.from_parts(self.data, self.mask, weights)
        new._all_observed = self._all_observed
        return new

    def to(self, device) -> "Dataset":
        """This dataset on ``device``."""
        new = Dataset.from_parts(self.data.to(device), self.mask.to(device),
                                 self.weights_dev.to(device))
        new._all_observed = self._all_observed
        return new

    # ------------------------------------------------------------------ #
    # basic accessors

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def weights(self) -> "_WeightsView":
        """Per-sample weights as a read-only numpy copy, callable for parity
        with the reference's ``weights()`` method."""
        view = self.weights_numpy().view(_WeightsView)
        view.setflags(write=False)
        return view

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_empty(self) -> bool:
        return len(self) == 0

    def output_size(self) -> Optional[int]:
        """Number of output dimensions, or None for the empty dataset
        (`dataset.rs:183-191`)."""
        if self.is_empty():
            return None
        return int(self.data.shape[1])

    def all_observed(self) -> bool:
        """True when every entry is observed.  Cached."""
        if self._all_observed is None:
            self._all_observed = bool(self.mask.all())
        return self._all_observed

    def empty_dimensions(self) -> List[int]:
        """Dimensions masked in *every* sample (`dataset.rs:193-222`)."""
        if self.is_empty():
            return []
        observed = self.mask.any(dim=0).cpu().numpy()
        return [int(i) for i in np.nonzero(~observed)[0]]

    def numpy(self) -> np.ndarray:
        """NaN-filled (N, D) round-trip (`src/python_bindings.rs:81-92`)."""
        data = self.data.detach().cpu().to(torch.float64).numpy()
        return np.where(self.mask.cpu().numpy(), data, np.nan)

    def weights_numpy(self) -> np.ndarray:
        return self.weights_dev.detach().cpu().to(torch.float64).numpy()

    # ------------------------------------------------------------------ #
    # serialization

    def dump(self) -> bytes:
        """Stable bytes, in the JAX package's container."""
        return dump_bytes(
            "dataset",
            {
                "data": self.data.detach().cpu().to(torch.float64).numpy(),
                "mask": self.mask.cpu().numpy(),
                "weights": self.weights_numpy(),
            },
        )

    @staticmethod
    def load(data: bytes, *, device=None, dtype=None) -> "Dataset":
        arrays, _ = load_bytes(data, "dataset")
        device = torch.device(device) if device is not None else config.device
        dtype = dtype or config.dtype
        return Dataset.from_parts(
            torch.as_tensor(arrays["data"], dtype=dtype, device=device),
            arrays["mask"],
            arrays["weights"],
        )

    def __reduce__(self):
        return (Dataset.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # slicing

    def slice(self, start: int, stop: int) -> "Dataset":
        stop = min(stop, len(self))
        new = Dataset.from_parts(
            self.data[start:stop], self.mask[start:stop], self.weights_dev[start:stop]
        )
        if self._all_observed:
            new._all_observed = True
        return new

    def __repr__(self) -> str:
        return (f"Dataset(len={len(self)}, output_size={self.output_size()}, "
                f"dtype={self.dtype}, device={self.device})")
