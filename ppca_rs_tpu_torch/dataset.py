"""Masked dataset container.

Port of the core of ``ppca_rs_tpu/dataset.py``: one dense zero-filled
``(N, D)`` value tensor, an ``(N, D)`` bool mask (True = observed) and an
``(N,)`` weight vector (default 1.0), all on one device.

``Dataset(ndarray, weights=None)`` masks non-finite entries (one native
pass on the host, ``native/packing.py``), ``numpy()``
round-trips with NaN fill, ``dump``/``load``/pickle use the container the
JAX package uses, so a dataset dumped by either package loads in the other.
``pattern_info``/``pattern_order`` detect structured missingness for the
pattern path (``ops/pattern_dedup.py``), in the ``ppca.pattern_detect`` and
``ppca.pattern_order`` spans.  ``chunks``/``concat`` split and
join datasets for out-of-core work (``streaming.py``); ``astype`` stores
the values in another dtype, such as bfloat16.

A sharded dataset (``parallel.shard_dataset``/``shard_dataset_local``)
holds this rank's rows (and, on a mesh's model axis, its block of columns)
and records its mesh, the global row count and the global D (:class:`Shard`):
``len()`` and ``output_size()`` are global, and ``all_observed()`` and
``empty_dimensions()`` were decided for all ranks together when it was
built.  Its pattern table comes from the collective :meth:`detect_patterns`
alone.  ``slice``, ``chunks``, ``numpy`` and ``dump`` work on the rank's own
rows.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import config
from .native import packing
from .utils.profiling import span
from .utils.serialization import dump_bytes, load_bytes


class _WeightsView(np.ndarray):
    """numpy view of the dataset weights that is ALSO callable, so both
    spellings work: ``ds.weights`` and the reference's ``ds.weights()``."""

    def __call__(self) -> np.ndarray:
        return np.asarray(self)


def _as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor keeps its device unless ``device`` is given; a host array
    goes to ``device``, else to ``config.device``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=config.resolve_device(device))


#: Rows packed per step of pattern detection: bounds the (rows, D) int64
#: temporary of the packing to 256 MiB at D=1024.
_PACK_ROWS = 1 << 15

#: Datasets longer than this first count the distinct masks of a prefix of
#: half this many rows, so unstructured masks demote without a full pass.
_PREFIX_CHECK_ROWS = 131072


def _pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(N, D) bool -> (N, ceil(D/64)) int64: bit b of word w of a row is
    column 64 w + b (D padded with False).  Exact, so rows are equal iff
    their words are."""
    n, d = mask.shape
    words = -(-d // 64)
    shifts = torch.arange(64, dtype=torch.int64, device=mask.device)
    out = torch.empty((n, words), dtype=torch.int64, device=mask.device)
    for lo in range(0, n, _PACK_ROWS):
        part = mask[lo:lo + _PACK_ROWS]
        if words * 64 != d:
            part = torch.nn.functional.pad(part, (0, words * 64 - d))
        bits = part.reshape(-1, words, 64).to(torch.int64) << shifts
        # the bits are disjoint, so the sum is their OR (bit 63 wraps to
        # the sign, which is still exact)
        out[lo:lo + _PACK_ROWS] = bits.sum(-1)
    return out


def _unpack_mask(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`_pack_mask`: (P, W) int64 -> (P, d) bool."""
    shifts = torch.arange(64, dtype=torch.int64, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :d].bool()


def _detect_patterns(mask: torch.Tensor, p_cap: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(pidx (N,) int64, patterns (P, D) bool)`` with ``patterns[pidx] ==
    mask``, or None when there are more than ``p_cap`` distinct rows.  Runs
    on the mask's device; ``torch.unique`` over the packed rows is exact,
    so no grouping needs verifying."""
    n, d = mask.shape
    if n > _PREFIX_CHECK_ROWS:
        head = torch.unique(_pack_mask(mask[:_PREFIX_CHECK_ROWS // 2]), dim=0)
        if head.shape[0] > p_cap:
            return None
    uniq, pidx = torch.unique(_pack_mask(mask), dim=0, return_inverse=True)
    if uniq.shape[0] > p_cap:
        return None
    return pidx, _unpack_mask(uniq, d)


class Shard(NamedTuple):
    """Where a sharded dataset's tensors sit in the global one."""

    mesh: object                # torch.distributed DeviceMesh ("data", "model")
    n: int                      # rows over all ranks
    d: int                      # output dimensions over all ranks
    empty: Tuple[int, ...]      # dimensions masked in every row of every rank


class Dataset:
    """A dense masked dataset: values (zero-filled where masked), an
    observed-mask and per-sample weights, all tensors on one device.

    ``weights`` is a callable numpy copy; the tensor the computations use is
    ``weights_dev``."""

    __slots__ = ("data", "mask", "weights_dev", "_all_observed", "_patterns",
                 "_pattern_order", "_shard")

    def __init__(self, ndarray=None, weights=None, *, device=None, dtype=None):
        if ndarray is None:
            raise TypeError("Dataset() requires an (N, D) array")
        arr = np.asarray(ndarray, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError(f"expected a 2D (N, D) array, got shape {arr.shape}")
        device = config.resolve_device(device)
        dtype = dtype or config.dtype
        # Non-finite entries (NaN/inf) are masked out, mirroring
        # MaskedSample::mask_non_finite (ppca/src/dataset.rs:19-22), in one
        # native pass on the host.
        values, mask = packing.mask_non_finite(arr, dtype)
        self.data, self.mask = values.to(device), mask.to(device)
        if weights is not None:
            w = np.asarray(weights, dtype=np.float64).reshape(-1)
            if w.shape[0] != arr.shape[0]:
                raise ValueError("weights length must match number of samples")
            self.weights_dev = torch.as_tensor(w, dtype=dtype, device=device)
        else:
            self.weights_dev = torch.ones(arr.shape[0], dtype=dtype, device=device)
        self._shard = None
        self._clear_caches()

    def _clear_caches(self) -> None:
        # None: not computed yet; False: checked, the path does not apply.
        self._all_observed = None
        self._patterns = None
        self._pattern_order = None

    def _share_caches(self, new: "Dataset", device=None) -> "Dataset":
        """Give ``new``, which has this dataset's mask, the caches that
        depend on the mask alone, moved to ``device`` if given, and this
        dataset's place on its mesh."""
        def move(cached):
            if not cached or device is None:
                return cached
            return tuple(x.to(device) if isinstance(x, torch.Tensor) else x for x in cached)

        new._shard = self._shard
        new._all_observed = self._all_observed
        new._patterns = move(self._patterns)
        new._pattern_order = move(self._pattern_order)
        return new

    # ------------------------------------------------------------------ #
    # constructors

    @classmethod
    def from_parts(cls, data, mask, weights=None) -> "Dataset":
        """Build from prepared arrays or tensors (data zero-filled at masked
        entries).  Data given as a tensor keeps its device, data given as a
        host array goes to ``config.device``; the mask and weights follow
        the data."""
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
        obj._shard = None
        obj._clear_caches()
        return obj

    @classmethod
    def unmasked(cls, data, weights=None) -> "Dataset":
        """Fully-observed dataset (MaskedSample::unmasked, dataset.rs:29-35)."""
        data = _as_tensor(data)
        new = cls.from_parts(data, torch.ones(data.shape, dtype=torch.bool, device=data.device),
                             weights)
        new._all_observed = True
        return new

    def astype(self, dtype) -> "Dataset":
        """The values stored in ``dtype`` (``torch.bfloat16`` halves their
        device bytes; every computation still runs in float32 or wider).
        The mask is kept, with the caches that depend on it alone, and so
        are the weights, in the dtype ``from_parts`` gives them (float32 for
        a 16-bit storage type, as in the JAX package)."""
        new = self._share_caches(Dataset.from_parts(self.data.to(dtype), self.mask,
                                                    self.weights_dev))
        new._pattern_order = None   # holds a sorted copy of the old values
        return new

    def with_weights(self, weights) -> "Dataset":
        """Same data, new weights (`dataset.rs:169-176`; the data and mask
        tensors and the pattern caches are shared, not copied)."""
        return self._share_caches(Dataset.from_parts(self.data, self.mask, weights))

    def to(self, device) -> "Dataset":
        """This dataset on ``device``, with its pattern caches."""
        new = Dataset.from_parts(self.data.to(device), self.mask.to(device),
                                 self.weights_dev.to(device))
        return self._share_caches(new, device)

    # ------------------------------------------------------------------ #
    # basic accessors

    def __len__(self) -> int:
        """Rows: over all ranks for a sharded dataset."""
        return self._shard.n if self._shard is not None else int(self.data.shape[0])

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
        return self._shard.d if self._shard is not None else int(self.data.shape[1])

    def all_observed(self) -> bool:
        """True when every entry is observed.  Cached."""
        if self._all_observed is None:
            self._all_observed = bool(self.mask.all())
        return self._all_observed

    def pattern_info(self, include_dense: bool = False) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Distinct-mask-pattern table for the pattern path
        (ops/pattern_dedup.py), or ``None`` when it would not pay off.

        Returns ``(pidx (N,) int64, patterns (P, D) bool)`` on the dataset's
        device with ``patterns[pidx] == mask``; patterns come in the order
        of their packed words, not of first appearance.  None when the
        dataset is empty or shorter than ``2 * config.pattern_min_ratio``,
        when it is fully observed (the dense path owns that case), or when
        P exceeds ``min(config.pattern_max, N // config.pattern_min_ratio)``.
        Datasets of more than 131,072 rows first count the patterns of a
        65,536-row prefix, so unstructured masks demote cheaply.  Cached;
        ``with_weights`` and ``to`` share the cache.  ``config.use_pattern_dedup``
        is read on every call, so turning it off takes effect at once.

        ``include_dense=True`` (the mixtures' table route) also returns the
        trivial single-pattern table ``(zeros(N), ones(1, D))`` for fully
        observed data; the default call leaves that case to the dense path
        and caches nothing for it.

        A sharded dataset returns None, uncached, until the collective
        :meth:`detect_patterns` has run; then its table."""
        if not config.use_pattern_dedup:
            return None
        if self._patterns is not None:
            return self._patterns or None
        if self._shard is not None:
            # host-local: ranks may reach this at different points, so it
            # starts no collective; the table comes from detect_patterns(),
            # and nothing is cached, so that a later call still runs
            return None
        n = len(self)
        if self.is_empty() or n < 2 * config.pattern_min_ratio:
            self._patterns = False
            return None
        if self.all_observed():
            if include_dense:
                return (torch.zeros(n, dtype=torch.int64, device=self.device),
                        torch.ones((1, self.data.shape[1]), dtype=torch.bool, device=self.device))
            return None
        p_cap = min(config.pattern_max, n // config.pattern_min_ratio)
        with span("ppca.pattern_detect"):
            self._patterns = _detect_patterns(self.mask, p_cap) or False
        return self._patterns or None

    def detect_patterns(self, include_dense: bool = False):
        """Run pattern detection now: :meth:`pattern_info`, and on a sharded
        dataset a collective that every rank of its mesh calls at the same
        point (before training).  The ranks exchange their distinct packed
        masks and build one table, the single-process table of the global
        rows; each maps its rows to it.  Later :meth:`pattern_info` calls
        return it without communicating.  A model-axis mesh keeps the
        general route (None, cached)."""
        if self._shard is None:
            return self.pattern_info(include_dense)
        from .parallel.mesh import detect_patterns

        return detect_patterns(self, include_dense)

    def pattern_order(self) -> Optional[Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]]:
        """Rows sorted by pattern, for the per-segment EM
        (ops/pattern_dedup.em_stats_sorted), or ``None`` when it does not
        apply.  Returns ``(data_sorted, perm, counts)``: ``data_sorted =
        data[perm]`` with each pattern's rows contiguous (a cached copy,
        which doubles the data's device memory while it lives, hence the
        ``config.pat_sorted_max_bytes`` gate), the (N,) int64 stable
        permutation, and the per-pattern row counts as a tuple of ints
        (segment p is rows ``[sum(counts[:p]), sum(counts[:p + 1]))``).
        None also when the segments are shorter than
        ``config.pat_sorted_min_rows`` on average.  A sharded dataset sorts
        its own rows against the global table."""
        if not config.use_pattern_dedup:
            return None
        if self._pattern_order is not None:
            return self._pattern_order or None
        info = self.pattern_info()
        if (info is None or self.data.nbytes > config.pat_sorted_max_bytes
                or self.data.shape[0] < info[1].shape[0] * config.pat_sorted_min_rows):
            self._pattern_order = False
            return None
        pidx, patterns = info
        with span("ppca.pattern_order"):
            perm = torch.argsort(pidx, stable=True)
            counts = tuple(int(c) for c in
                           torch.bincount(pidx, minlength=patterns.shape[0]).tolist())
            self._pattern_order = (self.data.index_select(0, perm), perm, counts)
        return self._pattern_order

    def empty_dimensions(self) -> List[int]:
        """Dimensions masked in *every* sample (`dataset.rs:193-222`), of
        every rank for a sharded dataset."""
        if self._shard is not None:
            return list(self._shard.empty)
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
        device = config.resolve_device(device)
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
        """Rows ``[start, stop)``; of a sharded dataset, of this rank's rows,
        as a dataset of its own."""
        stop = min(stop, int(self.data.shape[0]))
        new = Dataset.from_parts(
            self.data[start:stop], self.mask[start:stop], self.weights_dev[start:stop]
        )
        if self._all_observed:
            new._all_observed = True
        return new

    def chunks(self, chunks: int) -> "DatasetChunks":
        """Iterator over ``chunks`` contiguous slices of stride ``ceil(len /
        chunks)``; the last may be shorter (`src/python_bindings.rs:110-118,
        136-166`).  Of a sharded dataset, this rank's rows."""
        n = int(self.data.shape[0])
        stride = -(-n // chunks) if chunks > 0 else n
        return DatasetChunks(self, max(stride, 1))

    @staticmethod
    def concat(datasets: Sequence["Dataset"]) -> "Dataset":
        """The datasets' rows one after another (`src/python_bindings.rs:
        120-133`).  They must lie on one device: nothing is moved here."""
        datasets = list(datasets)
        if not datasets:
            raise ValueError("cannot concat an empty list of datasets")
        devices = {d.device for d in datasets}
        if len(devices) != 1:
            raise ValueError(f"cannot concat datasets on different devices: "
                             f"{sorted(str(d) for d in devices)}")
        return Dataset.from_parts(torch.cat([d.data for d in datasets]),
                                  torch.cat([d.mask for d in datasets]),
                                  torch.cat([d.weights_dev for d in datasets]))

    def __repr__(self) -> str:
        return (f"Dataset(len={len(self)}, output_size={self.output_size()}, "
                f"dtype={self.dtype}, device={self.device})")


class DatasetChunks:
    """Iterator of contiguous :class:`Dataset` slices
    (`src/python_bindings.rs:136-166`)."""

    def __init__(self, dataset: Dataset, stride: int):
        self._dataset = dataset
        self._stride = stride
        self._position = 0

    def __iter__(self) -> Iterator[Dataset]:
        return self

    def __next__(self) -> Dataset:
        if self._position >= self._dataset.data.shape[0]:
            raise StopIteration
        start = self._position
        self._position += self._stride
        return self._dataset.slice(start, start + self._stride)
