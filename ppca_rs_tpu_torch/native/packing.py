"""Host packing: user arrays into the tensors a :class:`Dataset` holds.

Port of ``ppca_rs_tpu/native/packing.py`` with its own copy of the C++
(``packing.cpp``).  :func:`mask_non_finite` turns a float64 array with
NaN/inf holes into the zero-filled values, already in the storage dtype,
and the observed mask, in one multithreaded pass;
:func:`scatter_long_to_dense` writes long-format (sample, dim, value)
triplets into a dense NaN-filled array, last wins on duplicates.

The library is built by ``g++`` at first use into
``ppca_rs_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags, and renamed into place from a temporary file, so
processes that build at once never load a half-written one.  A failed
build or load raises with the compiler's messages: nothing falls back.
The numpy versions (``*_reference``) are the plain versions the tests hold
the library against; no path calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "packing.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: Storage dtypes the pass writes directly; any other (bfloat16) takes the
#: float32 pass and one torch cast.
_PASS = {torch.float64: "ppca_mask_non_finite_f64", torch.float32: "ppca_mask_non_finite_f32"}


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"ppca_packing-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library with its key exists; raise with
    g++'s messages if it fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *FLAGS, str(source), "-o", tmp], capture_output=True,
                              text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source} (exit code {done.returncode}):\n"
                               f"{done.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    """The packing library, built on first call from :data:`SOURCE`, with
    every entry point's argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(SOURCE)))
            p = ctypes.c_void_p
            for name in _PASS.values():
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, ctypes.c_int64]   # in, values, mask, n
                fn.restype = None
            lib.ppca_scatter_long_f64.argtypes = [p, p, p, ctypes.c_int64, p, ctypes.c_int64]
            lib.ppca_scatter_long_f64.restype = None
            _lib = lib
        return _lib


def mask_non_finite(arr: np.ndarray, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, mask)`` as CPU tensors: ``values`` in ``dtype`` with 0
    where ``arr`` is NaN or infinite, ``mask`` True where it is finite."""
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    written = dtype if dtype in _PASS else torch.float32
    values = torch.empty(arr.shape, dtype=written)
    mask = torch.empty(arr.shape, dtype=torch.bool)
    getattr(load(), _PASS[written])(arr.ctypes.data, values.data_ptr(), mask.data_ptr(), arr.size)
    return values.to(dtype), mask


def mask_non_finite_reference(arr: np.ndarray,
                              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`mask_non_finite`: numpy's isfinite,
    where and a cast."""
    arr = np.asarray(arr, dtype=np.float64)
    mask = np.isfinite(arr)
    return torch.as_tensor(np.where(mask, arr, 0.0), dtype=dtype), torch.as_tensor(mask)


def scatter_long_to_dense(sample_idx, dim_idx, values, n_samples: int,
                          n_dims: int) -> np.ndarray:
    """Scatter long-format (sample, dim, value) triplets into a dense
    NaN-filled (n_samples, n_dims) float64 array, the later triplet winning
    on a duplicate pair (`python/ppca_rs/__init__.py:183-186,244-248` in
    the reference is a per-group Python loop).  An index outside its range
    raises IndexError."""
    sample_idx = np.ascontiguousarray(sample_idx, dtype=np.int64).reshape(-1)
    dim_idx = np.ascontiguousarray(dim_idx, dtype=np.int64).reshape(-1)
    values = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
    if not sample_idx.shape == dim_idx.shape == values.shape:
        raise ValueError(f"triplet lengths differ: {sample_idx.shape[0]}, {dim_idx.shape[0]}, "
                         f"{values.shape[0]}")
    for name, idx, n in (("sample", sample_idx, n_samples), ("dim", dim_idx, n_dims)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"{name} index out of range [0, {n})")
    out = np.full((n_samples, n_dims), np.nan, dtype=np.float64)
    load().ppca_scatter_long_f64(sample_idx.ctypes.data, dim_idx.ctypes.data, values.ctypes.data,
                                 values.size, out.ctypes.data, n_dims)
    return out


def scatter_long_to_dense_reference(sample_idx, dim_idx, values, n_samples: int,
                                    n_dims: int) -> np.ndarray:
    """The plain version of :func:`scatter_long_to_dense`: numpy fancy
    assignment."""
    out = np.full((n_samples, n_dims), np.nan, dtype=np.float64)
    out[np.asarray(sample_idx, dtype=np.int64), np.asarray(dim_idx, dtype=np.int64)] = (
        np.asarray(values, dtype=np.float64))
    return out
