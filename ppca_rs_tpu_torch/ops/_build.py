"""Build and load the package's CUDA kernels.

The sources under ``ppca_rs_tpu_torch/csrc`` expose a plain C interface, so
they are compiled by ``nvcc`` alone into a shared library and loaded with
``ctypes``: no PyTorch headers, which keeps a cold build to seconds.  The
library is built at first use into ``ppca_rs_tpu_torch/_build/`` and its name
carries a hash of the sources and flags, so an edited source rebuilds and a
stale library is never loaded.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def source_key() -> str:
    """Hash of every source's name and bytes plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"ppca_kernels-{source_key()}.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command(output: Path) -> List[str]:
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    return [nvcc_path(), *NVCC_FLAGS, f"-I{SOURCE_DIR}", "-o", str(output), *cu]


def build() -> Path:
    """Compile the sources unless a library with the same key exists.  The
    output is written to a temporary name and renamed into place, so
    processes that build at once never load a half-written file."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(Path(tmp)), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p = ctypes.c_void_p
            for name in ("spd_estep_f32", "spd_estep_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, p,
                               p, ctypes.c_longlong, ctypes.c_int, p]
                fn.restype = ctypes.c_int
            lib.spd_estep_error_string.argtypes = [ctypes.c_int]
            lib.spd_estep_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
