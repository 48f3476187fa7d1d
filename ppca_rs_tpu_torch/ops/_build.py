"""Build and load the package's CUDA kernels.

The sources under ``ppca_rs_tpu_torch/csrc`` expose a plain C interface, so
they are compiled by ``nvcc`` alone and loaded with ``ctypes``: no PyTorch
headers, which keeps a cold build to seconds.  Each ``.cu`` file compiles to
an object in its own ``nvcc`` process, all started together, and the objects
link into one shared library.  The library is built at first use into
``ppca_rs_tpu_torch/_build/`` and its name carries a hash of the sources and
flags, so an edited source rebuilds and a stale library is never loaded.
Nothing is built when the module is imported.
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

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def source_key() -> str:
    """Hash of every source's name and bytes plus the compiler flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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


def compile_command(source: Path, obj: Path) -> List[str]:
    return [nvcc_path(), *COMPILE_FLAGS, f"-I{SOURCE_DIR}", "-c", "-o", str(obj), str(source)]


def link_command(objects: List[Path], output: Path) -> List[str]:
    return [nvcc_path(), *LINK_FLAGS, "-o", str(output), *map(str, objects)]


def _run_all(commands: List[List[str]]) -> None:
    """Run the commands as processes started together; raise with the
    compiler's messages if any fails.  No process outlives the call."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    failed = []
    try:
        for cmd, proc in zip(commands, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\nexit code {proc.returncode}:\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources unless a library with the same key exists.  The
    objects and the library are written in a temporary directory and the
    library is renamed into place, so processes that build at once never
    load a half-written file."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [p for p in sources() if p.suffix == ".cu"]
        objects = [Path(tmp) / f"{p.stem}.o" for p in cu]
        _run_all([compile_command(src, obj) for src, obj in zip(cu, objects)])
        lib = Path(tmp) / target.name
        _run_all([link_command(objects, lib)])
        os.replace(lib, target)
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
                # want, device, sigma, sigma's stride, G, b, rnorm, d_obs,
                # s, m, llk, sq, the panel design's scratch, B, k, G's
                # layout (0 square, 1 slabs), stream
                fn.argtypes = [ctypes.c_int, ctypes.c_int, p, ctypes.c_longlong, p, p, p, p,
                               p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
                fn.restype = ctypes.c_int
            for name in ("spd_chol_f32", "spd_chol_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int, p]
                fn.restype = ctypes.c_int
            for name in ("spd_estep_tile_max_k", "spd_chol_tile_max_k"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int]   # bytes per element
                fn.restype = ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            # bytes per element, device, k, spd_chol (1) or the E-step (0);
            # CTAs per multiprocessor, warps, samples a CTA (outputs)
            lib.spd_estep_tile_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_int, ip, ip, ip]
            lib.spd_estep_tile_occupancy.restype = ctypes.c_int
            ll = ctypes.c_longlong
            # device, mask, its row stride, slices, their row stride, out,
            # B, D, W, M, stream
            lib.mask_gram_bf16x3.argtypes = [ctypes.c_int, p, ll, p, ll, p, ll, ll, ll, ll, p]
            lib.mask_gram_bf16x3.restype = ctypes.c_int
            # device, CC, the slices, CC's rows, W, the slices' row width, stream
            lib.gram_split_bf16x3.argtypes = [ctypes.c_int, p, p, ll, ll, ll, p]
            lib.gram_split_bf16x3.restype = ctypes.c_int
            # device, mask, its row stride, SM, scale, S, B, D, W, M, stream
            lib.mask_s_bf16x3.argtypes = [ctypes.c_int, p, ll, p, p, p, ll, ll, ll, ll, p]
            lib.mask_s_bf16x3.restype = ctypes.c_int
            # device, D, W, M
            lib.mask_s_tile_width.argtypes = [ctypes.c_int, ll, ll, ll]
            lib.mask_s_tile_width.restype = ctypes.c_int
            lib.spd_estep_error_string.argtypes = [ctypes.c_int]
            lib.spd_estep_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
