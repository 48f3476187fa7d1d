"""The port's wheel carries every file the port reads at run time: the CUDA
sources that ``ops/_build.py`` compiles, the C++ that ``native/packing.py``
compiles beside itself, and the typed surface (``py.typed``,
``__init__.pyi``).

The wheel is built with ``pip wheel --no-build-isolation --no-deps`` (no
network, the installed setuptools) from a copy of the packaging files and
both packages in the test's tmp dir, so that the build's ``build/`` and
``*.egg-info`` land there and not in the repository.
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = "ppca_rs_tpu_torch"


def runtime_files():
    """The port's files, relative to the repository root, that are no
    Python module and that the port opens at run time."""
    pkg = ROOT / PORT
    files = [*pkg.glob("csrc/*.cu"), *pkg.glob("csrc/*.cuh"), *pkg.glob("native/*.cpp"),
             pkg / "py.typed", pkg / "__init__.pyi"]
    return sorted(str(f.relative_to(ROOT)) for f in files)


def test_wheel_carries_the_ports_runtime_files(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(ROOT / name, src / name)
    ignore = shutil.ignore_patterns("_build", "__pycache__", "*.so", "*.so.tmp")
    for pkg in ("ppca_rs_tpu", PORT):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=ignore)
    out = tmp_path / "wheel"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-deps",
         "--no-index", "-q", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())

    want = runtime_files()
    assert len([f for f in want if "/csrc/" in f]) >= 10
    assert f"{PORT}/native/packing.cpp" in want
    assert not [f for f in want if f not in names]
    modules = sorted(str(f.relative_to(ROOT)) for f in (ROOT / PORT).rglob("*.py"))
    assert not [f for f in modules if f not in names]
    assert not [n for n in names if n.startswith(f"{PORT}/_build") or n.endswith(".so")]
