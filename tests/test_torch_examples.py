"""CPU smoke runs of the PyTorch port's examples (examples/torch_port/), the
nine scripts of examples/ one for one, and the check that the port, its
examples and chip_smoke.py import neither JAX nor the JAX package.

Each example is assert-bearing, so a subprocess exit code of 0 is an end to
end check of the surface it drives.  They run with ``--device cpu`` and
``PPCA_EXAMPLE_SMOKE=1`` (the heavy ones cut their sizes), one torch thread
a process; ``chip_smoke.py`` runs them on the card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES_DIR = ROOT / "examples" / "torch_port"
EXAMPLES = [
    "toy_model.py",
    "big_toy_model.py",
    "ppca_mixture.py",
    "priors.py",
    "pickling.py",
    "empty_dimensions.py",
    "streaming_out_of_core.py",
    "sharded_training.py",
    "structured_missingness.py",
]
FORBIDDEN = ("jax", "jaxlib", "ppca_rs_tpu")


def test_example_list_is_complete():
    """One port for each JAX example, under the same name, and nothing else."""
    on_disk = sorted(p.name for p in EXAMPLES_DIR.iterdir() if p.suffix == ".py")
    assert on_disk == sorted(EXAMPLES)
    jax_examples = sorted(p.name for p in (ROOT / "examples").iterdir() if p.suffix == ".py")
    assert on_disk == jax_examples


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_smoke(example):
    env = dict(os.environ, PPCA_EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(EXAMPLES_DIR / example), "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, (f"{example} failed:\nSTDOUT:\n{proc.stdout[-4000:]}\n"
                                  f"STDERR:\n{proc.stderr[-4000:]}")
    assert "ok:" in proc.stdout or example == "streaming_out_of_core.py"


def imported_roots(path: Path) -> set:
    """The top-level names of every module ``path`` imports, anywhere in it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_nothing_imports_jax():
    """No module or stub of the port, no example of the port and not
    chip_smoke.py imports jax or the JAX package (checked on the syntax
    tree, so an import inside a function counts too)."""
    stubs = sorted((ROOT / "ppca_rs_tpu_torch").rglob("*.pyi"))
    assert stubs
    files = [*sorted((ROOT / "ppca_rs_tpu_torch").rglob("*.py")), *stubs,
             *sorted(EXAMPLES_DIR.glob("*.py")), ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): sorted(imported_roots(f) & set(FORBIDDEN)) for f in files}
    assert not {f: names for f, names in bad.items() if names}
