"""No module of the benchmark imports JAX or the JAX package, and none is
loaded by a run; the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FOREIGN = {"jax", "jaxlib", "flax", "ppca_rs_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FOREIGN, (path, name)


def test_reference_imports_no_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "ppca_rs_tpu_torch", (path, name)


def test_a_run_loads_no_foreign_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from ppca_rs_tpu_torch.config import config; config.device = torch.device('cpu')\n"
        "from portbench import harness\n"
        "from portbench.tests import small\n"
        "harness.execute(small.cell('mix_m8_k32.train'), 1, 0.01, False, 'cpu')\n"
        "bad = harness.foreign_modules()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in %r), bad)\n"
        "assert not bad\n" % (str(BENCH.parent), sorted(FOREIGN)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("[] []")


def test_foreign_names_compare_whole_top_level_names():
    from portbench import harness

    sys.modules["ppca_rs_tpu_torch_probe"] = sys
    try:
        assert "ppca_rs_tpu_torch_probe" not in harness.foreign_modules()
        sys.modules["ppca_rs_tpu.probe"] = sys
        assert "ppca_rs_tpu.probe" in harness.foreign_modules()
    finally:
        sys.modules.pop("ppca_rs_tpu_torch_probe", None)
        sys.modules.pop("ppca_rs_tpu.probe", None)
