"""The torch port stands alone: no module under tch_geometric_tpu_torch/
imports jax, flax, optax or the JAX package (checked on the source with
ast), and importing it loads none of them."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tch_geometric_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tch_geometric_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_loads_no_jax():
    # compare before/after: an interpreter start-up hook may load jax itself
    code = ("import sys\n"
            f"bad = lambda: {{m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}}}\n"
            "before = bad()\n"
            "import tch_geometric_tpu_torch\n"
            "print(sorted(bad() - before))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
