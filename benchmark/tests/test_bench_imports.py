"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark.core import harness
from benchmark.core.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "tch_geometric_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_metric_entries_name_the_port():
    from benchmark.core.spec import metric_module
    for path in (BENCH_DIR / "metrics").glob("*.py"):
        entry = getattr(metric_module(path.stem), "ENTRY", None)
        if entry is not None:
            assert entry[0].split(".")[0] == "tch_geometric_tpu_torch"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        mods = set(_imports(path))
        assert not {m for m in mods if m.startswith("tch_geometric")}, path
        assert mods <= {"torch", "hashlib", "contextlib", "typing",
                        "__future__"}, (path, mods)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tch_geometric_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib.fake"]


def test_importing_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.core.harness, tch_geometric_tpu_torch; "
            "import tch_geometric_tpu_torch.parallel, "
            "tch_geometric_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tch_geometric_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)"
            % str(BENCH_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
