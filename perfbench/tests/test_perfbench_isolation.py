"""Nothing the benchmark runs loads jax or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import pathlib
import subprocess
import sys

from perfbench.run import FORBIDDEN, forbidden_modules

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = set(top_level_imports(path))
        assert not names & set(FORBIDDEN), (path, names & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(top_level_imports(path))
        assert names <= {"__future__", "math", "typing", "contextlib",
                         "numpy", "torch", "perfbench"}, (path, names)
        text = path.read_text()
        assert "spair_pytorch_tpu_torch" not in text, path


def test_names_are_compared_whole():
    sys.modules.setdefault("spair_pytorch_tpu_torch", sys)
    assert "spair_pytorch_tpu_torch" not in forbidden_modules()


def test_a_run_loads_no_jax_module():
    """Every module of the harness, the drivers and the program's modules
    they reach, imported in a fresh interpreter and after a tiny run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import perfbench\n"
        "for m in pkgutil.walk_packages(perfbench.__path__, 'perfbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from perfbench.tests.tiny import tiny_run\n"
        "from perfbench.run import execute, forbidden_modules\n"
        "execute(*tiny_run('train.paper128.b128', batch=2))\n"
        "execute(*tiny_run('train.quality.b32', batch=2))\n"
        "bad = forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'spair_pytorch_tpu_torch' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
