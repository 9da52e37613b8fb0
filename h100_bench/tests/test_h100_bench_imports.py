"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench.run import FORBIDDEN, HERE, ROOT

PORT = "monotonic_rnnt_tpu_torch"


def _imports(path: Path):
    """(top-level name, level) of every import in a file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax(path):
    assert not [n for n, level in _imports(path)
                if level == 0 and n in FORBIDDEN]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name, level in _imports(path):
        assert name != PORT
        # Relative imports stay inside reference/.
        assert level <= 1, f"{path.name} imports from outside reference/"


def test_the_names_are_compared_whole():
    assert "monotonic_rnnt_tpu" in FORBIDDEN and PORT not in FORBIDDEN


def test_a_run_loads_no_jax():
    """Importing every entry, reader and the harness loads none of the
    forbidden packages."""
    code = (
        "import sys, importlib\n"
        "from h100_bench import run, control, trace\n"
        "for d in ('loss', 'train'):\n"
        "    importlib.import_module('h100_bench.entries.' + d)\n"
        "for p in sorted((run.HERE / 'metrics').glob('*.py')):\n"
        "    run.reader(p.stem)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
