"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere under ``benchmark/``, and nothing of the program in the plain
reference.  Top-level module names are compared whole: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from conftest import REPO

BENCH = REPO / "benchmark"
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "orbax", "phyloformer_tpu"}


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not imported(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "contextlib", "itertools", "typing", "torch"}


def test_a_rehearsal_loads_no_jax_side_module(tiny_root):
    """The run's process, after a whole rehearsal of every cell of the
    manifest."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness, manifest\n"
        "root = Path(%r)\n"
        "for cell in manifest.load(root)['workloads']:\n"
        "    harness.run(cell['name'], 9, 0.5, False, root, time.perf_counter(), device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (str(REPO), str(tiny_root), JAX_SIDE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
