"""What the benchmark runs imports neither the JAX stack nor the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), and the plain references import nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
OWN = {"harness", "entries", "reference", "metrics", "conftest"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "gc", "math", "dataclasses", "numpy", "torch", "reference"}
    assert _imports(path) <= allowed


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from harness.runner import forbidden_modules

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.lookalike", sys)
    assert forbidden_modules() == ["jaxlib.lookalike"]


def test_run_loads_no_jax_in_the_process(smoke_root):
    """Importing every module a run loads leaves the JAX stack out."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.runner, entries.granite_train\n"
            "import repro_torch.launch.train\n"
            "from harness.runner import forbidden_modules\n"
            "print(forbidden_modules())") % (str(BENCH), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "feel_bench/run.py", "--workload",
                          "granite_train.s512", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
