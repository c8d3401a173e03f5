"""What the benchmark imports: nothing of JAX or of the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``), the
references nothing of the program, and nothing reads the JAX package's
own benchmarks."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "contextlib", "torch", "numpy",
                                       "bench"}


def test_bench_reads_no_file_of_the_jax_packages_benchmarks():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text(), path


def test_whole_names_tell_the_port_from_the_jax_package():
    import sys
    sys.path.insert(0, str(BENCH))
    try:
        from bench.run import FORBIDDEN as RUN_FORBIDDEN
    finally:
        sys.path.remove(str(BENCH))
    assert "repro" in RUN_FORBIDDEN and "repro_torch" not in RUN_FORBIDDEN
    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN
