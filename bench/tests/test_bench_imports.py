"""Nothing under bench/ imports JAX, jaxlib, flax, the JAX package (repro)
or its benchmarks (compared by whole top-level name: repro_torch is not
repro), and the plain reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert set(top_level_imports(path)) <= {"__future__", "math", "typing", "torch"}, path


def test_the_whole_name_is_compared(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\nimport reprox\n")
    assert not set(top_level_imports(p)) & FORBIDDEN
    p.write_text("from repro.core import engine\n")
    assert set(top_level_imports(p)) & FORBIDDEN == {"repro"}
