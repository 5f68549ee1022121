"""No module of the benchmark imports JAX or the JAX package (``repro``),
and no module of the reference imports the program (``repro_torch``): each
import's top-level name is compared whole, since ``repro_torch`` begins
with ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert not tops & (FORBIDDEN | {"repro_torch"})
    assert tops <= {"__future__", "contextlib", "math", "torch", "bench"}


def test_the_guard_compares_whole_names(tmp_path):
    from bench.core import forbidden_loaded
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n"
                   "import repro_torch\n")
    assert imported_tops(bad) & FORBIDDEN == {"repro", "jax"}
    assert forbidden_loaded(["repro_torch.models", "reprox", "numpy"]) == []
    assert forbidden_loaded(["repro.core", "jaxlib.xla"]) == ["jaxlib",
                                                               "repro"]
