"""Nothing the benchmark runs imports JAX or the JAX package: every module
under ``bench/`` but the tests, its imports' top-level names compared
whole (``repro_torch`` is not ``repro``); the references import nothing of
the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _top_names(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("kind", ["reference"])
def test_reference_imports_nothing_of_the_program(kind):
    for path in sorted((BENCH / kind).glob("*.py")):
        assert "repro_torch" not in _top_names(path), path


def test_forbidden_modules_compare_whole_names():
    from bench import harness
    assert harness.forbidden_modules(["reprox", "repro_torch.models",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src", "flax",
                                      "repro_torch"]) == ["flax", "jax",
                                                          "repro"]
