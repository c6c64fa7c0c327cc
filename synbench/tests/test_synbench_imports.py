"""Nothing under synbench imports JAX, the JAX package or its benchmarks,
judged by whole top-level names; the yardstick imports nothing of the
program."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro",
                                      "benchmarks"}


@pytest.mark.parametrize("path", [p for p in FILES
                                  if p.parent.name in ("core", "reference",
                                                       "metrics")],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types
    from synbench.core import harness
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["repro"]
