"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: module names compared whole at
the top level, since the program's name begins with the JAX package's."""

from __future__ import annotations

import ast

import pytest

from benchmark import run

FILES = sorted(run.BENCH.rglob("*.py"))


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(run.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "raytracer_odin_tpu"}


@pytest.mark.parametrize(
    "path", sorted((run.BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "raytracer_odin_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) - {"__future__", "base64", "json",
                                          "struct", "zlib", "dataclasses",
                                          "pathlib", "numpy", "torch",
                                          "math", "benchmark"}


def test_names_compared_whole():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "raytracer_odin_tpu")
    import sys

    import raytracer_odin_tpu_torch  # noqa: F401

    assert "raytracer_odin_tpu_torch" in sys.modules
    assert run.forbidden_modules() == [
        m for m in ("flax", "jax", "jaxlib", "raytracer_odin_tpu")
        if m in sys.modules]
