"""Nothing under bench_port/ imports JAX, the JAX package or the port's
tools, and the reference imports nothing of the port. Module names are
compared by their top-level part whole: dustraytracer_tpu_torch begins
with dustraytracer_tpu and is allowed where the port is."""

from __future__ import annotations

import ast

import pytest

from bench_port.tests.conftest import DATA

FORBIDDEN = {"jax", "jaxlib", "flax", "dustraytracer_tpu"}
SOURCES = sorted(p for p in DATA.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(DATA)))
def test_no_jax(path):
    for name in imported(path):
        assert name.split(".")[0] not in FORBIDDEN, name
        assert not name.startswith("dustraytracer_tpu_torch.tools"), name


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_stands_alone(path):
    for name in imported(path):
        assert name.split(".")[0] in {"__future__", "math", "numpy", "torch",
                                      "bench_port"}, name
        if name.startswith("bench_port"):
            assert name.startswith("bench_port.reference"), name


def test_top_level_names_compared_whole():
    import sys

    from bench_port import harness

    sys.modules.setdefault("dustraytracer_tpu_torch", sys.modules[__name__])
    assert "dustraytracer_tpu_torch" not in harness.forbidden_modules()
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
