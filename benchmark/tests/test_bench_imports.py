"""Nothing under ``benchmark/`` imports JAX or the JAX package (top-level
names compared whole: ``probing_rag_tpu_torch`` is the port), and nothing
under ``benchmark/reference/`` imports the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "probing_rag_tpu"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("source, bad", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from jaxlib import xla_client", {"jaxlib"}),
    ("from probing_rag_tpu.models import gemma", {"probing_rag_tpu"}),
    ("import probing_rag_tpu_torch.models.gemma", set()),
    ("import importlib\nimportlib.import_module('flax.linen')", {"flax"}),
])
def test_scan_compares_whole_names(source, bad):
    assert top_level_imports(source) & FORBIDDEN == bad


def test_benchmark_imports_no_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f.read_text()) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert "probing_rag_tpu_torch" not in top_level_imports(f.read_text()), f
