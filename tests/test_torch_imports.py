"""The port imports nothing of the JAX package, and not nltk (absent where
the port runs on the card): every ``.py`` under ``probing_rag_tpu_torch/``
and ``chip_smoke.py`` is scanned (by its syntax tree, so imports inside
functions count too) for ``import probing_rag_tpu``, ``from
probing_rag_tpu[.x] import ...`` and any import of jax or nltk."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "probing_rag_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("probing_rag_tpu", "jax", "jaxlib", "nltk")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_port_imports_nothing_of_the_jax_package(path):
    bad = [(line, mod) for line, mod in imported_modules(path) if forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_catches_the_forbidden_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import probing_rag_tpu\nfrom probing_rag_tpu.data import prompts\n"
                   "def f():\n    import jax.numpy\n    from nltk.stem import PorterStemmer\n"
                   "import probing_rag_tpu_torch\nfrom probing_rag_tpu_torch.data import qa\n")
    assert [m for _, m in imported_modules(src) if forbidden(m)] == [
        "probing_rag_tpu", "probing_rag_tpu.data", "jax.numpy", "nltk.stem"]
    assert len(FILES) > 30
