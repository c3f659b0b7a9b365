"""The port imports nothing of the JAX package, and not nltk (absent where
the port runs on the card): every ``.py`` under ``probing_rag_tpu_torch/``
and ``chip_smoke.py`` is scanned (by its syntax tree, so imports inside
functions count too) for ``import probing_rag_tpu``, ``from
probing_rag_tpu[.x] import ...`` and any import of jax or nltk. The
optional packages, absent on the card's machine too, are imported only
inside the functions that need them: no module imports safetensors,
sentencepiece, transformers (the checkpoint side), matplotlib (the
figures), spacy (the baselines' text utilities) or wandb (the training
log) when it is imported."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "probing_rag_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("probing_rag_tpu", "jax", "jaxlib", "nltk")


OPTIONAL = ("safetensors", "sentencepiece", "transformers", "matplotlib", "spacy", "wandb")


def imported_modules(path: Path, module_level: bool = False):
    tree = ast.parse(path.read_text(), str(path))
    nodes = ast.walk(tree)
    if module_level:  # statements run at import: not inside a def or a class
        def top(body):
            for node in body:
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    yield node
                    for field in ("body", "orelse", "finalbody", "handlers"):
                        yield from top(getattr(node, field, []))

        nodes = top(tree.body)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_port_imports_nothing_of_the_jax_package(path):
    bad = [(line, mod) for line, mod in imported_modules(path) if forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_port_imports_optional_packages_only_where_used(path):
    bad = [(line, mod) for line, mod in imported_modules(path, module_level=True)
           if mod.split(".")[0] in OPTIONAL]
    assert not bad, f"{path.relative_to(REPO)} imports {bad} at module level"


def test_scanner_catches_the_forbidden_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import probing_rag_tpu\nfrom probing_rag_tpu.data import prompts\n"
                   "def f():\n    import jax.numpy\n    from nltk.stem import PorterStemmer\n"
                   "import probing_rag_tpu_torch\nfrom probing_rag_tpu_torch.data import qa\n")
    assert [m for _, m in imported_modules(src) if forbidden(m)] == [
        "probing_rag_tpu", "probing_rag_tpu.data", "jax.numpy", "nltk.stem"]
    assert len(FILES) > 30
    src.write_text("import safetensors\ntry:\n    from transformers import A\nexcept ImportError:\n"
                   "    pass\ndef f():\n    import sentencepiece\nclass C:\n    import safetensors.numpy\n")
    assert [m for _, m in imported_modules(src, module_level=True)] == ["safetensors", "transformers"]
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    assert {"probing_rag_tpu_torch/models/hf_loader.py", "probing_rag_tpu_torch/prober/train.py",
            "probing_rag_tpu_torch/eval/analysis.py", "probing_rag_tpu_torch/utils/logging.py",
            "probing_rag_tpu_torch/pipeline/dataset_builder.py", "probing_rag_tpu_torch/config.py",
            "probing_rag_tpu_torch/eval/figures.py", "probing_rag_tpu_torch/pipeline/baselines.py",
            "probing_rag_tpu_torch/utils/profiling.py"} <= names
