"""Tests of the benchmark itself (not of the program), run from the repo's
root with ``python -m pytest benchmark/tests``. They import no JAX. Tests
marked ``chip`` need a CUDA card and skip without one (decided in the
``cuda`` fixture, never at import)."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_WORDS = {"n_terms": 2000, "zipf_s": 1.1, "seed": 7, "two_syllable": 800}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like tree: the benchmark's files and a BENCHMARK.json with
    two more cells at tiny sizes (``tiny.rag``, ``tiny.index``), added as
    files and entries alone, and a per-layer metric of their own."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "benchmark"
    lm = json.loads((d / "configs" / "mistral-7b.json").read_text())
    lm.update(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_hidden_layers=2,
              num_key_value_heads=2, vocab_size=4096, probe_layers=[0, 1])
    _write(d / "configs" / "tiny-mistral.json", lm)
    enc = json.loads((d / "configs" / "contriever-msmarco.json").read_text())
    enc.update(hidden_size=32, intermediate_size=64, num_attention_heads=2, num_hidden_layers=2,
               vocab_size=4096, max_position_embeddings=64)
    _write(d / "configs" / "tiny-bert.json", enc)
    rag = json.loads((d / "traffic" / "rag-bm25.json").read_text())
    rag.update(words=TINY_WORDS, tokenizer={"one_piece": 300},
               corpus={"docs": 3000, "words_per_doc": 30, "seed": 11},
               questions={"words_min": 3, "words_max": 5},
               loop={"batch": 4, "threshold": 1e6, "top_k": 5, "max_new_tokens": 6},
               check={"per_round": 2, "searches": 16})
    rag["bm25"]["cap"] = 3000  # small enough that long queries are cut
    _write(d / "traffic" / "tiny-rag.json", rag)
    idx = json.loads((d / "traffic" / "index-build.json").read_text())
    idx.update(words=TINY_WORDS, tokenizer={"one_piece": 300},
               check={"rows_per_call": 8, "reference_rows": 16})
    idx["passages"].update(call_docs=64, batch=16, tokens_median=26, tokens_max=64, pool_calls=3)
    _write(d / "traffic" / "tiny-index.json", idx)
    _write(d / "limits" / "tiny.rag.json", {"lm_gap_ms": 0.01, "pooled_err": 0.05, "gate_err": 1e-4, "bm25_err": 1e-6,
                                            "answers_missing": 0, "answers_truncated": 0})
    # between the tiny cells' own readings on the CPU (the program's emb_rel_err
    # ~7e-5, the fp8 control's ~8e-4), as a real cell's limits lie
    _write(d / "limits" / "tiny.index.json", {"emb_rel_err": 3e-4, "calls_malformed": 0})
    (d / "metrics" / "units.tiny.py").write_text(
        '"""Units of work in the window (a metric added as a file alone)."""\n\n\n'
        "def read(run):\n    return float(run.work)\n")
    b["configs"] += [
        {"name": "tiny-mistral", "source": "test", "file": "benchmark/configs/tiny-mistral.json",
         "reduced": [], "why": "test"},
        {"name": "tiny-bert", "source": "test", "file": "benchmark/configs/tiny-bert.json",
         "reduced": [], "why": "test"}]
    b["workloads"] += [
        {"name": "tiny.rag", "config": "tiny-mistral", "traffic": "tiny-rag", "chips": 1, "why": "t"},
        {"name": "tiny.index", "config": "tiny-bert", "traffic": "tiny-index", "chips": 1, "why": "t"}]
    for m in b["end_to_end"]:
        if m["name"] == "questions_per_s":
            m["workloads"].append("tiny.rag")
        if m["name"] == "docs_per_s":
            m["workloads"].append("tiny.index")
    for m in b["per_layer"]:
        m["workloads"] += ["tiny.rag" if m["moves"] == "questions_per_s" else "tiny.index"]
    b["per_layer"].append({"name": "units.tiny", "unit": "units", "better": "higher",
                           "source": "host_clock", "layer": "device", "moves": "docs_per_s",
                           "workloads": ["tiny.rag", "tiny.index"]})
    _write(tmp_path / "BENCHMARK.json", b)
    os.environ.setdefault("USE_FLAX", "0")
    return tmp_path
