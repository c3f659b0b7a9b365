"""The whole slice — prompt, prefill, greedy decode with capture pooling,
prober gate, BM25 retrieval, regeneration — against the JAX pipeline, on
the corpus of .claude/skills/verify/rag_demo.py (doc lengths made distinct)
with the tiny f32 model. The same loop runs over the dense retrievers (the
flat engine and the IVF engine probing every cell), with the tiny f32
encoder on both sides.

Both sides get the same numpy-drawn LM and prober parameters. Predictions
and retrieval counts must be equal; gate scores allclose at rtol 1e-4 /
atol 1e-4 (f32 forward sums in another order). Retrieval ids can only
match if the top-k scores are distinct, which the test asserts for every
query the pipeline searched.

A subprocess imports every module of the port, runs the CPU ``index-build``
and ``rag-run`` CLI on a fixture over BM25 (bf16, and with quantized
weights and KV cache), the flat dense index (bf16 and int8) and the IVF
index, and checks that jax was never imported."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.data.corpus import DocStore
from probing_rag_tpu.models import encoder as je
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu.pipeline.rag import AdaptiveRAGPipeline as JaxPipeline
from probing_rag_tpu.pipeline.rag import RAGConfig as JaxRAGConfig
from probing_rag_tpu.retrieval.bm25 import BM25Engine as JaxBM25Engine
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu.retrieval import dense as jdense
from probing_rag_tpu.retrieval import ivf as jivf
from probing_rag_tpu_torch.models import encoder as te
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.retrieval import dense as tdense
from probing_rag_tpu_torch.retrieval import ivf as tivf
from probing_rag_tpu_torch.weights import encoder_params_from_jax, lm_params_from_jax, probers_from_jax

from test_torch_gemma import numpy_params, to_jax
from test_torch_prober import numpy_stack

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# rag_demo.py's corpus, with docs lengthened or shortened to distinct token
# counts: two docs of one length matching the same query words would tie
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "paris is the capital of france",
    "the eiffel tower is in central paris",
    "mount everest is the tallest mountain on earth",
    "the pacific ocean is the largest and the deepest ocean",
    "water boils at hundred degrees",
]
QUESTIONS = ["where is the eiffel tower?", "which ocean is the largest?"]


class RecordingEngine:
    """Delegates to a BM25 engine and records every query searched."""

    def __init__(self, engine):
        self.engine = engine
        self.queries = []

    def search(self, queries, k=5):
        self.queries.extend(queries)
        return self.engine.search(queries, k=k)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)
    lm = numpy_params(jcfg, seed=5)
    probers = numpy_stack(len(jcfg.probe_layers), jcfg.d_model, seed=6)
    bm = dict(stem=False, remove_stopwords=False)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jlm=to_jax(lm), tlm=lm_params_from_jax(lm, tcfg, device="cpu"),
        jprobers=to_jax(probers), tprobers=probers_from_jax(probers, device="cpu"),
        jidx=JaxBM25Index.build(CORPUS, JaxBM25Config(**bm)),
        tidx=BM25Index.build(CORPUS, BM25Config(**bm)),
    )


@pytest.mark.parametrize("method,threshold", [
    ("probing", -1e6), ("probing", 0.0), ("probing", 1e6), ("none", 0.0), ("simple", 0.0),
])
def test_pipeline_matches_jax(setup, method, threshold):
    s = setup
    store = DocStore.from_texts(CORPUS)
    kw = dict(retr_method=method, threshold=threshold, batch_size=2, max_new_tokens=6)
    jres = JaxPipeline(s["jlm"], s["jcfg"], JaxByteTokenizer(512), JaxBM25Engine(s["jidx"]),
                       store, s["jprobers"], JaxRAGConfig(**kw)).run(QUESTIONS)
    engine = RecordingEngine(BM25Engine(s["tidx"], device="cpu"))
    tres = AdaptiveRAGPipeline(s["tlm"], s["tcfg"], ByteTokenizer(512), engine, store,
                               s["tprobers"], RAGConfig(**kw)).run(QUESTIONS)
    for q in engine.queries:  # retrieval ids are comparable only without ties
        ids = s["tidx"].encode_query(engine.engine.analyzer(q))
        top = np.sort(s["tidx"].score_all(ids))[::-1][:5]
        top = top[top > 0]
        assert (np.abs(np.diff(top)) > 1e-4).all(), (q, top)
    assert tres.pred_list == jres.pred_list
    assert tres.retr_count_list == jres.retr_count_list
    if method == "probing":
        expect = {-1e6: 0, 1e6: 3}.get(threshold)
        if expect is not None:
            assert tres.retr_count_list == [expect] * len(QUESTIONS)
        for a, b in zip(tres.gate_scores, jres.gate_scores):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant,kv", [
    (dict(bits=8), dict(kv_int8=True)),
    (dict(bits=4, int4_scheme="rank1"), dict(kv_int4=True)),
])
def test_quantized_pipeline_matches_jax(setup, quant, kv):
    """``rag-run --quantize int8 --kv-int8`` (and rank-1 int4 weights with
    the int4 KV cache): the probing loop over BM25, all 4 retrieval rounds,
    gives the JAX pipeline's predictions and retrieval counts on the same
    quantized tree."""
    s = setup
    qtree = jax.tree_util.tree_map(np.asarray, jg.quantize_lm_params(s["jlm"], **quant))
    store = DocStore.from_texts(CORPUS)
    kw = dict(retr_method="probing", threshold=1e6, batch_size=2, max_new_tokens=6, **kv)
    jres = JaxPipeline(to_jax(qtree), s["jcfg"], JaxByteTokenizer(512), JaxBM25Engine(s["jidx"]),
                       store, s["jprobers"], JaxRAGConfig(**kw)).run(QUESTIONS)
    engine = RecordingEngine(BM25Engine(s["tidx"], device="cpu"))
    tres = AdaptiveRAGPipeline(lm_params_from_jax(qtree, s["tcfg"], device="cpu"), s["tcfg"],
                               ByteTokenizer(512), engine, store, s["tprobers"],
                               RAGConfig(**kw)).run(QUESTIONS)
    for q in engine.queries:  # retrieval ids are comparable only without ties
        ids = s["tidx"].encode_query(engine.engine.analyzer(q))
        top = np.sort(s["tidx"].score_all(ids))[::-1][:5]
        top = top[top > 0]
        assert (np.abs(np.diff(top)) > 1e-4).all(), (q, top)
    assert tres.pred_list == jres.pred_list
    assert tres.retr_count_list == jres.retr_count_list == [3] * len(QUESTIONS)
    for a, b in zip(tres.gate_scores, jres.gate_scores):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


def jax_encoder(params, cfg):
    """The JAX CLI's ``_dense_encoder`` closure, with given parameters."""
    tok = JaxByteTokenizer(max(cfg.vocab_size, 259))
    fwd = jax.jit(lambda p, t, m: je.encoder_forward(p, t, m, cfg))

    def encode(texts):
        ids = [tok.encode(t)[: cfg.max_positions] for t in texts]
        ml = max(max((len(i) for i in ids), default=1), 1)
        arr = np.zeros((len(ids), ml), np.int32)
        mask = np.zeros((len(ids), ml), bool)
        for i, row in enumerate(ids):
            arr[i, : len(row)] = [min(t, cfg.vocab_size - 1) for t in row]
            mask[i, : len(row)] = True
        return np.asarray(fwd(params, jnp.asarray(arr), jnp.asarray(mask)))

    return encode


@pytest.fixture(scope="module")
def encoders():
    jcfg = dataclasses.replace(je.EncoderConfig.tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, je.init_encoder_params(jcfg, jax.random.PRNGKey(0)))
    tenc = te.text_encoder(encoder_params_from_jax(params, tcfg, device="cpu"), tcfg,
                           ByteTokenizer(259), device="cpu")
    return jax_encoder(to_jax(params), jcfg), tenc


@pytest.mark.parametrize("engine", ["flat", "ivf"])
def test_dense_pipeline_matches_jax(setup, encoders, engine):
    """The probing loop over dense retrieval (l2, bf16 store; the IVF
    engine probes both of its 2 cells) gives the JAX pipeline's
    predictions and retrieval counts."""
    s = setup
    jenc, tenc = encoders
    store = DocStore.from_texts(CORPUS)
    jflat = jdense.DenseIndex.build(CORPUS, jenc)
    tflat = tdense.DenseIndex.build(CORPUS, tenc)
    np.testing.assert_allclose(tflat.embeddings, jflat.embeddings, rtol=1e-5, atol=1e-5)
    if engine == "flat":
        jeng = jdense.DenseEngine(jflat, jenc, use_pallas=True)
        teng = tdense.DenseEngine(tflat, tenc, device="cpu")
    else:
        jeng = jivf.IVFEngine(jivf.IVFDenseIndex.build(jflat.embeddings, nlist=2, block=32),
                              nprobe=2, encode_fn=jenc)
        teng = tivf.IVFEngine(tivf.IVFDenseIndex.build(tflat.embeddings, nlist=2, block=32,
                                                        device="cpu"), device="cpu",
                              nprobe=2, encode_fn=tenc)
    kw = dict(retr_method="probing", threshold=1e6, batch_size=2, max_new_tokens=6)
    jres = JaxPipeline(s["jlm"], s["jcfg"], JaxByteTokenizer(512), jeng, store,
                       s["jprobers"], JaxRAGConfig(**kw)).run(QUESTIONS)
    rec = RecordingEngine(teng)
    tres = AdaptiveRAGPipeline(s["tlm"], s["tcfg"], ByteTokenizer(512), rec, store,
                               s["tprobers"], RAGConfig(**kw)).run(QUESTIONS)
    assert len(rec.queries) == 4 * len(QUESTIONS)  # 4 search rounds, 3 counted
    q = tenc(rec.queries)  # retrieval ids are comparable only without ties
    d = np.sort(((q[:, None, :] - tflat.embeddings[None]) ** 2).sum(-1), axis=1)[:, :5]
    assert (np.diff(d, axis=1) > 1e-4).all(), d
    assert tres.pred_list == jres.pred_list
    assert tres.retr_count_list == jres.retr_count_list == [3] * len(QUESTIONS)


def test_unported_knobs_raise(setup):
    s = setup
    with pytest.raises(NotImplementedError, match="split_prefill"):
        AdaptiveRAGPipeline(s["tlm"], s["tcfg"], ByteTokenizer(512), None, None, None,
                            RAGConfig(split_prefill=True))
    pipe = AdaptiveRAGPipeline(s["tlm"], s["tcfg"], ByteTokenizer(512), None, None, None,
                               RAGConfig(retr_method="bogus"))
    with pytest.raises(ValueError, match="bogus"):
        pipe.run(["q"])


def test_spec_pipeline_matches_jax(setup):
    """The probing loop with speculative decode (RAGConfig.spec_k = 2,
    prompt-lookup drafts) gives the JAX pipeline's predictions and
    retrieval counts, and those of the port's greedy loop (spec_k = 0)."""
    s = setup
    store = DocStore.from_texts(CORPUS)
    kw = dict(retr_method="probing", threshold=0.0, batch_size=2, max_new_tokens=6)
    jres = JaxPipeline(s["jlm"], s["jcfg"], JaxByteTokenizer(512), JaxBM25Engine(s["jidx"]),
                       store, s["jprobers"], JaxRAGConfig(spec_k=2, **kw)).run(QUESTIONS)
    tres = {}
    for k in (2, 0):
        tres[k] = AdaptiveRAGPipeline(
            s["tlm"], s["tcfg"], ByteTokenizer(512), BM25Engine(s["tidx"], device="cpu"), store,
            s["tprobers"], RAGConfig(spec_k=k, **kw)).run(QUESTIONS)
    assert tres[2].pred_list == jres.pred_list == tres[0].pred_list
    assert tres[2].retr_count_list == jres.retr_count_list == tres[0].retr_count_list


def test_cli_rag_run_spec_k(tmp_path):
    """``rag-run --spec-k 2 --device cpu`` over a BM25 fixture index runs the
    loop through speculative decode and records the knob."""
    from probing_rag_tpu_torch.cli.main import main

    (tmp_path / "corpus.txt").write_text("\n".join(CORPUS))
    (tmp_path / "qa.json").write_text(json.dumps([
        {"question": "where is the eiffel tower?", "answers": ["paris"]},
        {"question": "what is the tallest mountain?", "answers": ["everest"]}]))
    main(["index-build", "--dataset", "nq", "--fixture", str(tmp_path / "corpus.txt"),
          "--out", str(tmp_path / "idx")])
    main(["rag-run", "--device", "cpu", "--dataset", "nq", "--fixture-qa",
          str(tmp_path / "qa.json"), "--index", str(tmp_path / "idx"), "--max-new-tokens", "6",
          "--batch-size", "2", "--threshold", "1e6", "--spec-k", "2",
          "--results-dir", str(tmp_path / "result")])
    rec = json.loads((tmp_path / "result" / "runs.jsonl").read_text().splitlines()[-1])
    assert rec["retr_counts"] == [3, 3], rec
    assert rec["config"]["spec_k"] == 2 and rec["config"]["spec_drafter"] == "prompt"


def test_run_resumable_skips_done_chunks(setup, tmp_path):
    s = setup
    store = DocStore.from_texts(CORPUS)
    pipe = AdaptiveRAGPipeline(s["tlm"], s["tcfg"], ByteTokenizer(512),
                               BM25Engine(s["tidx"], device="cpu"),
                               store, s["tprobers"],
                               RAGConfig(batch_size=2, max_new_tokens=4, threshold=1e6))
    manifest = tmp_path / "runs.jsonl"
    questions = QUESTIONS + ["what is the capital of france?"]
    first = pipe.run_resumable(questions, manifest, chunk_size=2)  # last chunk padded
    lines = manifest.read_text().splitlines()
    assert [json.loads(l)["i"] for l in lines] == [0, 1, 2]
    again = pipe.run_resumable(questions, manifest, chunk_size=2)
    assert manifest.read_text().splitlines() == lines  # nothing recomputed
    assert again.pred_list == first.pred_list
    assert again.retr_count_list == first.retr_count_list == [3, 3, 3]


SUBPROCESS = r"""
import importlib, json, pkgutil, sys, tempfile
from pathlib import Path
import probing_rag_tpu_torch
names = [m.name for m in pkgutil.walk_packages(probing_rag_tpu_torch.__path__,
                                               "probing_rag_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
print("MODULES", len(names))
from probing_rag_tpu_torch.cli.main import main
d = Path(tempfile.mkdtemp())
(d / "corpus.txt").write_text("\n".join(json.loads(sys.argv[1])))
(d / "qa.json").write_text(json.dumps([
    {"question": "where is the eiffel tower?", "answers": ["paris"]},
    {"question": "what is the tallest mountain?", "answers": ["everest"]}]))
main(["index-build", "--dataset", "nq", "--fixture", str(d / "corpus.txt"), "--out", str(d / "idx")])
main(["rag-run", "--device", "cpu", "--dataset", "nq", "--fixture-qa", str(d / "qa.json"),
      "--index", str(d / "idx"), "--max-new-tokens", "6", "--batch-size", "2",
      "--threshold", "1e6", "--results-dir", str(d / "result")])
runs = (d / "result" / "runs.jsonl").read_text().splitlines()
assert json.loads(runs[-1])["retr_counts"] == [3, 3], runs[-1]
for flags in (["--quantize", "int8", "--kv-int8", "--act-int8-rows", "16"],
              ["--quantize", "int4", "--int4-scheme", "rank1", "--kv-int4"]):
    main(["rag-run", "--device", "cpu", "--dataset", "nq", "--fixture-qa", str(d / "qa.json"),
          "--index", str(d / "idx"), "--max-new-tokens", "6", "--batch-size", "2",
          "--threshold", "1e6", "--results-dir", str(d / "q_result"), *flags])
    rec = json.loads((d / "q_result" / "runs.jsonl").read_text().splitlines()[-1])
    assert rec["retr_counts"] == [3, 3] and rec["config"]["quantize"] == flags[1], rec
main(["index-build", "--device", "cpu", "--dataset", "nq", "--fixture", str(d / "corpus.txt"),
      "--out", str(d / "dense"), "--dense", "--dense-ivf", "--ivf-nlist", "2"])
for flags in (["--dense"], ["--dense", "--dense-int8"], ["--dense", "--dense-ivf", "--ivf-nprobe", "2"]):
    main(["rag-run", "--device", "cpu", "--dataset", "nq", "--fixture-qa", str(d / "qa.json"),
          "--index", str(d / "dense"), "--max-new-tokens", "6", "--batch-size", "2",
          "--threshold", "1e6", "--results-dir", str(d / "dense_result"), *flags])
    runs = (d / "dense_result" / "runs.jsonl").read_text().splitlines()
    assert json.loads(runs[-1])["retr_counts"] == [3, 3], (flags, runs[-1])
assert any("dense" in p.name for p in (d / "dense_result").iterdir())
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SUBPROCESS, json.dumps(CORPUS)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    n_modules = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 25, proc.stdout
