"""The comparison baselines of the port (``pipeline/baselines.py``) against
the JAX package's, on the same numpy-drawn tiny f32 LM (the setup of
``tests/test_baselines.py``: byte tokenizer, a three-sentence BM25 corpus,
here with distinct doc lengths).

- text utilities: ``sentencize``, ``content_words`` (the golden fixture's
  sentences) and ``_merge_tokens_to_words`` equal to JAX's;
- ``forward(attn_probs_layer=)`` and ``forward_with_attn``: probs at atol
  1e-5, logits at atol 1e-4 (f32 sums in another order);
- ``traced_generate``: words equal; attention, entropy and logprob at rtol
  1e-4 / atol 1e-5;
- DRAGIN's ``modifier`` and ``keep_real_words`` on JAX's hand traces;
- DRAGIN, FLARE, fix-length, fix-sentence and the LLM classifier gate:
  answer text and ``BaselineCounter`` equal to JAX's, with every query
  searched having distinct top-k scores (ids are comparable only without
  ties). JAX runs each method once, in a module-scope fixture.
"""

import dataclasses
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.data.corpus import DocStore
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu.pipeline import baselines as jb
from probing_rag_tpu.retrieval.bm25 import BM25Engine as JaxBM25Engine
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.pipeline import baselines as tb
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# tests/test_baselines.py's corpus with distinct doc lengths: the two
# capital sentences of one length would tie on "capital"
CORPUS = [
    "paris is the capital of france",
    "berlin is the capital city of germany",
    "george washington was the first president of the united states",
]
QUESTIONS = ["capital of france?", "who was the first president?"]
DEMO = "demo\n"
BC = dict(generate_max_length=16, max_rounds=2)
# (class name, BaselineConfig fields, constructor keywords): the configs
# of tests/test_baselines.py, which make DRAGIN flag hallucinations and
# FLARE find its sentences unconfident, so both retrieve
METHODS = {
    "dragin": ("DraginRAG", dict(hallucination_threshold=0.5), {}),
    "flare": ("FlareRAG", dict(flare_threshold=0.99), {}),
    "fix-length": ("FixLengthRAG", {}, dict(method="fix-length-retrieval")),
    "fix-sentence": ("FixLengthRAG", {}, dict(method="fix-sentence")),
}


class WordTokenizer:
    """Whole words as tokens, so that a random model's generations are
    words that re-enter retrieval: ids 3.. are the corpus's words, then
    "w<id>" words, every fifth of them ending a sentence. Encoding is the
    inverse for those words; any other word hashes into the upper ids."""

    vocab_size, bos_id, eos_id, pad_id = 512, 1, 2, 2

    def __init__(self):
        corpus_words = sorted({w for doc in CORPUS for w in doc.split()})
        self.words = ["", "", ""] + corpus_words + [
            f"w{i}." if i % 5 == 0 else f"w{i}" for i in range(3 + len(corpus_words), 512)]
        self.ids = {w: i for i, w in enumerate(self.words) if w}

    def encode(self, text, add_bos=False):
        ids = [self.ids.get(w, 3 + len(CORPUS) + zlib.crc32(w.encode()) % 400)
               for w in text.split()]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids):
        return "".join(" " + self.words[i] for i in ids if i >= 3)


TOKENIZERS = {"byte": lambda: ByteTokenizer(512), "word": WordTokenizer}
JAX_TOKENIZERS = {"byte": lambda: JaxByteTokenizer(512), "word": WordTokenizer}


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
    lm = numpy_params(jcfg, seed=0)
    bm = dict(stem=False, remove_stopwords=False)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jlm=to_jax(lm), tlm=lm_params_from_jax(lm, tcfg, device="cpu"),
        jidx=JaxBM25Index.build(CORPUS, JaxBM25Config(**bm)),
        tidx=BM25Index.build(CORPUS, BM25Config(**bm)),
        store=DocStore.from_texts(CORPUS),
    )


def make(module, setup, method, tokenizer, engine):
    cls, fields, kw = METHODS[method]
    side = "j" if module is jb else "t"
    tok = (JAX_TOKENIZERS if module is jb else TOKENIZERS)[tokenizer]()
    return getattr(module, cls)(setup[side + "lm"], setup[side + "cfg"], tok, engine,
                                setup["store"], module.BaselineConfig(**BC, **fields), **kw)


def run_method(module, setup, method, tokenizer, engine):
    """Each question through a fresh instance: (answers, counters)."""
    answers, counters = [], []
    for q in QUESTIONS:
        rag = make(module, setup, method, tokenizer, engine)
        answers.append(rag.inference(q, DEMO, f"Question: {q}"))
        counters.append(dataclasses.asdict(rag.counter))
    return answers, counters


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Each (method, tokenizer)'s JAX run, made once: the JAX runs compile
    a decode program per prompt length."""
    engine = JaxBM25Engine(setup["jidx"])
    return {(m, tk): run_method(jb, setup, m, tk, engine) for m in METHODS for tk in TOKENIZERS}


@pytest.mark.parametrize("text", [
    "One. Two! Three? Four", "", "no punctuation at all", "Dr. Who went home.  Twice!\nNew line?",
    "ends with space. ", "...", "a.b.c",
])
def test_sentencize_matches_jax(text):
    assert tb.sentencize(text) == jb.sentencize(text)


def test_content_words_match_jax_on_the_golden_sentences():
    golden = json.loads((FIXTURES / "pos_content_golden.json").read_text())["sentences"]
    texts = [s["text"] for s in golden] + [
        "The quick brown fox ran over 42 bridges",
        "Italy sent the family a monthly supply in July",
    ]
    for text in texts:
        assert tb.content_words(text) == jb.content_words(text), text


@pytest.mark.parametrize("tokens", [
    ["Hel", "lo", " wor", "ld", "\nnew"], list("ab cd"), [" a", "b ", "c", "\n", "d"], [],
    ["", " x", "", "y"],
])
def test_merge_tokens_to_words_matches_jax(tokens):
    assert tb._merge_tokens_to_words(tokens) == jb._merge_tokens_to_words(tokens)


@pytest.mark.parametrize("layer", [0, 2, -1])
def test_forward_attn_probs_layer_matches_jax(setup, layer):
    """The fourth value of ``forward(attn_probs_layer=)``: one layer's f32
    softmax [B, H, T, S], with a masked pad key; without the argument the
    forward still returns three values."""
    s = setup
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 9)).astype(np.int32)
    valid = np.ones((2, 9), bool)
    valid[1, 4] = False
    jl, _, _, jp = jg.forward(s["jlm"], jnp.asarray(tokens), s["jcfg"],
                              attn_valid=jnp.asarray(valid), attn_probs_layer=layer)
    tt = torch.from_numpy(tokens).long()
    out = tg.forward(s["tlm"], tt, s["tcfg"], attn_valid=torch.from_numpy(valid),
                     attn_probs_layer=layer)
    assert len(out) == 4 and len(tg.forward(s["tlm"], tt, s["tcfg"])) == 3
    tl, _, _, tp = out
    assert tp.dtype == torch.float32 and tuple(tp.shape) == (2, s["tcfg"].n_heads, 9, 9)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_forward_with_attn_matches_jax(setup):
    s = setup
    ids = JaxByteTokenizer(512).encode("hello world")
    jl, _, _, jp = jb.forward_with_attn(s["jlm"], jnp.asarray([ids], jnp.int32),
                                        jnp.ones((1, len(ids)), bool), s["jcfg"])
    tl, _, _, tp = tb.forward_with_attn(s["tlm"], torch.tensor([ids]),
                                        torch.ones((1, len(ids)), dtype=torch.bool), s["tcfg"])
    p = tp[0].numpy()
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    assert np.triu(p, 1).max() == 0.0  # causal: nothing above the diagonal
    np.testing.assert_allclose(p, np.asarray(jp[0]), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("tokenizer,prompt,n,solver", [
    ("byte", "demo\nQuestion: capital of france?", 16, "max"),
    ("byte", "capital of france?", 7, "sum"),
    ("word", "Question: who?\nAnswer:", 16, "max"),
    ("word", "demo\nQuestion: capital of france?", 12, "sum"),
])
def test_traced_generate_matches_jax(setup, tokenizer, prompt, n, solver):
    s = setup
    want = jb.traced_generate(s["jlm"], s["jcfg"], JAX_TOKENIZERS[tokenizer](), prompt, n, solver)
    got = tb.traced_generate(s["tlm"], s["tcfg"], TOKENIZERS[tokenizer](), prompt, n, solver)
    assert want.words, "the tiny LM generated no word; pick another prompt"
    assert got.text == want.text and got.words == want.words
    for name in ("word_attn", "word_entropy", "word_logprob"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# tests/test_baselines.py's hand traces: (BaselineConfig fields, trace)
HAND_TRACES = [
    (dict(hallucination_threshold=0.0), dict(
        text="alpha beta gamma. delta epsilon.",
        words=["alpha", "beta", "gamma.", "delta", "epsilon."],
        word_attn=[0.1, 0.5, 0.4, 0.3, 0.7], word_entropy=[1.0, 2.0, 1.5, 0.5, 0.1],
        word_logprob=[-1.0] * 5)),
    (dict(hallucination_threshold=1e9), dict(
        text="alpha beta.", words=["alpha", "beta."], word_attn=[0.5, 0.5],
        word_entropy=[1.0, 1.0], word_logprob=[-1.0, -1.0])),
    (dict(hallucination_threshold=0.5, check_real_words=False), dict(
        text="alpha  beta. gamma delta. epsilon zeta.",
        words=["alpha", "beta.", "gamma", "delta.", "epsilon", "zeta."],
        word_attn=[0.1, 10.0, 0.1, 0.1, 0.1, 0.1], word_entropy=[0.1, 10.0, 0.1, 0.1, 0.1, 0.1],
        word_logprob=[-1.0] * 6)),
    (dict(hallucination_threshold=0.0, check_real_words=False), dict(
        text="Hello world! Next one.", words=["Hello", "world!", "Next", "one."],
        word_attn=[0.5] * 4, word_entropy=[2.0, 2.0, 0.1, 0.1], word_logprob=[-1.0] * 4)),
    (dict(hallucination_threshold=0.5), dict(
        text="The capital is paris. It sits in france.",
        words=["The", "capital", "is", "paris.", "It", "sits", "in", "france."],
        word_attn=[0.1, 0.9, 0.1, 0.8, 0.1, 0.2, 0.1, 0.9],
        word_entropy=[0.5, 3.0, 0.5, 2.5, 0.5, 0.5, 0.5, 3.0], word_logprob=[-1.0] * 8)),
]


def dragin_pair(setup, fields):
    bc = dict(BC, **fields)
    j = jb.DraginRAG(setup["jlm"], setup["jcfg"], JaxByteTokenizer(512), None, setup["store"],
                     jb.BaselineConfig(**bc))
    t = tb.DraginRAG(setup["tlm"], setup["tcfg"], ByteTokenizer(512), None, setup["store"],
                     tb.BaselineConfig(**bc))
    return j, t


@pytest.mark.parametrize("case", range(len(HAND_TRACES)))
def test_dragin_modifier_matches_jax(setup, case):
    fields, trace = HAND_TRACES[case]
    j, t = dragin_pair(setup, fields)
    want = j.modifier(jb.GenerationTrace(**trace))
    assert t.modifier(tb.GenerationTrace(**trace)) == want
    if case in (0, 2, 3):  # tests/test_baselines.py's expectations still hold
        assert want[0] is True


@pytest.mark.parametrize("prev,curr,hits", [
    ("capital of france? paris is", ["the", "capital", "city."], [0, 1, 1]),
    ("who was the first president?", ["george", "washington", "was", "first."], [1, 1, 0, 1]),
    ("", ["alpha", "beta"], [0, 0]),
    ("  ", [], []),
])
def test_keep_real_words_matches_jax(setup, prev, curr, hits):
    j, t = dragin_pair(setup, dict(retrieve_keep_top_k=3))
    assert t.keep_real_words(prev, curr, hits) == j.keep_real_words(prev, curr, hits)


def assert_no_ties(setup, queries):
    """Every query searched has distinct nonzero top-k scores."""
    analyzer = setup["tidx"].config.analyzer()
    for q in queries:
        top = np.sort(setup["tidx"].score_all(setup["tidx"].encode_query(analyzer(q))))[::-1][:5]
        top = top[top > 0]
        assert (np.abs(np.diff(top)) > 1e-4).all(), (q, top)


@pytest.mark.parametrize("tokenizer", list(TOKENIZERS))
@pytest.mark.parametrize("method", list(METHODS))
def test_baseline_matches_jax(setup, jax_runs, method, tokenizer):
    engine = RecordingEngine(BM25Engine(setup["tidx"], device="cpu"))
    answers, counters = run_method(tb, setup, method, tokenizer, engine)
    assert_no_ties(setup, engine.queries)
    want_answers, want_counters = jax_runs[method, tokenizer]
    assert answers == want_answers
    assert counters == want_counters
    assert sum(c["retrieve"] for c in counters) >= 1
    if method == "dragin":
        assert sum(c["hallucinated"] for c in counters) >= 1


def test_llm_classifier_gate_matches_jax(setup):
    s = setup
    questions = ["Can you answer this?", "Another question?", "capital of france?"]
    want = jb.LLMClassifierGate(s["jlm"], s["jcfg"], JaxByteTokenizer(512),
                                max_new_tokens=2).needs_retrieval(questions)
    got = tb.LLMClassifierGate(s["tlm"], s["tcfg"], ByteTokenizer(512),
                               max_new_tokens=2).needs_retrieval(questions)
    assert got == want and len(got) == 3 and all(isinstance(b, bool) for b in got)
