"""The port's native C++ index builder (probing_rag_tpu_torch.native) against
the JAX package: ``build_native`` equal to the JAX ``BM25Index.build`` and
to its own ``build_native`` on an original-mode config (vocab, offsets,
docs, doc lengths equal; impacts within rel 1e-6, the rounding of one f64
expression cast to f32), unicode and empty documents, the ``QueryEncoder``
equal to the analyzer path and driving the port's ``BM25Engine`` on the
CPU, the stemmer equal to the port's Python Porter stemmer, and the
library built from the port's own ``indexer.cpp``."""

import numpy as np
import pytest
import torch

from probing_rag_tpu import native as jnative
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu_torch import native
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.retrieval.porter import PorterStemmer

torch.set_num_threads(1)

CORPUS = [
    "The quick brown foxes are jumping over the lazy dogs",
    "A meeting about traditional references and rational decisions",
    "Dogs and foxes running quickly through fields",
    "",
    "capital capital capital of france",
    "Retrieval-augmented generation: relational conditional hopefulness!",
]
STEMMED = [
    "caresses", "flies", "dies", "mules", "denied", "agreed", "humbled", "sized",
    "meeting", "itemization", "sensational", "traditional", "reference", "colonizer",
    "plotted", "relational", "conditional", "rational", "valenci", "digitizer",
    "radicalli", "differentli", "vietnamization", "predication", "feudalism",
    "decisiveness", "hopefulness", "callousness", "formaliti", "sensibiliti",
    "triplicate", "formalize", "electrical", "goodness", "allowance", "airliner",
    "adjustable", "replacement", "adoption", "communism", "activate", "bowdlerize",
]


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no C++ toolchain for the native indexer")
    return native.library()


def assert_index_equal(a, b, *, impact_rtol=1e-6):
    assert a.vocab == b.vocab and a.doc_ids == b.doc_ids
    for name in ("term_offsets", "postings_doc", "doc_lens"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    np.testing.assert_allclose(a.postings_impact, b.postings_impact, rtol=impact_rtol)


@pytest.mark.parametrize("cfg", [dict(stemmer_mode="original"),
                                 dict(stemmer_mode="original", variant="lucene"),
                                 dict(stem=False, remove_stopwords=False, lowercase=False)],
                         ids=["original", "lucene", "plain"])
def test_native_build_equals_jax_build(lib, cfg):
    got = BM25Index.build_native(CORPUS, BM25Config(**cfg))
    assert_index_equal(got, JaxBM25Index.build(CORPUS, JaxBM25Config(**cfg)))
    assert_index_equal(got, BM25Index.build(CORPUS, BM25Config(**cfg)))


def test_native_build_equals_jax_build_native(lib):
    if not jnative.available():
        pytest.skip("the JAX package's native indexer does not build here")
    rng = np.random.default_rng(3)
    words = STEMMED + ["the", "and", "Paris", "FRANCE", "x1", "snake_case"]
    texts = [" ".join(rng.choice(words, size=rng.integers(0, 25))) for _ in range(300)]
    cfg = dict(stemmer_mode="original")
    assert_index_equal(BM25Index.build_native(texts, BM25Config(**cfg)),
                       JaxBM25Index.build_native(texts, JaxBM25Config(**cfg)), impact_rtol=0)


def test_native_build_unicode_and_empty(lib):
    corpus = ["héllo wörld café", "", "plain ascii text", ""]
    idx = BM25Index.build_native(corpus)
    assert idx.n_docs == 4 and idx.config.stemmer_mode == "original"
    assert idx.doc_lens[1] == 0 and idx.doc_lens[3] == 0
    assert_index_equal(idx, JaxBM25Index.build(corpus, JaxBM25Config(stemmer_mode="original")))
    empty = BM25Index.build_native([])
    assert empty.n_docs == 0 and empty.n_terms == 0


def test_native_build_refuses_nltk_mode(lib):
    with pytest.raises(ValueError, match="original"):
        BM25Index.build_native(CORPUS, BM25Config(stemmer_mode="nltk"))
    # without stemming the mode does not matter
    BM25Index.build_native(CORPUS, BM25Config(stemmer_mode="nltk", stem=False))


def test_native_stemmer_equals_python_original(lib):
    ps = PorterStemmer(mode="original")
    assert [native.porter_stem(w) for w in STEMMED] == [ps.stem(w) for w in STEMMED]
    assert [native.porter_stem(w) for w in STEMMED] == [jnative.porter_stem(w) for w in STEMMED]


def test_query_encoder_equals_analyzer_path(lib):
    cfg = BM25Config(stemmer_mode="original")
    index = BM25Index.build_native(CORPUS, cfg)
    enc = native.QueryEncoder(index.vocab)
    analyzer = cfg.analyzer()
    queries = ["quick foxes jumping", "what is the capital of France?",
               "nonexistent zzz terms only", "", "running running running",
               "héllo decisions"]
    for q, ids in zip(queries, enc.encode(queries)):
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, index.encode_query(analyzer(q)), err_msg=repr(q))
    assert enc.encode([]) == []
    enc.close()


def test_query_encoder_drives_engine(lib):
    texts = ["paris capital france", "berlin capital germany", "nile river africa",
             "capital gains tax", "france wine region"]
    index = BM25Index.build_native(texts)
    engine = BM25Engine(index, device="cpu")
    enc = native.QueryEncoder(index.vocab)
    queries = ["capital of france", "river", "capital capital germany", "zzz"]
    got = engine.search_term_ids(enc.encode(queries), k=3)
    ref = engine.search(queries, k=3)
    np.testing.assert_array_equal(got.doc_indices, ref.doc_indices)
    np.testing.assert_array_equal(got.scores, ref.scores)
    assert got.doc_indices[0, 0] == 0 and got.doc_indices[1, 0] == 2
    assert (got.doc_indices[3] == -1).all()
    for i, q in enumerate(queries):  # against the exact host oracle
        oracle = index.score_all(enc.encode([q])[0])
        hits = got.doc_indices[i] >= 0
        np.testing.assert_allclose(got.scores[i][hits], oracle[got.doc_indices[i][hits]], rtol=1e-6)


def test_library_is_built_from_the_ports_own_source(lib):
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.name.startswith("libindexer_")
    assert native.SRC.parent == so.parent.parent
    assert native.SRC.name == "indexer.cpp" and "probing_rag_tpu_torch" in native.SRC.parts
    # the C++ equals the JAX package's copy: only the header comment differs
    own, ref = native.SRC.read_text(), jnative._SRC.read_text()
    assert own[own.index("#include"):] == ref[ref.index("#include"):]
    assert lib._name == str(so)


def test_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "indexer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.build()
        with pytest.raises(RuntimeError):
            native.library()
        assert not native.available()
    finally:
        native.library.cache_clear()
