"""The port's Porter stemmer (probing_rag_tpu_torch.retrieval.porter)
against NLTK's ``PorterStemmer``, in NLTK's default mode and in Porter's
original algorithm, and the port's ``Analyzer`` against the JAX package's.

Stems must be equal string for string: over the committed golden
(``tests/fixtures/porter_stems.json``, written by
``tests/fixtures/make_porter_fixture.py``), over 6,000 words generated from
a seed with numpy, and through both analyzers over the fixture corpora."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
from nltk.stem import PorterStemmer as NltkPorter

from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu.retrieval.text import Analyzer as JaxAnalyzer
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.retrieval.porter import MODES, PorterStemmer
from probing_rag_tpu_torch.retrieval.text import Analyzer

FIXTURES = Path(__file__).resolve().parent / "fixtures"
GOLDEN = json.loads((FIXTURES / "porter_stems.json").read_text())["stems"]
NLTK_MODE = {"nltk": NltkPorter.NLTK_EXTENSIONS, "original": NltkPorter.ORIGINAL_ALGORITHM}

# every suffix the rules of steps 1-5 look at, and endings that reach their
# conditions (double consonants, y after a vowel or a consonant, cvc)
SUFFIXES = """s es ies sses ss eed ed ied ing ings ating bling izing y ly ily ally
ational tional enci anci izer abli bli alli entli eli ousli ization ation ator alism
iveness fulness ousness aliti iviti biliti fulli logi icate ative alize iciti ical ful
ness al ance ence er ic able ible ant ement ment ent sion tion ou ism ate iti ous ive
ize e ll ell ied ying oy ay ey""".split()
ONSETS = "b c d f g h j k l m n p qu r s t v w x y z br ch cl cr dr fl gr pl pr sh st str th tr wh".split()
NUCLEI = "a e i o u y ai ea ee ie oo ou oy ay".split()
CODAS = ["", "", "b", "d", "g", "l", "ll", "m", "n", "nn", "p", "pp", "r", "s", "ss", "t",
         "tt", "v", "w", "x", "y", "z", "zz", "ng", "ck", "rt", "st"]
N_GENERATED, CHUNK = 6000, 1000


def generated_words():
    """Seeded words: one to three syllables, then none to two suffixes;
    a tenth of them random letter strings."""
    rng = np.random.default_rng(20)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = []
    while len(words) < N_GENERATED:
        if rng.random() < 0.1:
            w = "".join(rng.choice(letters, rng.integers(1, 12)))
        else:
            w = "".join(str(rng.choice(ONSETS)) * (rng.random() < 0.8) + str(rng.choice(NUCLEI))
                        + str(rng.choice(CODAS)) for _ in range(rng.integers(1, 4)))
            w += "".join(str(rng.choice(SUFFIXES)) for _ in range(rng.integers(0, 3)))
        words.append(w)
    return words


GENERATED = generated_words()


@pytest.mark.parametrize("mode", MODES)
def test_port_matches_golden(mode):
    col = MODES.index(mode)
    stemmer = PorterStemmer(mode)
    bad = [(w, s[col], stemmer.stem(w)) for w, s in GOLDEN.items() if stemmer.stem(w) != s[col]]
    assert not bad, bad[:20]


@pytest.mark.parametrize("mode", MODES)
def test_golden_matches_nltk(mode):
    col = MODES.index(mode)
    nltk = NltkPorter(mode=NLTK_MODE[mode])
    bad = [(w, s[col], nltk.stem(w)) for w, s in GOLDEN.items() if nltk.stem(w) != s[col]]
    assert not bad, bad[:20]
    assert len(GOLDEN) > 400
    assert set(NltkPorter().pool) <= set(GOLDEN)


@pytest.mark.parametrize("chunk", range(N_GENERATED // CHUNK))
@pytest.mark.parametrize("mode", MODES)
def test_generated_words_match_nltk(mode, chunk):
    words = GENERATED[chunk * CHUNK:(chunk + 1) * CHUNK]
    nltk, port = NltkPorter(mode=NLTK_MODE[mode]), PorterStemmer(mode)
    bad = [(w, nltk.stem(w), port.stem(w)) for w in words if nltk.stem(w) != port.stem(w)]
    assert not bad, bad[:20]


def test_generated_words_reach_the_rules():
    """The generated list changes most words and holds every suffix."""
    port = PorterStemmer("nltk")
    assert len(set(GENERATED)) > 5000
    assert sum(port.stem(w) != w for w in GENERATED) > N_GENERATED // 2
    for suffix in SUFFIXES:
        assert any(w.endswith(suffix) for w in GENERATED), suffix


def corpora():
    """The fixture corpora, each a list of texts."""
    qa = (FIXTURES / "retr_qa_cot.txt").read_text().splitlines()
    pos = json.loads((FIXTURES / "pos_content_golden.json").read_text())
    sentences = [v for v in re.findall(r'"([^"]{20,})"', json.dumps(pos))]
    return {"retr_qa_cot": qa, "pos_content_golden": sentences,
            "generated": [" ".join(GENERATED[i:i + 40]) for i in range(0, 2000, 40)]}


@pytest.mark.parametrize("corpus", ["retr_qa_cot", "pos_content_golden", "generated"])
@pytest.mark.parametrize("mode", MODES)
def test_analyzers_agree(corpus, mode):
    texts = corpora()[corpus]
    assert len(texts) > 10
    jax_a, port_a = JaxAnalyzer(stemmer_mode=mode), Analyzer(stemmer_mode=mode)
    for text in texts:
        assert port_a(text) == jax_a(text), text


def test_default_index_equals_jax():
    """The default BM25Config stems: the port's index over the QA fixture
    equals the JAX package's, vocabulary and postings."""
    texts = corpora()["retr_qa_cot"]
    assert BM25Config().stem and JaxBM25Config().stem
    port, ref = BM25Index.build(texts), JaxBM25Index.build(texts)
    assert port.vocab == ref.vocab
    np.testing.assert_array_equal(port.term_offsets, ref.term_offsets)
    np.testing.assert_array_equal(port.postings_doc, ref.postings_doc)
    np.testing.assert_allclose(port.postings_impact, ref.postings_impact, rtol=1e-6)


def test_short_words_case_and_modes():
    nltk_mode, original = PorterStemmer("nltk"), PorterStemmer("original")
    assert nltk_mode.stem("Running") == "run" == original.stem("RUNNING")
    assert nltk_mode.stem("as") == "as" and original.stem("as") == "a"
    assert nltk_mode.stem("dying") == "die" and original.stem("dying") == "dy"
    with pytest.raises(ValueError):
        PorterStemmer("martin")
