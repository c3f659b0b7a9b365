"""The synthetic English keeps the promises the plain BM25 reference rests
on, checked against the program's own analyzer: stopwords are the
program's, every content word and every piece run survives stemming, no
template word is read otherwise by the reference; and the stand-in tokenizer
round-trips the texts at ~1.3 pieces a word."""

import re

import numpy as np
import pytest

from benchmark.lib.tokenizer import StandInTokenizer
from benchmark.lib.words import STOPWORDS, SYLLABLES, Vocabulary
from probing_rag_tpu_torch.data import prompts
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config
from probing_rag_tpu_torch.retrieval.text import ENGLISH_STOPWORDS

VOCAB = Vocabulary.make(30000, 1.1, 7, 4000)  # the cells' words
TEMPLATES = [prompts.cot_prompt(""), prompts.retr_qa_cot2("", prompts.format_evidences([""] * 5))]


def test_stopwords_are_the_programs():
    assert set(STOPWORDS) == {w for w in ENGLISH_STOPWORDS if "'" not in w}
    assert VOCAB.words[: VOCAB.n_stop] == STOPWORDS


def test_analysis_leaves_content_words_and_piece_runs_as_they_are():
    analyze = BM25Config().analyzer()
    content = VOCAB.words[VOCAB.n_stop:]
    assert analyze(" ".join(content)) == list(content)
    rng = np.random.default_rng(0)
    tok = StandInTokenizer(VOCAB, 32000, 275, TEMPLATES)
    strings = tok.token_strings()
    runs = ["".join(strings[i] for i in rng.integers(tok.n_pieces - 3000, 32000, 5)).strip()
            for _ in range(200)]
    for run in runs:  # whatever the model emits, content-made words stem to themselves
        for word in run.lower().split():
            if word.isalpha() and word[-1] in "ao":
                assert analyze(word) in ([word], [])


def test_template_words_analyze_as_the_reference_reads_them():
    """The reference keeps a token when it is a content word; the program
    keeps its stem when that is a term. They agree on every template word."""
    analyze = BM25Config().analyzer()
    content = set(VOCAB.words[VOCAB.n_stop:])
    for text in TEMPLATES:
        for token in re.findall(r"\w+", text.lower()):
            stem = analyze(token)
            assert (stem == [token]) if token in content else not set(stem) & content, token


def test_every_syllable_ends_where_no_suffix_rule_cuts():
    assert all(s[-1] in "ao" for s in SYLLABLES)


@pytest.mark.parametrize("vocab_size", [32000, 30522])
def test_tokenizer_round_trip_and_rate(vocab_size):
    tok = StandInTokenizer(VOCAB, vocab_size, 275, TEMPLATES)
    assert len(tok.token_strings()) == vocab_size
    rng = np.random.default_rng(1)
    ranks = VOCAB.draw(rng, (2000, 100))
    texts = VOCAB.render(ranks, [100] * 2000)
    assert all(t.split() == [VOCAB.words[i] for i in r] for t, r in zip(texts[:20], ranks[:20]))
    ids = [tok.encode(t) for t in texts]
    assert all(max(i) < vocab_size for i in ids)
    assert [tok.decode(i) for i in ids[:50]] == [" " + t for t in texts[:50]]
    assert 1.25 < sum(map(len, ids)) / ranks.size < 1.35
    for text in TEMPLATES:
        assert tok.decode(tok.encode(text)) == text
