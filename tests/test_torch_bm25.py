"""The port's BM25 index and engine (probing_rag_tpu_torch.retrieval)
against the JAX package: equal index arrays and on-disk format, planner
helpers equal to the JAX ones, and search results against
``BM25Engine(mode="bitonic", interpret=True)``, ``mode="xla"`` and the
exact f64 ``score_all`` oracle.

Tolerances: scores within abs 5e-4 / rel 1e-4 of the f64 oracle (f32 run
sums, plus one extra rounding for a deduplicated term's weight, as
tests/test_bm25_bitonic.py allows); ids compared where scores are distinct,
because tie order differs between the engines."""

import numpy as np
import pytest
import torch

from probing_rag_tpu.retrieval import bm25 as jbm25
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu_torch.retrieval import bm25 as tbm25
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

torch.set_num_threads(1)

CFG = dict(stem=False, remove_stopwords=False)


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(11)
    docs = [[f"t{t}" for t in rng.zipf(1.2, rng.integers(3, 30)) % 400] for _ in range(3000)]
    return (BM25Index.build_tokenized(docs, BM25Config(**CFG)),
            JaxBM25Index.build_tokenized(docs, JaxBM25Config(**CFG)), rng)


def assert_index_equal(a, b):
    assert a.vocab == b.vocab and a.doc_ids == b.doc_ids
    for name in ("term_offsets", "postings_doc", "postings_impact", "doc_lens"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_builds_equal_jax():
    texts = ["The quick brown fox", "paris is the capital of france",
             "the eiffel tower is in paris", "water boils at 100 degrees"]
    for variant in ("okapi", "lucene"):
        assert_index_equal(BM25Index.build(texts, BM25Config(variant=variant, **CFG)),
                           JaxBM25Index.build(texts, JaxBM25Config(variant=variant, **CFG)))
    ids = np.asarray([3, 1, 3, 0, 2, 2, 5, 1, 0], np.int64)
    lens = np.asarray([4, 2, 3])
    assert_index_equal(BM25Index.build_tokenized_ids(ids, lens, BM25Config(**CFG)),
                       JaxBM25Index.build_tokenized_ids(ids, lens, JaxBM25Config(**CFG)))


def test_on_disk_format_round_trips_both_ways(indexes, tmp_path):
    idx, jidx, _ = indexes
    jidx.save(tmp_path / "jax")
    assert_index_equal(BM25Index.load(tmp_path / "jax"), jidx)
    idx.save(tmp_path / "torch")
    assert_index_equal(JaxBM25Index.load(tmp_path / "torch"), idx)
    assert BM25Index.load(tmp_path / "jax").config == idx.config


def test_planner_helpers_equal_jax(indexes):
    idx, jidx, rng = indexes
    lens = (idx.term_offsets[1:] - idx.term_offsets[:-1]).astype(np.int64)
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(0, 9)) % 400])
            for _ in range(30)]
    qids.append(np.asarray([5, 5, 7, 5], np.int32))
    tu, tw, tdup = tbm25._dedup_term_ids(qids)
    ju, jw, jdup = jbm25._dedup_term_ids(qids)
    assert tdup == jdup
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    for ids in qids:
        for cap in (0, 100, 1 << 20):
            t = tbm25.trim_to_cap(lens, np.asarray(ids, np.int64), cap)
            j = jbm25.trim_to_cap(lens, np.asarray(ids, np.int64), cap)
            np.testing.assert_array_equal(t[0], j[0])
            assert t[2:] == j[2:]
    teng = tbm25.BM25Engine(idx, device="cpu")
    jeng = jbm25.BM25Engine(jidx, mode="bitonic", interpret=True)
    tplan = teng._plan_bitonic(tu, tw)
    jplan = jeng._plan_bitonic(ju, jw)
    tq = tplan[0].shape[1]  # JAX pads the term axis to a power of two
    for a, b in zip(tplan, jplan):
        b = b[:, :tq] if b.ndim == 2 else b
        np.testing.assert_array_equal(a, b)
    slot, wt = tplan[2], tplan[6]
    np.testing.assert_array_equal(tbm25._weight_blocks(slot, wt, 1 << 14, 1024),
                                  jbm25._weight_blocks(slot, wt, 1 << 14, 1024))


def assert_matches_oracle(idx, qids, res, atol=5e-4):
    for i, ids in enumerate(qids):
        got = res.scores[i][res.doc_indices[i] >= 0]
        if len(ids) == 0:
            assert len(got) == 0
            continue
        oracle = idx.score_all(ids)
        assert len(got) == min(5, int((oracle > 0).sum()))
        np.testing.assert_allclose(np.sort(got)[::-1], np.sort(oracle)[::-1][: len(got)],
                                   rtol=1e-4, atol=atol)
        for d, s in zip(res.doc_indices[i], res.scores[i]):
            if d >= 0:
                assert oracle[d] == pytest.approx(s, rel=1e-4, abs=atol)


def assert_same_results(a, b):
    """Scores allclose; ids equal where the score is distinct in its row."""
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-4)
    for r in range(a.scores.shape[0]):
        for j in range(a.scores.shape[1]):
            if (np.abs(b.scores[r] - b.scores[r, j]) <= 1e-4).sum() == 1:
                assert a.doc_indices[r, j] == b.doc_indices[r, j], (r, j)


def test_search_matches_jax_bitonic_xla_and_oracle(indexes):
    idx, jidx, rng = indexes
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 6)) % 400])
            for _ in range(7)]
    qids.append(np.zeros(0, np.int32))  # empty query
    res = tbm25.BM25Engine(idx, device="cpu").search_term_ids(qids, k=5)
    assert_matches_oracle(idx, qids, res)
    jres = jbm25.BM25Engine(jidx, mode="bitonic", interpret=True).search_term_ids(qids, k=5)
    assert_same_results(res, jres)
    xres = jbm25.BM25Engine(jidx, mode="xla").search_term_ids(qids, k=5)
    assert_same_results(res, xres)


def test_overcap_duplicate_and_oov_queries(indexes, monkeypatch):
    idx, jidx, _ = indexes
    lens = idx.term_offsets[1:] - idx.term_offsets[:-1]
    order = np.argsort(lens)
    heavy = order[-3:].astype(np.int32)
    light = int(order[len(order) // 2])
    overcap = np.concatenate([heavy, [light]]).astype(np.int32)
    dup = np.asarray([heavy[0], heavy[0], light, light, light], np.int32)
    qids = [overcap, dup, np.asarray([light], np.int32)]
    eng = tbm25.BM25Engine(idx, device="cpu")
    res = eng.search_term_ids(qids, k=5)
    assert eng.last_stats == {"n_queries": 3, "n_fallback": 0, "n_trimmed": 0}
    assert_matches_oracle(idx, qids, res, atol=1e-3)
    # under a 2048-slot cap both engines route the same two rows to their
    # over-cap hybrid
    jeng = jbm25.BM25Engine(jidx, mode="bitonic", interpret=True, max_pad=2048)
    jres = jeng.search_term_ids(qids, k=5)
    assert jeng.last_stats["n_fallback"] == 2
    assert_same_results(res, jres)
    eng = tbm25.BM25Engine(idx, device="cpu", max_pad=2048)
    hres = eng.search_term_ids(qids, k=5)
    assert eng.last_stats == jeng.last_stats == {"n_queries": 3, "n_fallback": 2, "n_trimmed": 0}
    assert_same_results(hres, jres)
    jres = jbm25.BM25Engine(jidx, mode="xla").search_term_ids(qids, k=5)
    assert_same_results(res, jres)
    # a trimmed query keeps its most selective terms, as JAX does
    monkeypatch.setattr(tbm25, "FALLBACK_MAX_PAD", int(lens[heavy[0]]))
    eng = tbm25.BM25Engine(idx, device="cpu")
    res = eng.search_term_ids([overcap], k=5)
    assert eng.last_stats == {"n_queries": 1, "n_fallback": 0, "n_trimmed": 1}
    kept, *_ = jbm25.trim_to_cap(lens.astype(np.int64), overcap.astype(np.int64),
                                 int(lens[heavy[0]]))
    assert_matches_oracle(idx, [kept], res, atol=1e-3)
    # OOV text: no terms, every slot empty
    text = tbm25.BM25Engine(idx, device="cpu").search(["zzzqqq unknownword"], k=3)
    assert (text.doc_indices == -1).all() and (text.scores == 0).all()
    assert tbm25.BM25Engine(idx, device="cpu").retrieve("zzzqqq", k=3) == []
