"""The port's "dma" BM25 engine mode (probing_rag_tpu_torch) against the JAX
package on the CPU: ``align_csr`` arrays equal to JAX's element for
element, ``bm25_search_padded_fused`` (plain versions of the aligned gather,
the sort and the segment top-k) against the JAX chain with its Pallas
kernels in interpret mode, and the engine against ``BM25Engine(mode="dma")``
(interpret mode) and the exact f64 ``score_all`` oracle, including repeated
terms (not deduplicated) and a row trimmed by aligned lengths.

Tolerances: scores within abs 5e-4 / rel 1e-4 of the oracle (f32 run sums;
abs 1e-3 for rows of heavy terms); against JAX scores within 1e-4 and ids
compared where the scores are distinct, because tie order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops.pallas_sparse import bm25_search_padded_fused as jax_fused
from probing_rag_tpu.retrieval import bm25 as jbm25
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu.retrieval.bm25_index import align_csr as jax_align_csr
from probing_rag_tpu_torch.ops.sort import MAX_SORT_WIDTH
from probing_rag_tpu_torch.ops.sparse import bm25_search_padded_fused
from probing_rag_tpu_torch.retrieval import bm25 as tbm25
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index, align_csr

torch.set_num_threads(1)

CFG = dict(stem=False, remove_stopwords=False)


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(5)
    docs = [[f"t{t}" for t in rng.zipf(1.2, rng.integers(3, 30)) % 400] for _ in range(3000)]
    return (BM25Index.build_tokenized(docs, BM25Config(**CFG)),
            JaxBM25Index.build_tokenized(docs, JaxBM25Config(**CFG)), rng)


def assert_matches_oracle(idx, qids, res, atol=5e-4):
    for i, ids in enumerate(qids):
        got = res.scores[i][res.doc_indices[i] >= 0]
        if len(ids) == 0:
            assert len(got) == 0
            continue
        oracle = idx.score_all(ids)
        assert len(got) == min(res.scores.shape[1], int((oracle > 0).sum()))
        np.testing.assert_allclose(np.sort(got)[::-1], np.sort(oracle)[::-1][: len(got)],
                                   rtol=1e-4, atol=atol)
        for d, s in zip(res.doc_indices[i], res.scores[i]):
            if d >= 0:
                assert oracle[d] == pytest.approx(s, rel=1e-4, abs=atol)


def assert_same_topk(scores, docs, jscores, jdocs):
    """Scores allclose; ids equal where the score is distinct in its row."""
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-4)
    for r in range(scores.shape[0]):
        for j in range(scores.shape[1]):
            if (np.abs(jscores[r] - jscores[r, j]) <= 1e-4).sum() == 1:
                assert docs[r, j] == jdocs[r, j], (r, j)


@pytest.mark.parametrize("alignment,guard", [(1024, 4096), (128, 0), (8, 16)])
def test_align_csr_equals_jax(indexes, alignment, guard):
    idx, jidx, _ = indexes
    got = align_csr(idx.term_offsets, idx.postings_doc, idx.postings_impact,
                    sentinel=idx.n_docs, alignment=alignment, guard=guard)
    want = jax_align_csr(jidx.term_offsets, jidx.postings_doc, jidx.postings_impact,
                         sentinel=jidx.n_docs, alignment=alignment, guard=guard)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(idx.aligned_csr(), jidx.aligned_csr()):
        np.testing.assert_array_equal(a, b)


def test_padded_fused_matches_jax_chain(indexes):
    """The port's chain on the aligned CSR (plain versions) against JAX's
    (Pallas gather and segment kernels in interpret mode, XLA sort), with
    masked terms, a repeated term and an empty row."""
    idx, jidx, rng = indexes
    offsets, doc, imp = idx.aligned_csr()
    lens = offsets[1:] - offsets[:-1]
    qterms = rng.integers(0, idx.n_terms, (8, 4)).astype(np.int32)
    qmask = rng.random((8, 4)) < 0.8
    qterms[1, :2] = qterms[1, 2]  # a repeated term, gathered each time
    qmask[1, :3] = True
    qmask[5] = False  # an empty row
    pad = 1 << int(np.ceil(np.log2(max(int(np.where(qmask, lens[qterms], 0).sum(1).max()),
                                       1024))))
    kw = dict(pad=pad, k=5)
    js, jd = jax_fused(jnp.asarray(offsets), jnp.asarray(doc), jnp.asarray(imp),
                       jnp.asarray(qterms), jnp.asarray(qmask), sentinel_doc=idx.n_docs,
                       interpret=True, guarded=True, **kw)
    ts, td = bm25_search_padded_fused(
        torch.from_numpy(offsets), torch.from_numpy(doc), torch.from_numpy(imp),
        torch.from_numpy(qterms), torch.from_numpy(qmask), sentinel=idx.n_docs, **kw)
    assert_same_topk(ts.numpy(), td.numpy(), np.asarray(js), np.asarray(jd))
    assert (td[5] == -1).all() and (ts[5] == 0).all()


def test_dma_engine_matches_jax_and_oracle(indexes):
    """``mode="dma"`` against JAX ``mode="dma"`` and the oracle: a stream
    of mixed queries, repeated terms (each occurrence gathered), heavy
    terms and an empty query; ``search_stream`` gives the same results."""
    idx, jidx, rng = indexes
    lens = idx.term_offsets[1:] - idx.term_offsets[:-1]
    heavy = np.argsort(lens)[-3:].astype(np.int32)
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 6)) % 400])
            for _ in range(9)]
    qids += [np.concatenate([heavy, heavy[:1]]), np.asarray([7, 7, 7, 9], np.int32),
             np.zeros(0, np.int32)]
    eng = tbm25.BM25Engine(idx, device="cpu", mode="dma", q_tile=4)
    res = eng.search_term_ids(qids, k=5)
    assert eng.last_stats == {"n_queries": len(qids), "n_fallback": 0, "n_trimmed": 0}
    assert sum(eng.last_widths["dma"].values()) == len(qids)
    jeng = jbm25.BM25Engine(jidx, mode="dma", q_tile=4)
    assert jeng.use_pallas  # the JAX engine runs its Pallas gather, not XLA
    jres = jeng.search_term_ids(qids, k=5)
    assert_same_topk(res.scores, res.doc_indices, jres.scores, jres.doc_indices)
    assert_matches_oracle(idx, qids, res, atol=1e-3)
    stream = eng.search_stream(qids, k=5)
    assert_same_topk(stream.scores, stream.doc_indices, res.scores, res.doc_indices)
    one = eng.search_term_ids(qids[-3:-2], k=5)  # a heavy query alone
    assert_same_topk(one.scores, one.doc_indices, res.scores[-3:-2], res.doc_indices[-3:-2])


def test_dma_trims_by_aligned_lengths():
    """A row over ``max_pad`` keeps its most selective terms by ALIGNED
    length, as the JAX dma mode does; trimming by real lengths would keep
    another set. Equal to JAX and to the oracle over the kept terms."""
    n_docs = 3000
    docs = [["a"] * (i < 1025) + ["b"] * (i % 3 == 0 and i < 3000) + ["c"] * (i < 10)
            + [f"f{i % 37}"] for i in range(n_docs)]
    idx = BM25Index.build_tokenized(docs, BM25Config(**CFG))
    jidx = JaxBM25Index.build_tokenized(docs, JaxBM25Config(**CFG))
    q = idx.encode_query(["a", "b", "c"])
    real = (idx.term_offsets[1:] - idx.term_offsets[:-1]).astype(np.int64)
    offsets, _, _ = idx.aligned_csr()
    aligned = (offsets[1:] - offsets[:-1]).astype(np.int64)
    cap = 2100
    kept, _, _, trimmed = tbm25.trim_to_cap(aligned, q.astype(np.int64), cap)
    kept_real, *_ = tbm25.trim_to_cap(real, q.astype(np.int64), cap)
    assert trimmed and sorted(kept) != sorted(kept_real)
    eng = tbm25.BM25Engine(idx, device="cpu", mode="dma", max_pad=cap)
    res = eng.search_term_ids([q, q[2:]], k=5)
    assert eng.last_stats == {"n_queries": 2, "n_fallback": 0, "n_trimmed": 1}
    jres = jbm25.BM25Engine(jidx, mode="dma", max_pad=cap, q_tile=4).search_term_ids(
        [q, q[2:]], k=5)
    assert_same_topk(res.scores, res.doc_indices, jres.scores, jres.doc_indices)
    assert_matches_oracle(idx, [kept, q[2:]], res)


def test_engine_modes_and_caps(indexes):
    idx, _, _ = indexes
    with pytest.raises(ValueError, match="not ported"):
        tbm25.BM25Engine(idx, device="cpu", mode="xla")
    with pytest.raises(ValueError, match="unknown"):
        tbm25.BM25Engine(idx, device="cpu", mode="fast")
    with pytest.raises(ValueError):
        tbm25.BM25Engine(idx, device="cpu", max_pad=2 * MAX_SORT_WIDTH)
    with pytest.raises(ValueError):
        tbm25.BM25Engine(idx, device="cpu", mode="dma", max_pad=MAX_SORT_WIDTH)
    eng = tbm25.BM25Engine(idx, device="cpu")
    assert (eng.mode, eng.max_pad) == ("bitonic", tbm25.BITONIC_MAX_PAD)
    eng = tbm25.BM25Engine(idx, device="cpu", mode="dma")
    assert eng.max_pad == tbm25.DMA_MAX_PAD
