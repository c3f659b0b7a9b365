"""The plain PyTorch versions of the port's BM25 kernels
(probing_rag_tpu_torch.ops) against the JAX Pallas kernels run in interpret
mode, the JAX XLA reference, and a numpy rebuild of the gather layout.

On the CPU the wrappers take the plain versions; the CUDA kernels are
compared with them on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops.pallas_sort import sort_pairs_pallas
from probing_rag_tpu.ops.pallas_sparse import segment_topk_pallas
from probing_rag_tpu.ops.sparse import sorted_segment_topk
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu_torch.ops.sort import sort_pairs, sort_pairs_plain
from probing_rag_tpu_torch.ops.sparse import (
    bm25_gather,
    bm25_search_bitonic,
    segment_topk,
    segment_topk_plain,
)
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine, _dedup_term_ids, _weight_blocks
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

torch.set_num_threads(1)


def lexsorted(keys, vals):
    keys, vals = np.asarray(keys), np.asarray(vals)
    out_k, out_v = np.empty_like(keys), np.empty_like(vals)
    for r in range(keys.shape[0]):
        o = np.lexsort((vals[r], keys[r]))
        out_k[r], out_v[r] = keys[r][o], vals[r][o]
    return out_k, out_v


def alternating_blocks(keys, vals, block):
    """Each ``block`` sorted, ascending at even block index, descending at
    odd: the k_start = 2 * block precondition."""
    q, p = keys.shape
    kb, vb = keys.reshape(q, p // block, block), vals.reshape(q, p // block, block)
    o = np.argsort(kb, axis=2, kind="stable")
    kb, vb = np.take_along_axis(kb, o, 2), np.take_along_axis(vb, o, 2)
    kb[:, 1::2], vb[:, 1::2] = kb[:, 1::2, ::-1], vb[:, 1::2, ::-1]
    return kb.reshape(q, p).copy(), vb.reshape(q, p).copy()


@pytest.mark.parametrize("k_start", [2, 512])
def test_plain_sort_matches_pallas_sort(k_start):
    """Keys equal exactly; each row's (key, value) pairs equal as multisets
    (the order of values within one key is free)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 300, size=(8, 2048)).astype(np.int32)  # many ties
    vals = rng.random((8, 2048)).astype(np.float32)
    if k_start > 2:
        keys, vals = alternating_blocks(keys, vals, k_start // 2)
    jk, jv = sort_pairs_pallas(jnp.asarray(keys), jnp.asarray(vals), interpret=True,
                               k_start=k_start)
    tk, tv = sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals), k_start=k_start)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(lexsorted(tk.numpy(), tv.numpy()), lexsorted(jk, jv)):
        np.testing.assert_array_equal(a, b)


def test_sort_wrapper_checks_inputs():
    k = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        sort_pairs(k.long(), v)
    with pytest.raises(ValueError):
        sort_pairs(k[:, :6].contiguous(), v[:, :6].contiguous())  # not a power of two
    with pytest.raises(ValueError):
        sort_pairs(k, v, k_start=3)
    got = sort_pairs(k, v)
    ref = sort_pairs_plain(k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def sorted_rows(seed, q=8, p=1024, n_docs=60):
    """Sorted (doc, impact) rows with runs, sentinel (= n_docs) padding."""
    rng = np.random.default_rng(seed)
    doc = np.full((q, p), n_docs, np.int32)
    imp = np.zeros((q, p), np.float32)
    for r in range(q):
        n = int(rng.integers(0, p))
        doc[r, :n] = np.sort(rng.integers(0, n_docs, n))
        imp[r, :n] = rng.random(n) * 3
    doc[0] = n_docs  # an empty row
    imp[0] = 0.0
    return doc, imp


def assert_topk_equal(got_v, got_i, want_v, want_i):
    """Scores equal within 1e-4 (f32 run sums in another order); ids where
    the scores are distinct (tie order may differ between implementations)."""
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-4)
    for r in range(got_v.shape[0]):
        for j in range(got_v.shape[1]):
            near = np.abs(want_v[r] - want_v[r, j]) <= 1e-4
            if near.sum() == 1:
                assert got_i[r, j] == want_i[r, j], (r, j)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_plain_segment_topk_matches_pallas_and_xla(k):
    doc, imp = sorted_rows(seed=k)
    sentinel = 60
    tv, ti = segment_topk(torch.from_numpy(doc), torch.from_numpy(imp), k=k, sentinel=sentinel)
    tv, ti = tv.numpy(), ti.numpy()
    pv, pi = segment_topk_pallas(jnp.asarray(doc), jnp.asarray(imp), k=k,
                                 sentinel=sentinel, interpret=True)
    xv, xi = sorted_segment_topk(jnp.asarray(doc), jnp.asarray(imp), k,
                                 sentinel=sentinel, presorted=True)
    assert_topk_equal(tv, ti, np.asarray(pv), np.asarray(pi))
    assert_topk_equal(tv, ti, np.asarray(xv), np.asarray(xi))
    assert (ti[0] == -1).all() and (tv[0] == 0).all()  # the empty row
    # ranking: score descending, then doc id ascending
    for r in range(tv.shape[0]):
        hit = ti[r] >= 0
        pairs = list(zip(-tv[r][hit], ti[r][hit]))
        assert pairs == sorted(pairs)


def test_segment_topk_ties_rank_by_doc_id():
    doc = np.asarray([[1, 1, 2, 3, 3, 9, 9, 9]], np.int32)
    imp = np.asarray([[1, 1, 2, 1.5, 0.5, 0, 0, 0]], np.float32)
    v, i = segment_topk_plain(torch.from_numpy(doc), torch.from_numpy(imp), k=4, sentinel=9)
    assert v.tolist() == [[2.0, 2.0, 2.0, 0.0]]
    assert i.tolist() == [[1, 2, 3, -1]]


@pytest.fixture(scope="module")
def zipf_indexes():
    rng = np.random.default_rng(7)
    docs = [[f"t{t}" for t in rng.zipf(1.2, rng.integers(3, 30)) % 400] for _ in range(3000)]
    cfg = dict(stem=False, remove_stopwords=False)
    return (BM25Index.build_tokenized(docs, BM25Config(**cfg)),
            JaxBM25Index.build_tokenized(docs, JaxBM25Config(**cfg)), rng)


def test_bitonic_store_equals_jax_store(zipf_indexes):
    idx, jidx, _ = zipf_indexes
    st, jst = idx.bitonic_csr(), jidx.bitonic_csr()
    for name in ("aligned_start", "aligned_len", "doc_e", "imp_e", "doc_o", "imp_o",
                 "doc_c", "imp_c", "doc_r", "imp_r"):
        np.testing.assert_array_equal(getattr(st, name), getattr(jst, name), err_msg=name)
    assert (st.block, st.min_len, st.sentinel, st.nnz) == (
        jst.block, jst.min_len, jst.sentinel, jst.nnz)


def test_plain_gather_layout_matches_numpy_rebuild(zipf_indexes):
    """Every block of a gathered row is sorted (ascending at even block
    index, descending at odd), the slots past the row total are (sentinel,
    0), and the row's postings are exactly its terms' postings from the JAX
    store's compact copy, each times its dedup weight."""
    idx, jidx, rng = zipf_indexes
    jst = jidx.bitonic_csr()
    eng = BM25Engine(idx, device="cpu")
    lens = idx.term_offsets[1:] - idx.term_offsets[:-1]
    heavy = np.argsort(lens)[-3:]
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 7)) % 400])
            for _ in range(10)]
    qids.append(np.concatenate([heavy, heavy[:1], [int(np.argsort(lens)[100])]]))  # long+dup
    uniq, weights, _ = _dedup_term_ids(qids)
    src, srcr, slot, rlen, big, totals, wt = eng._plan_bitonic(uniq, weights)
    block = jst.block
    pad = 1 << int(np.ceil(np.log2(max(int(totals.max()), block))))
    desc = [torch.from_numpy(a) for a in (src, srcr, slot, rlen, big)]
    wtblk = torch.from_numpy(_weight_blocks(slot, wt, pad, block))
    doc, imp = bm25_gather(eng._dev_store, *desc, wtblk, pad=pad, block=block,
                           sentinel=idx.n_docs)
    doc, imp = doc.numpy(), imp.numpy()
    for r, (ids, w) in enumerate(zip(uniq, weights)):
        blocks = doc[r].reshape(-1, block).astype(np.int64)
        for b, blk in enumerate(blocks):
            d = np.diff(blk)
            assert (d >= 0).all() if b % 2 == 0 else (d <= 0).all(), (r, b)
        assert (doc[r, totals[r]:] == idx.n_docs).all() and (imp[r, totals[r]:] == 0).all()
        want_d, want_i = [], []
        for t, m in zip(ids, w):
            lo, hi = jidx.term_offsets[t], jidx.term_offsets[t + 1]
            want_d.append(jst.doc_c[lo:hi])
            want_i.append(jst.imp_c[lo:hi] * np.float32(m))
        want_d, want_i = np.concatenate(want_d), np.concatenate(want_i)
        real = doc[r] < idx.n_docs
        got = lexsorted(doc[r][real][None], imp[r][real][None])
        want = lexsorted(want_d[None], want_i[None])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_plain_gather_equals_pallas_gather(zipf_indexes, monkeypatch):
    """The gathered rows, tail mask and block weights included, equal
    element for element the JAX bitonic gather stage run in interpret mode
    (``bm25_search_bitonic`` with its sort and segment stages stubbed out to
    hand the gathered rows back)."""
    import probing_rag_tpu.ops.pallas_sort as jsort
    import probing_rag_tpu.ops.pallas_sparse as jsparse
    from probing_rag_tpu.retrieval.bm25 import BM25Engine as JaxBM25Engine

    idx, jidx, rng = zipf_indexes
    eng = BM25Engine(idx, device="cpu")
    jeng = JaxBM25Engine(jidx, mode="bitonic", interpret=True)
    lens = idx.term_offsets[1:] - idx.term_offsets[:-1]
    heavy = np.argsort(lens)[-2:]
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 5)) % 400])
            for _ in range(6)]
    qids.append(np.concatenate([heavy, heavy[:1], [int(np.argsort(lens)[100])]]))  # long+dup
    uniq, weights, _ = _dedup_term_ids(qids)
    plan = eng._plan_bitonic(uniq, weights)
    src, srcr, slot, rlen, big, totals, wt = plan
    assert big.any() and ((big == 0) & (slot > 0)).any()  # long and short terms
    block = idx.bitonic_csr().block
    pad = 1 << int(np.ceil(np.log2(max(int(totals.max()), block))))
    wtblk = _weight_blocks(slot, wt, pad, block)
    got = bm25_gather(eng._dev_store, *(torch.from_numpy(a) for a in plan[:5]),
                      torch.from_numpy(wtblk), pad=pad, block=block, sentinel=idx.n_docs)

    monkeypatch.setattr(jsort, "sort_pairs_pallas", lambda d, v, **kw: (d, v))
    monkeypatch.setattr(jsort, "sort_pairs_pallas_wide", lambda d, v, **kw: (d, v))
    monkeypatch.setattr(jsparse, "segment_topk_pallas", lambda d, v, **kw: (v, d))
    imp, doc = jsparse.bm25_search_bitonic.__wrapped__(  # unjitted: the stubs apply
        *jeng._dev_store, *(jnp.asarray(a) for a in plan[:5]), jnp.asarray(wtblk),
        pad=pad, sentinel_doc=idx.n_docs, k=5, block=block, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(doc))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(imp))


def test_chained_search_matches_oracle(zipf_indexes):
    """gather -> sort (k_start = 2 * block) -> segment top-k on the plain
    versions equals the exact host oracle (f32 sums vs f64: 5e-4)."""
    idx, _, rng = zipf_indexes
    eng = BM25Engine(idx, device="cpu")
    qids = [idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 6)) % 400])
            for _ in range(6)]
    src, srcr, slot, rlen, big, totals, _ = eng._plan_bitonic(qids)
    pad = 1 << int(np.ceil(np.log2(max(int(totals.max()), 1024))))
    scores, docs = bm25_search_bitonic(
        eng._dev_store, *(torch.from_numpy(a) for a in (src, srcr, slot, rlen, big)),
        pad=pad, sentinel=idx.n_docs, k=5)
    for r, ids in enumerate(qids):
        oracle = idx.score_all(ids)
        got = scores[r].numpy()[docs[r].numpy() >= 0]
        np.testing.assert_allclose(got, np.sort(oracle)[::-1][: len(got)], atol=5e-4)
