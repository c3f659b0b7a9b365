"""The port's BM25 over-cap hybrid (probing_rag_tpu_torch) against the JAX
package on the CPU: the plain versions of the aligned postings gather (the
port of TPU kernel 5), the short-term assembly (TPU kernel 6) and the sort's
``k_stop`` against the Pallas kernels in interpret mode; the hybrid's rows
before their sort; the engine's routing and results against
``BM25Engine(mode="bitonic", interpret=True)``; and a query of more than 2M
bitonic slots, which the port answered with a ``ValueError`` before the
hybrid.

Tolerances: gathers, the assembly and the sort's keys are compared exactly
(they copy values, and multiply once by the same f32 weight); the sort's
(key, value) pairs as multisets per block, since the order of values within
one key is free. Search scores within abs 5e-4 / rel 1e-4 of the exact f64
``score_all`` oracle (abs 1e-3 for rows of heavy terms, as
tests/test_bm25_bitonic.py allows); against the JAX engine scores within
1e-4 and ids compared where the scores are distinct, because tie order
differs between the engines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops.pallas_sort import sort_pairs_pallas
from probing_rag_tpu.ops.pallas_sparse import postings_assemble_pallas, postings_gather_pallas
from probing_rag_tpu.retrieval import bm25 as jbm25
from probing_rag_tpu.retrieval.bm25_index import BM25Config as JaxBM25Config
from probing_rag_tpu.retrieval.bm25_index import BM25Index as JaxBM25Index
from probing_rag_tpu_torch.ops.sort import MAX_SORT_WIDTH, sort_pairs, sort_pairs_plain
from probing_rag_tpu_torch.ops.sparse import postings_assemble, postings_gather
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


def blockwise_lexsorted(keys, vals, width):
    """Each ``width`` block of each row ordered by (key, value bits): a
    canonical order for comparing the pair multisets of every block."""
    q, p = keys.shape
    kb = np.asarray(keys).reshape(q * p // width, width)
    vb = np.asarray(vals).view(np.int32).reshape(q * p // width, width)
    out_k, out_v = np.empty_like(kb), np.empty_like(vb)
    for r in range(kb.shape[0]):
        o = np.lexsort((vb[r], kb[r]))
        out_k[r], out_v[r] = kb[r][o], vb[r][o]
    return out_k, out_v


def alternating_blocks(keys, vals, block):
    q, p = keys.shape
    kb, vb = keys.reshape(q, p // block, block), vals.reshape(q, p // block, block)
    o = np.argsort(kb, axis=2, kind="stable")
    kb, vb = np.take_along_axis(kb, o, 2), np.take_along_axis(vb, o, 2)
    kb[:, 1::2], vb[:, 1::2] = kb[:, 1::2, ::-1], vb[:, 1::2, ::-1]
    return kb.reshape(q, p).copy(), vb.reshape(q, p).copy()


# --------------------------------------------------------------- k_stop


@pytest.mark.parametrize("k_start,k_stop", [(2, 4), (2, 128), (2, 1024), (8, 256),
                                            (2, 4096), (512, 128)])
def test_sort_k_stop_matches_pallas(k_start, k_stop):
    """Keys equal exactly; each ``min(k_stop, P)`` block's (key, value)
    pairs equal as multisets. ``k_start`` past ``k_stop`` leaves the rows
    as they were, in both."""
    rng = np.random.default_rng(k_start + k_stop)
    keys = rng.integers(0, 300, size=(4, 2048)).astype(np.int32)  # many ties
    vals = rng.random((4, 2048)).astype(np.float32)
    if k_start > 2:
        keys, vals = alternating_blocks(keys, vals, k_start // 2)
    jk, jv = sort_pairs_pallas(jnp.asarray(keys), jnp.asarray(vals), interpret=True,
                               k_start=k_start, k_stop=k_stop)
    tk, tv = sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals),
                        k_start=k_start, k_stop=k_stop)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    width = min(k_stop, 2048)
    for a, b in zip(blockwise_lexsorted(tk.numpy(), tv.numpy(), width),
                    blockwise_lexsorted(np.asarray(jk), np.asarray(jv), width)):
        np.testing.assert_array_equal(a, b)
    if k_start > k_stop:
        np.testing.assert_array_equal(tk.numpy(), keys)


def test_sort_k_stop_in_place_on_a_column_range():
    """``out`` views over the last columns of a wider buffer: sorted there,
    in place, equal to the plain version of that slice; the other columns
    untouched."""
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 500, size=(3, 8192)).astype(np.int32))
    vals = torch.from_numpy(rng.random((3, 8192)).astype(np.float32))
    k0, v0 = keys.clone(), vals.clone()
    tail = (keys[:, 4096:], vals[:, 4096:])
    want = sort_pairs_plain(k0[:, 4096:], v0[:, 4096:], k_stop=1024)
    got = sort_pairs(*tail, k_stop=1024, out=tail)
    assert got[0].data_ptr() == keys[:, 4096:].data_ptr()
    assert torch.equal(keys[:, 4096:], want[0]) and torch.equal(vals[:, 4096:], want[1])
    assert torch.equal(keys[:, :4096], k0[:, :4096]) and torch.equal(vals[:, :4096], v0[:, :4096])
    blocks = keys[:, 4096:].reshape(3, 4, 1024).numpy().astype(np.int64)
    for b in range(4):
        d = np.diff(blocks[:, b], axis=1)
        assert (d >= 0).all() if b % 2 == 0 else (d <= 0).all()
    with pytest.raises(ValueError):
        sort_pairs(keys, vals, k_stop=3)


# --------------------------------------------------------------- gather


def gather_case(idx, rng, alternated):
    """(postings arrays, starts, lens, pad, block) for the plain gather over
    the aligned CSR, or for the alternated gather over a bitonic store with
    small blocks (the JAX test's layout)."""
    if alternated:
        block = 128
        st = idx.bitonic_csr(min_len=64, block=block)
        big = np.nonzero(st.aligned_len > 0)[0]
        rows = [big[:3], big[[0, 0, 6]], big[[5, 2]], big[:0], big[:12]]
        a_start, a_len = st.aligned_start, st.aligned_len
        arrays = (st.doc_e, st.imp_e, st.doc_o, st.imp_o)
    else:
        block = 1024
        offsets, doc, imp = idx.aligned_csr()
        lens = offsets[1:] - offsets[:-1]
        big = np.argsort(lens)[::-1]
        rows = [big[:2], big[[10, 50, 100]], big[:0], big[[200, 3, 3]], big[:12]]
        a_start, a_len = offsets[:-1], lens
        arrays = (doc, imp)
    tq = max(len(r) for r in rows)
    starts = np.zeros((len(rows), tq), np.int32)
    lens = np.zeros((len(rows), tq), np.int32)
    for r, ids in enumerate(rows):
        starts[r, : len(ids)] = a_start[ids]
        lens[r, : len(ids)] = a_len[ids]
    totals = lens.sum(axis=1)
    # the last row is over the pad: its last terms are cut
    pad = max(int(2 ** np.ceil(np.log2(totals[:-1].max()))), 4 * block)
    assert totals[-1] > pad
    return arrays, starts, lens, pad, block


@pytest.mark.parametrize("alternated", [False, True])
def test_postings_gather_plain_matches_pallas(indexes, alternated):
    """The port's gather (plain version) equals ``postings_gather_pallas``
    in interpret mode element for element: the plain form over the aligned
    CSR ("dma" mode) and the E/O form over the bitonic store (the hybrid),
    with a masked row, a repeated term and a term cut at the pad. The block
    weights fused into the port's gather equal the JAX hybrid's multiply
    after the kernel."""
    idx, jidx, rng = indexes
    arrays, starts, lens, pad, block = gather_case(idx, rng, alternated)
    sentinel = idx.n_docs
    kw = dict(pad=pad, sentinel=sentinel, interpret=True, block=block, chunk=block)
    if alternated:
        kw.update(postings_doc_o=jnp.asarray(arrays[2]), postings_impact_o=jnp.asarray(arrays[3]))
    jd, ji = postings_gather_pallas(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]),
                                    jnp.asarray(starts), jnp.asarray(lens), **kw)
    t = [torch.from_numpy(a) for a in arrays]
    o = dict(doc_o=t[2], imp_o=t[3]) if alternated else {}
    td, ti = postings_gather(t[0], t[1], torch.from_numpy(starts), torch.from_numpy(lens),
                             pad=pad, sentinel=sentinel, block=block, **o)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if alternated:
        for r in range(td.shape[0]):
            blocks = td[r].numpy().reshape(-1, block).astype(np.int64)
            for b, blk in enumerate(blocks):
                d = np.diff(blk)
                assert (d >= 0).all() if b % 2 == 0 else (d <= 0).all(), (r, b)
    wtblk = rng.integers(1, 4, (starts.shape[0], pad // block)).astype(np.float32)
    _, tw = postings_gather(t[0], t[1], torch.from_numpy(starts), torch.from_numpy(lens),
                            pad=pad, sentinel=sentinel, block=block,
                            wtblk=torch.from_numpy(wtblk), **o)
    jw = np.asarray(ji) * np.repeat(wtblk, block, axis=1)  # _hybrid_gather_sort's multiply
    np.testing.assert_array_equal(tw.numpy(), jw)


# -------------------------------------------------------------- assemble


def assemble_case(rng):
    """Short posting lists (1..255, the store's short terms), rows with
    empty terms, a fill that lands exactly on a 1024 boundary (4 x 255 +
    4), terms of 255 across block boundaries, and an empty row."""
    lens = np.concatenate([[255, 255, 4, 1, 128], rng.integers(1, 256, 40)]).astype(np.int64)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n_docs = 5000
    docs = np.concatenate([np.sort(rng.choice(n_docs, l, replace=False)) for l in lens])
    imps = rng.random(int(offs[-1]), dtype=np.float32) + 0.01
    # the bitonic store's guarded compact copy: two blocks of sentinel
    doc_c = np.concatenate([docs.astype(np.int32), np.full(2048, n_docs, np.int32)])
    imp_c = np.concatenate([imps, np.zeros(2048, np.float32)])
    rows = [[0, 1, 0, 1, 2, 5, 6], [3, 0, 1, 0, 1, 0, 0, 1], [], [0, -1, 1, -1, 0, 4, 1],
            list(rng.integers(5, len(lens), 12))]
    tq = max(len(r) for r in rows)
    src = np.zeros((len(rows), tq), np.int32)
    rlen = np.zeros((len(rows), tq), np.int32)
    for r, terms in enumerate(rows):
        for c, t in enumerate(terms):
            if t >= 0:  # -1: a masked (length 0) term between real ones
                src[r, c], rlen[r, c] = offs[t], lens[t]
    pad = 4096
    assert rlen.sum(axis=1).max() <= pad
    assert 1024 in rlen[0].cumsum()
    return doc_c, imp_c, src, rlen, pad, n_docs


@pytest.mark.parametrize("weighted", [False, True])
def test_postings_assemble_plain_matches_pallas(weighted):
    """The port's assembly (plain version) equals
    ``postings_assemble_pallas`` in interpret mode element for element,
    with f32 weights in place of JAX's int32 bit patterns; and written into
    the last columns of a wider buffer it leaves the other columns as they
    were."""
    rng = np.random.default_rng(31 + weighted)
    doc_c, imp_c, src, rlen, pad, n_docs = assemble_case(rng)
    wt = rng.integers(1, 4, src.shape).astype(np.float32) if weighted else None
    jd, ji = postings_assemble_pallas(
        jnp.asarray(doc_c[None]), jnp.asarray(imp_c[None]), jnp.asarray(src),
        jnp.asarray(rlen), jnp.asarray(wt.view(np.int32)) if weighted else None,
        pad=pad, sentinel=n_docs, row_tile=8, interpret=True)
    args = (torch.from_numpy(doc_c), torch.from_numpy(imp_c), torch.from_numpy(src),
            torch.from_numpy(rlen), torch.from_numpy(wt) if weighted else None)
    td, ti = postings_assemble(*args, pad=pad, sentinel=n_docs)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    wide_d = torch.full((src.shape[0], 3 * pad), -7, dtype=torch.int32)
    wide_i = torch.full((src.shape[0], 3 * pad), -1.0)
    out = (wide_d[:, 2 * pad:], wide_i[:, 2 * pad:])
    postings_assemble(*args, pad=pad, sentinel=n_docs, out=out)
    assert torch.equal(wide_d[:, 2 * pad:], td) and torch.equal(wide_i[:, 2 * pad:], ti)
    assert (wide_d[:, : 2 * pad] == -7).all() and (wide_i[:, : 2 * pad] == -1).all()


# ---------------------------------------------------------------- engine


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


def assert_same_results(a, b):
    """Scores allclose; ids equal where the score is distinct in its row."""
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-4)
    for r in range(a.scores.shape[0]):
        for j in range(a.scores.shape[1]):
            if (np.abs(b.scores[r] - b.scores[r, j]) <= 1e-4).sum() == 1:
                assert a.doc_indices[r, j] == b.doc_indices[r, j], (r, j)


def overcap_queries(idx, rng):
    lens = idx.term_offsets[1:] - idx.term_offsets[:-1]
    order = np.argsort(lens)
    heavy = order[-3:].astype(np.int32)
    shorts = order[len(order) // 2 : len(order) // 2 + 60].astype(np.int32)
    return [
        np.concatenate([heavy, shorts, shorts[:5], heavy[:1]]),  # dups, long and short
        np.concatenate([shorts, shorts[:7]]),  # short terms only, dups
        heavy[:1],  # one long term
        np.zeros(0, np.int32),
        *[idx.encode_query([f"t{t}" for t in rng.zipf(1.2, rng.integers(1, 6)) % 400])
          for _ in range(4)],
    ]


def test_engine_hybrid_matches_jax_and_oracle(indexes):
    """Under a 2048-slot cap the port and the JAX engine route the same rows
    to their over-cap hybrids (equal ``last_stats``) and give the same
    results, which match the oracle; ``max_pad = MAX_SORT_WIDTH`` runs the
    same queries on the bitonic path alone, with the same results."""
    idx, jidx, rng = indexes
    qids = overcap_queries(idx, rng)
    eng = tbm25.BM25Engine(idx, device="cpu", max_pad=2048)
    res = eng.search_term_ids(qids, k=5)
    jeng = jbm25.BM25Engine(jidx, mode="bitonic", interpret=True, max_pad=2048)
    jres = jeng.search_term_ids(qids, k=5)
    assert eng.last_stats == jeng.last_stats
    assert eng.last_stats["n_fallback"] >= 3
    assert sum(eng.last_widths["hybrid"].values()) == eng.last_stats["n_fallback"]
    assert_same_results(res, jres)
    assert_matches_oracle(idx, qids, res, atol=1e-3)
    single = tbm25.BM25Engine(idx, device="cpu", max_pad=MAX_SORT_WIDTH)
    sres = single.search_term_ids(qids, k=5)
    assert single.last_stats["n_fallback"] == 0 and "hybrid" not in single.last_widths
    assert_same_results(sres, res)


def test_hybrid_rows_blocks_alternate_across_the_seam(indexes, monkeypatch):
    """The hybrid's rows before their sort: every block sorted, ascending at
    even block index and descending at odd, through the seam where the
    short tail starts (``pad_big - pad_short``), so the sort may start at
    ``2 * block``; each row holds exactly its terms' postings times their
    occurrence counts."""
    idx, _, rng = indexes
    seen = []
    real = tbm25._hybrid_rows

    def spy(*args, **kw):
        doc, imp, k_start = real(*args, **kw)
        seen.append((doc.clone(), imp.clone(), k_start, kw["pad_big"], kw["pad_short"]))
        return doc, imp, k_start

    monkeypatch.setattr(tbm25, "_hybrid_rows", spy)
    qids = overcap_queries(idx, rng)[:1]
    eng = tbm25.BM25Engine(idx, device="cpu", max_pad=2048)
    eng.search_term_ids(qids, k=5)
    assert len(seen) == 1
    doc, imp, k_start, pad_big, pad_short = seen[0]
    block = eng._store.block
    assert k_start == 2 * block and pad_short >= 2 * block and pad_big >= 4 * block
    assert (pad_big - pad_short) % (2 * block) == 0
    blocks = doc[0].numpy().reshape(-1, block).astype(np.int64)
    for b, blk in enumerate(blocks):
        d = np.diff(blk)
        assert (d >= 0).all() if b % 2 == 0 else (d <= 0).all(), b
    ids, counts = np.unique(qids[0], return_counts=True)
    want_d = np.concatenate([idx.postings_doc[idx.term_offsets[t]:idx.term_offsets[t + 1]]
                             for t in ids])
    want_i = np.concatenate([idx.postings_impact[idx.term_offsets[t]:idx.term_offsets[t + 1]]
                             * np.float32(c) for t, c in zip(ids, counts)])
    keep = doc[0].numpy() < idx.n_docs
    got = blockwise_lexsorted(doc[0].numpy()[keep][None], imp[0].numpy()[keep][None],
                              int(keep.sum()))
    want = blockwise_lexsorted(want_d[None], want_i[None], len(want_d))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_query_over_2m_bitonic_slots_is_answered():
    """2,100 distinct terms of one posting each take 2,150,400 bitonic slots
    (one 1024-block each), over the 2M sort width the port had: it raised
    ``ValueError``. The hybrid packs them at their real lengths and the
    result equals the oracle, the JAX ``mode="xla"`` engine and the single
    bitonic path at the raised ``MAX_SORT_WIDTH``."""
    n_docs = 2200
    docs = [[f"u{i}"] * (1 + i % 7) + ["filler"] * (i % 11) for i in range(n_docs)]
    idx = BM25Index.build_tokenized(docs, BM25Config(**CFG))
    jidx = JaxBM25Index.build_tokenized(docs, JaxBM25Config(**CFG))
    q = idx.encode_query([f"u{i}" for i in range(2100)])
    assert len(q) == 2100 and 2100 * 1024 > 1 << 21
    eng = tbm25.BM25Engine(idx, device="cpu")
    res = eng.search_term_ids([q], k=5)
    assert eng.last_stats == {"n_queries": 1, "n_fallback": 1, "n_trimmed": 0}
    assert_matches_oracle(idx, [q], res)
    assert_same_results(res, jbm25.BM25Engine(jidx, mode="xla").search_term_ids([q], k=5))
    single = tbm25.BM25Engine(idx, device="cpu", max_pad=MAX_SORT_WIDTH)
    assert_same_results(single.search_term_ids([q], k=5), res)
    assert single.last_widths["bitonic"] == {1 << 22: 1}
