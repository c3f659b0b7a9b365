"""The plan of the port's CUDA short-term assembly, carried out on the CPU.

``ops/sparse.py::plan_assemble`` gives ``postings_assemble.cu`` one thread
block per (row, span of slots). The kernel runs only on the card
(chip_smoke.py holds it to the plain version there); here each block of the
plan is carried out in numpy with the kernel's rules: scan the row's term
lengths in chunks of ``ASSEMBLE_THREADS`` from where the last tile stopped,
keep the non-empty terms that overlap the tile as (end, source base,
weight) entries numbered by non-empty rank, stop once the prefix passes the
tile's end, then write 4 slots a thread, the first slot's term found by
binary search over the entries' ends and the rest by stepping forward.
The result must equal ``postings_assemble_plain`` and, where JAX's contract
allows it (``pad`` a multiple of 1024 at least the row totals, terms under
1024 postings), ``postings_assemble_pallas`` in interpret mode. All
comparisons are exact: the assembly copies values and multiplies each
impact once by the same f32 weight."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops.pallas_sparse import postings_assemble_pallas
from probing_rag_tpu_torch.ops.sparse import (
    ASSEMBLE_THREADS, ASSEMBLE_TILE, plan_assemble, postings_assemble, postings_assemble_plain,
)
from test_torch_bm25_hybrid import assemble_case

torch.set_num_threads(1)

N_DOCS = 5000
INT32_MAX = np.iinfo(np.int32).max


def carry_out(plan, doc_c, imp_c, src, rlen, wt, *, pad, sentinel, out_doc, out_imp):
    """Every block of ``plan`` one after another, as postings_assemble.cu
    runs it, writing into the [Q, pad] views ``out_doc`` / ``out_imp``.
    Checks the kernel's invariants on the way: at most a tile of entries,
    their ends increasing, each slot below ``pad`` written exactly once."""
    span, (nbx, q) = plan
    t_n, tile = ASSEMBLE_THREADS, ASSEMBLE_TILE
    tq = src.shape[1]
    written = np.zeros((q, pad), np.int64)
    for row in range(q):
        for bx in range(nbx):
            b0 = bx * span
            b1 = min(b0 + span, pad)
            t0, base = 0, 0  # the scan chunk's first term, postings before it
            for c0 in range(b0, b1, tile):
                c1 = c0 + tile
                ends = np.zeros(tile, np.int64)
                bases = np.zeros(tile, np.int64)
                ws = np.ones(tile, np.float32)
                n = 0
                while t0 < tq:
                    m = min(t_n, tq - t0)
                    ln = np.zeros(t_n, np.int64)
                    sl = np.zeros(t_n, np.int64)
                    wl = np.ones(t_n, np.float32)
                    ln[:m] = rlen[row, t0 : t0 + m]
                    sl[:m] = src[row, t0 : t0 + m]
                    if wt is not None:
                        wl[:m] = wt[row, t0 : t0 + m]
                    end = base + np.cumsum(ln)
                    start = end - ln
                    nz = ln > 0
                    rank = np.cumsum(nz) - 1  # non-empty terms before each one
                    nbefore = int((nz & (end <= c0)).sum())
                    ov = nz & (end > c0) & (start < c1)
                    e = n + rank[ov] - nbefore
                    if ov.any():
                        assert e[0] == n and e[-1] < tile, "entries outside the tile's table"
                    ends[e] = np.minimum(end[ov] - c0, tile)
                    bases[e] = sl[ov] - (start[ov] - c0)
                    ws[e] = wl[ov]
                    n += int(ov.sum())
                    nxt = base + int(ln.sum())
                    if nxt >= c1:
                        break
                    t0 += t_n
                    base = nxt
                ends, bases, ws = ends[:n], bases[:n], ws[:n]
                assert (np.diff(ends) > 0).all() and (np.abs(bases) <= INT32_MAX).all()
                j0 = 4 * np.arange(t_n)
                j0 = j0[c0 + j0 < b1]
                k = np.searchsorted(ends, j0, side="right")  # binary search
                for c in range(4):
                    j = j0 + c
                    while True:  # step forward across term ends
                        step = (k < n) & (ends[np.minimum(k, n - 1)] <= j) if n else k < 0
                        if not step.any():
                            break
                        k = k + step
                    hit = k < n
                    kk = np.minimum(k, max(n - 1, 0))
                    idx = np.where(hit, bases[kk] + j, 0) if n else np.zeros_like(j)
                    out_doc[row, c0 + j] = np.where(hit, doc_c[idx], sentinel)
                    out_imp[row, c0 + j] = np.where(
                        hit, imp_c[idx] * (ws[kk] if n else np.float32(1)), np.float32(0))
                    written[row, c0 + j] += 1
    assert (written == 1).all(), "a slot below pad was not written exactly once"


def make_store(rng, lens):
    """A compact copy of terms of the given lengths (sorted doc ids, random
    impacts) with the bitonic store's 2-block sentinel guard. Returns
    (doc_c, imp_c, offsets)."""
    lens = np.asarray(lens, np.int64)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    docs = [np.sort(rng.choice(N_DOCS, int(l), replace=False)) for l in lens]
    doc_c = np.concatenate(docs + [np.full(2048, N_DOCS)]).astype(np.int32)
    imp_c = np.concatenate([rng.random(int(offs[-1]), dtype=np.float32) + 0.01,
                            np.zeros(2048, np.float32)])
    return doc_c, imp_c, offs


def rows_desc(rows, lens, offs):
    """[Q, TQ] (src, rlen) of rows given as term ids, -1 a masked term."""
    tq = max(max((len(r) for r in rows), default=1), 1)
    src = np.zeros((len(rows), tq), np.int32)
    rlen = np.zeros((len(rows), tq), np.int32)
    for r, terms in enumerate(rows):
        for c, t in enumerate(terms):
            if t >= 0:
                src[r, c], rlen[r, c] = offs[t], lens[t]
    return src, rlen


def edges_case(rng):
    """Tile (and, at one block a tile, block) edges exactly at a term's end
    with masked terms at the next tile's first slot; a term of 255 across
    2048 and one across 4096; masked terms at a row's first slot; an empty
    row."""
    lens = [255, 8, 128, 1, 255, 255, 3]
    doc_c, imp_c, offs = make_store(rng, lens)
    rows = [
        [0] * 8 + [1] + [-1, -1] + [4] * 8 + [5, 2, -1, 3],  # 2048 exact, 255 across 4096
        [-1, -1] + [0] * 7 + [2] + [5] + [6, -1, 6],  # 255 at 1913..2168
        [],
        [-1, -1, -1],
    ]
    src, rlen = rows_desc(rows, lens, offs)
    assert 2048 in rlen[0].cumsum() and 1913 in rlen[1].cumsum()
    return doc_c, imp_c, src, rlen, 6144, N_DOCS


def many_terms_case(rng):
    """About 3,000 terms a row of 0-3 postings (several scan chunks per
    tile), and 2,500 single postings, whose first tile has a full table of
    2,048 entries."""
    lens = [1, 2, 3]
    doc_c, imp_c, offs = make_store(rng, lens)
    rows = [list(rng.integers(-1, 3, 3000)), list(rng.integers(0, 3, 2900)), [0] * 2500]
    src, rlen = rows_desc(rows, lens, offs)
    assert rlen.shape[1] > 5 * ASSEMBLE_THREADS
    pad = -(-int(rlen.sum(axis=1).max()) // 1024) * 1024
    return doc_c, imp_c, src, rlen, pad, N_DOCS


def cut_case(rng):
    """A row whose total (5,100) is over pad (4,096): the posting past pad
    is cut. Not in JAX's contract (its pad holds the row totals)."""
    lens = [255, 17]
    doc_c, imp_c, offs = make_store(rng, lens)
    src, rlen = rows_desc([[0] * 20, [1, 0, -1, 1]], lens, offs)
    return doc_c, imp_c, src, rlen, 4096, N_DOCS


CASES = {"hybrid": assemble_case, "edges": edges_case, "many_terms": many_terms_case,
         "cut": cut_case}
SMS = (1, 3, 132)  # a block of several tiles, of one tile, one a tile


def case_inputs(name, weighted):
    rng = np.random.default_rng(sorted(CASES).index(name) * 2 + weighted)
    doc_c, imp_c, src, rlen, pad, n_docs = CASES[name](rng)
    wt = rng.integers(1, 4, src.shape).astype(np.float32) * np.float32(0.37) if weighted else None
    return doc_c, imp_c, src, rlen, wt, pad, n_docs


def plain(doc_c, imp_c, src, rlen, wt, pad, n_docs):
    td, ti = postings_assemble_plain(
        torch.from_numpy(doc_c), torch.from_numpy(imp_c), torch.from_numpy(src),
        torch.from_numpy(rlen), torch.from_numpy(wt) if wt is not None else None,
        pad=pad, sentinel=n_docs)
    return td.numpy(), ti.numpy()


@pytest.mark.parametrize("sm_count", SMS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_carried_out_plan_matches_plain(name, weighted, sm_count):
    """Every block of the plan, carried out with the kernel's rules, gives
    the plain version's rows bit for bit, written into the last ``pad``
    columns of a wider buffer whose other columns stay untouched."""
    doc_c, imp_c, src, rlen, wt, pad, n_docs = case_inputs(name, weighted)
    q = src.shape[0]
    plan = plan_assemble(q, pad, sm_count)
    wide_d = np.full((q, 3 * pad), -7, np.int32)
    wide_i = np.full((q, 3 * pad), -1.0, np.float32)
    carry_out(plan, doc_c, imp_c, src, rlen, wt, pad=pad, sentinel=n_docs,
              out_doc=wide_d[:, 2 * pad:], out_imp=wide_i[:, 2 * pad:])
    rd, ri = plain(doc_c, imp_c, src, rlen, wt, pad, n_docs)
    np.testing.assert_array_equal(wide_d[:, 2 * pad:], rd)
    np.testing.assert_array_equal(wide_i[:, 2 * pad:].view(np.int32), ri.view(np.int32))
    assert (wide_d[:, : 2 * pad] == -7).all() and (wide_i[:, : 2 * pad] == -1).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["edges", "hybrid", "many_terms"])
def test_carried_out_plan_matches_pallas(name, weighted):
    """The plan on the card's 132 SMs, carried out, against
    ``postings_assemble_pallas`` in interpret mode, element for element,
    with f32 weights in place of JAX's int32 bit patterns."""
    doc_c, imp_c, src, rlen, wt, pad, n_docs = case_inputs(name, weighted)
    assert pad % 1024 == 0 and rlen.sum(axis=1).max() <= pad and rlen.max() < 1024
    jd, ji = postings_assemble_pallas(
        jnp.asarray(doc_c[None]), jnp.asarray(imp_c[None]), jnp.asarray(src),
        jnp.asarray(rlen), jnp.asarray(wt.view(np.int32)) if weighted else None,
        pad=pad, sentinel=n_docs, row_tile=1, interpret=True)
    q = src.shape[0]
    got_d = np.empty((q, pad), np.int32)
    got_i = np.empty((q, pad), np.float32)
    carry_out(plan_assemble(q, pad, 132), doc_c, imp_c, src, rlen, wt, pad=pad,
              sentinel=n_docs, out_doc=got_d, out_imp=got_i)
    np.testing.assert_array_equal(got_d, np.asarray(jd))
    np.testing.assert_array_equal(got_i.view(np.int32), np.asarray(ji).view(np.int32))


def test_cut_row_is_cut():
    """The cut case does cut: its first row's total is over pad, and the
    row holds its first pad postings."""
    doc_c, imp_c, src, rlen, wt, pad, n_docs = case_inputs("cut", False)
    assert rlen[0].sum() > pad
    rd, _ = plain(doc_c, imp_c, src, rlen, wt, pad, n_docs)
    assert (rd[0] != n_docs).all()


@pytest.mark.parametrize("q,pad,sm_count", [
    (8, 65536, 132), (1, 65536, 132), (1, 1024, 132), (3, 6144, 1), (8, 1 << 20, 132),
    (64, 1 << 20, 132), (256, 1 << 16, 132), (5, 1 << 23, 132), (2, 10240, 3), (7, 4, 132),
])
def test_plan_assemble_covers_every_slot_once(q, pad, sm_count):
    """The span is a whole number of tiles (so a multiple of 1024 and of
    4); the blocks of a row cover [0, pad) once, the last one the only
    one past pad and by less than a span; the grid stays within
    2 x SMs + q blocks, and covers every SM once a row has the tiles."""
    span, (nbx, rows) = plan_assemble(q, pad, sm_count)
    assert span % ASSEMBLE_TILE == 0 and span % 1024 == 0 and span % 4 == 0 and span > 0
    assert rows == q and (nbx - 1) * span < pad <= nbx * span
    assert nbx * q <= 2 * sm_count + q
    if -(-pad // ASSEMBLE_TILE) * q >= sm_count:
        assert nbx * q >= sm_count


def test_plan_assemble_at_the_hybrid_shapes():
    """At the over-cap batch's [8, 65,536] on 132 SMs the grid has at least
    132 blocks (one a tile: 256); at the widest bucket with no long term,
    pad 2^20, it stays about two an SM at any row count."""
    span, (nbx, q) = plan_assemble(8, 65536, 132)
    assert (span, nbx * q) == (ASSEMBLE_TILE, 256)
    for q in (1, 8, 64):
        span, (nbx, _) = plan_assemble(q, 1 << 20, 132)
        assert 132 <= nbx * q <= 2 * 132 + q


def test_wrapper_rejects_what_breaks_16_byte_stores():
    """``postings_assemble`` raises for a pad that is no multiple of 4 and
    for an ``out`` view whose rows do not start 16-byte aligned; the last
    columns of a wider buffer are taken."""
    doc_c, imp_c, src, rlen, wt, pad, n_docs = case_inputs("edges", True)
    args = tuple(torch.from_numpy(a) for a in (doc_c, imp_c, src, rlen, wt))
    q = src.shape[0]
    with pytest.raises(ValueError, match="multiple of 4"):
        postings_assemble(*args, pad=pad + 2, sentinel=n_docs)
    wide_d = torch.zeros((q, pad + 5), dtype=torch.int32)
    wide_i = torch.zeros((q, pad + 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        postings_assemble(*args, pad=pad, sentinel=n_docs, out=(wide_d[:, 5:], wide_i[:, 5:]))
    wide_d = torch.zeros((q, pad + 8), dtype=torch.int32)
    wide_i = torch.zeros((q, pad + 8), dtype=torch.float32)
    td, ti = postings_assemble(*args, pad=pad, sentinel=n_docs, out=(wide_d[:, 8:], wide_i[:, 8:]))
    rd, ri = plain(doc_c, imp_c, src, rlen, wt, pad, n_docs)
    np.testing.assert_array_equal(td.numpy(), rd)
    np.testing.assert_array_equal(ti.numpy(), ri)
