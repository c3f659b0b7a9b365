"""BM25 search engine: host analysis and planning + device scoring through
the CUDA search kernels.

Port of ``probing_rag_tpu/retrieval/bm25.py::BM25Engine``, modes
``"bitonic"`` (the default) and ``"dma"``. Queries are analyzed on the host
(the same chain as index build).

- ``mode="bitonic"``: repeated terms are collapsed into weights and each
  query is planned into per-(query, term) slot descriptors over the
  block-alternated store (``bm25_index.BitonicStore``). A row whose slot
  total is at most ``max_pad`` runs ``ops.sparse.bm25_search_bitonic`` at
  its power-of-two width. A wider row goes to the over-cap hybrid
  (``_search_fallback``): its long terms are gathered from the E/O store
  (``postings_gather``), its short terms packed at their real lengths into
  the row's reserved tail (``postings_assemble``), then one sort and the
  segment top-k. Rows over ``FALLBACK_MAX_PAD`` real postings keep their
  most selective terms.
- ``mode="dma"``: the aligned CSR (``bm25_index.align_csr``), no dedup,
  each row trimmed to ``max_pad`` aligned postings, and ``ops.sparse.
  bm25_search_padded_fused`` (gather, full sort, segment top-k).

The JAX engine's ``"xla"`` mode is not ported: on the CPU this engine runs
the kernels' plain versions, which is that path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.ops.sort import MAX_SORT_WIDTH, sort_pairs
from probing_rag_tpu_torch.ops.sparse import (
    bm25_search_bitonic,
    bm25_search_padded_fused,
    postings_assemble,
    postings_gather,
    segment_topk,
)
from probing_rag_tpu_torch.retrieval.bm25_index import (
    BM25Index,
    align_csr,
    align_up,
    bitonic_tables,
    build_bitonic_store,
)
from probing_rag_tpu_torch.utils.profiling import RECORDER

# bound on one chunk's [rows, pad] tile (device memory, not results)
MAX_TILE_ELEMS = 1 << 26
# real postings an over-cap query keeps (the JAX engine's ``fallback_max_pad``)
FALLBACK_MAX_PAD = 1 << 20
# The bitonic mode's default row cap: the JAX engine's effective one
# (``pallas_sparse.BITONIC_MAX_PAD``, set there by Mosaic compile time). That
# reason does not hold on the card; the cap stays so that routing and
# ``last_stats`` compare one to one with the JAX engine. ``max_pad =
# MAX_SORT_WIDTH`` sends every row it can through the bitonic kernels.
BITONIC_MAX_PAD = 1 << 19
# the "dma" mode's default trim, in aligned postings (the JAX default)
DMA_MAX_PAD = 1 << 20
# the narrowest row of the dma buckets and of a short tail: every short pad
# is a multiple of 1024
MIN_PAD = 1024
# the dma mode's postings alignment (``align_csr``'s default)
ALIGNMENT = 1024


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _next_pow4(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 4
    return p


def trim_to_cap(lens: np.ndarray, ids: np.ndarray, cap: int, weights=None):
    """Keep the most selective (shortest-postings) terms whose posting
    total fits under ``cap``, preserving query order. Returns ``(ids,
    weights, total, trimmed)``. Same rule as the JAX engine."""
    total = int(lens[ids].sum()) if len(ids) else 0
    if total <= cap:
        return ids, weights, total, False
    order = np.argsort(lens[ids], kind="stable")
    keep = int(np.searchsorted(np.cumsum(lens[ids[order]]), cap, side="right"))
    sel = np.sort(order[:keep])
    ids = ids[sel]
    w = weights[sel] if weights is not None else None
    return ids, w, int(lens[ids].sum()), True


def _dedup_term_ids(term_id_lists: Sequence[np.ndarray]):
    """Collapse repeated term ids into (unique ids, occurrence counts).

    rank_bm25 scores a query term once PER OCCURRENCE, so a term repeated m
    times contributes m x impact per doc — expressed exactly as weight m on
    a single planned slot. Returns (unique_lists, weight_lists [f32] | None,
    any_dup); weights are None when no query had a repeated term.
    Vectorized over the padded [N, TQ] id matrix (row sort + neighbor
    compare + run-length scatter)."""
    n = len(term_id_lists)
    lens = np.fromiter((len(x) for x in term_id_lists), np.int64, count=n)
    tq = int(lens.max()) if n else 0
    if tq == 0:
        return list(term_id_lists), None, False
    mask = lens[:, None] > np.arange(tq)
    flat = (
        np.concatenate([np.asarray(x, np.int64).ravel() for x in term_id_lists])
        if int(lens.sum())
        else np.zeros(0, np.int64)
    )
    ids = np.zeros((n, tq), np.int64)
    ids[mask] = flat  # boolean scatter fills in C order == concat order

    sentinel = np.int64(np.iinfo(np.int64).max)
    skey = np.sort(np.where(mask, ids, sentinel), axis=1)
    valid = skey != sentinel
    is_first = valid.copy()
    is_first[:, 1:] &= skey[:, 1:] != skey[:, :-1]
    if not bool((valid & ~is_first).any()):
        return list(term_id_lists), None, False

    # left-pack each row's run heads; weight = run length (occurrences)
    dest = np.cumsum(is_first, axis=1) - 1  # every elem -> its run head's col
    cnt = is_first.sum(axis=1)
    tq2 = int(cnt.max())
    rows = np.repeat(np.arange(n), tq)
    f, v = is_first.ravel(), valid.ravel()
    uniq_ids = np.zeros((n, tq2), np.int64)
    uniq_ids[rows[f], dest.ravel()[f]] = skey.ravel()[f]
    wt = np.zeros((n, tq2), np.float32)
    np.add.at(wt, (rows[v], dest.ravel()[v]), 1.0)
    uniq = [uniq_ids[r, : cnt[r]] for r in range(n)]
    weights = [wt[r, : cnt[r]] for r in range(n)]
    return uniq, weights, True


def _pad_rows(term_id_lists: Sequence[np.ndarray],
              weight_lists: Optional[Sequence[np.ndarray]] = None):
    """Ragged rows -> ([N, TQ] int64 ids, [N, TQ] mask, [N, TQ] f32
    weights, 1.0 where absent or when ``weight_lists`` is None)."""
    n = len(term_id_lists)
    tq = max((len(i) for i in term_id_lists), default=1) or 1
    ids = np.zeros((n, tq), np.int64)
    mask = np.zeros((n, tq), bool)
    wt = np.ones((n, tq), np.float32)
    for r, row in enumerate(term_id_lists):
        m = len(row)
        if m:
            ids[r, :m] = row
            mask[r, :m] = True
            if weight_lists is not None:
                wt[r, :m] = weight_lists[r]
    return ids, mask, wt


def _weight_blocks(
    slot_rows: np.ndarray,  # [R, TQ] int: per-term slot widths (block-aligned)
    wt_rows: np.ndarray,  # [R, TQ] f32: per-term weights
    pad: int,
    block: int,
) -> np.ndarray:
    """Expand per-term weights into the [R, pad // block] per-block map the
    gathers consume: block b of row r carries the weight of the term whose
    slot covers it (tail blocks: 1.0)."""
    nblk = pad // block
    reps = (slot_rows // block).astype(np.int64)  # [R, TQ] blocks per term
    lengths = reps.sum(axis=1)  # [R] blocks used
    out = np.ones((slot_rows.shape[0], nblk), np.float32)
    flat_w = np.repeat(wt_rows.ravel(), reps.ravel())
    if flat_w.size:
        rowi = np.repeat(np.arange(slot_rows.shape[0]), lengths)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        coli = np.arange(flat_w.size) - np.repeat(starts, lengths)
        out[rowi, coli] = flat_w
    return out


def _pad_for_big(total: int, pad_short: int) -> int:
    """Width of an over-cap hybrid row: the smallest power of two that holds
    the long terms' ``total`` aligned slots and leaves ``pad_short`` columns
    at its end for the short tail (0 when the row has no long term)."""
    if total == 0:
        return 0
    pad = _next_pow2(total, MIN_PAD)
    while pad - pad_short < total:
        pad *= 2
    return pad


def _hybrid_rows(store, big_starts, big_lens, big_wtblk, short_src, short_rlen,
                 short_wt, *, pad_big: int, pad_short: int, sentinel: int, block: int):
    """The over-cap hybrid's [Q, pad_big] rows before their sort, and the
    ``k_start`` that sort may take. Long terms are gathered from the
    block-alternated store with their block weights; the short tail is
    packed into the last ``pad_short`` columns (slack the planner reserved:
    each row's long slots end before it). With ``pad_short >= 2 * block``
    and ``pad_big >= 4 * block`` the pass skip applies: the gather takes E
    or O per term, the tail is sorted in place to alternating blocks
    (``k_stop = block``), both widths are even multiples of ``block``, so
    every block of the row is sorted alternating and the sort starts at
    ``2 * block``. Port of ``_hybrid_gather_sort`` and ``_fold_short_tail``
    without their concatenate."""
    doc_e, imp_e, doc_o, imp_o, doc_c, imp_c = store[:6]
    skip = pad_short >= 2 * block and pad_big >= 4 * block
    doc, imp = postings_gather(
        doc_e, imp_e, big_starts, big_lens, pad=pad_big, sentinel=sentinel, block=block,
        doc_o=doc_o if skip else None, imp_o=imp_o if skip else None, wtblk=big_wtblk,
    )
    tail = (doc[:, pad_big - pad_short:], imp[:, pad_big - pad_short:])
    postings_assemble(doc_c, imp_c, short_src, short_rlen, short_wt,
                      pad=pad_short, sentinel=sentinel, out=tail)
    if skip:
        sort_pairs(*tail, k_stop=block, out=tail)
    return doc, imp, 2 * block if skip else 2


@dataclass
class BM25SearchResult:
    """Top-k per query."""

    doc_indices: np.ndarray  # [Q, k] int32, -1 for empty slots
    scores: np.ndarray  # [Q, k] f32


class BM25Engine:
    """Device-resident BM25 index + batched search.

    ``mode="bitonic"``: rows whose slot total is over ``max_pad`` (default
    ``BITONIC_MAX_PAD``, at most ``MAX_SORT_WIDTH``) run the over-cap
    hybrid, counted in ``last_stats["n_fallback"]``; rows over
    ``FALLBACK_MAX_PAD`` real postings keep their most selective terms
    (``n_trimmed``). Repeated query terms are searched once with an
    occurrence-count weight.

    ``mode="dma"``: every occurrence of a term is gathered from the aligned
    CSR; a row over ``max_pad`` aligned postings (default ``DMA_MAX_PAD``)
    keeps its most selective terms by aligned length, as the JAX engine
    does (``n_trimmed``). The aligned CSR takes every term a whole number of
    1024-blocks in device memory.

    ``last_widths`` holds, for the last search, the row widths each route
    ran and how many rows each.

    The planner reads per-term tables with a leading shard axis ([S, T]:
    posting lengths, aligned starts and lengths, compact starts), and
    routes, buckets and trims on the worst shard, so that every shard of a
    doc-sharded index takes the same decisions. This engine is one shard
    (S = 1); ``parallel/sharded_bm25.py::ShardedBM25Engine`` holds one of
    several and merges each chunk's top-k over the ranks (``_merge``)."""

    _shard = 0  # this engine's row of the [S, T] tables

    def __init__(self, index: BM25Index, device="cuda", *, mode: str = "bitonic",
                 max_pad: Optional[int] = None, q_tile: int = 256):
        if index.nnz >= 2**31:
            raise ValueError("single-shard postings exceed int32 indexing; shard the index")
        if mode == "xla":
            raise ValueError(
                "BM25Engine mode 'xla' is not ported: the engine on device='cpu' runs "
                "the kernels' plain PyTorch versions, which is that path"
            )
        if mode not in ("bitonic", "dma"):
            raise ValueError(f"unknown BM25 engine mode {mode!r}")
        self.index = index
        self.device = torch.device(device)
        self.mode = mode
        self.q_tile = q_tile
        self.analyzer = index.config.analyzer()
        self.last_stats = {"n_queries": 0, "n_fallback": 0, "n_trimmed": 0}
        self.last_widths: dict = {}
        put = self._put
        offsets, own = self._shard_csrs(index)
        sh_lens = offsets[:, 1:] - offsets[:, :-1]  # [S, T]
        if mode == "bitonic":
            self.max_pad = BITONIC_MAX_PAD if max_pad is None else max_pad
            if not 1 <= self.max_pad <= MAX_SORT_WIDTH:
                raise ValueError(f"max_pad must be in [1, {MAX_SORT_WIDTH}], got {self.max_pad}")
            st = build_bitonic_store(*own, sentinel=index.n_docs)
            self._store = st
            self._dev_store = tuple(
                put(a) for a in (st.doc_e, st.imp_e, st.doc_o, st.imp_o,
                                 st.doc_c, st.imp_c, st.doc_r, st.imp_r)
            )
            self._sh_lens = sh_lens
            self._sh_astart, self._sh_alen = bitonic_tables(sh_lens, st.min_len, st.block)
            self._sh_offs = offsets[:, :-1]
            self._sh_nnz = offsets[:, -1]
            # the over-cap trim's table: one kept term set on every shard
            self._term_lens = sh_lens.max(axis=0)
            return
        self.max_pad = DMA_MAX_PAD if max_pad is None else max_pad
        if self._bucket_pad(self.max_pad, base=4) > MAX_SORT_WIDTH:
            raise ValueError(f"max_pad {self.max_pad} buckets wider than {MAX_SORT_WIDTH}")
        a_offsets, doc, imp = align_csr(*own, sentinel=index.n_docs, alignment=ALIGNMENT)
        self._aligned_offsets = put(a_offsets)
        self._aligned = (put(doc), put(imp))
        # the worst shard's aligned lengths: the trim's and the buckets' table
        self._term_lens = align_up(sh_lens, ALIGNMENT).max(axis=0)

    def _shard_csrs(self, index: BM25Index):
        """([S, T+1] int64 term offsets of every shard, this engine's own
        (term offsets, postings doc, postings impact)): the whole index."""
        offsets = index.term_offsets.astype(np.int64)
        return offsets[None], (offsets, index.postings_doc, index.postings_impact)

    def _merge(self, scores: torch.Tensor, docs: torch.Tensor, k: int):
        """A chunk's top-k as it leaves the device (one shard: as it is)."""
        return scores, docs

    def _present(self, mask: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[S, N, TQ] slots that hold a term on each shard. Over several
        shards a term absent from one takes no slot there (JAX
        ``_plan_bitonic_shards``); one shard keeps a slot for every query
        term, as the JAX single engine does."""
        return mask[None] & (lens > 0) if lens.shape[0] > 1 else mask[None]

    # ------------------------------------------------------------ planning
    def _plan_bitonic(
        self,
        term_id_lists: Sequence[np.ndarray],
        weight_lists: Optional[Sequence[np.ndarray]] = None,
    ):
        """Per-(query, term) descriptors on this engine's shard: source
        offset (E/O store | compact), reversed-compact offset, slot width
        (aligned len for long terms, one block for short), real length,
        long-term flag; then the rows' slot totals on the worst shard and
        the [N, TQ] weight table (1.0 where absent). Never trims."""
        ids, mask, wt = _pad_rows(term_id_lists, weight_lists)
        lens = self._sh_lens[:, ids]  # [S, N, TQ]
        present = self._present(mask, lens)
        alen = self._sh_alen[:, ids]
        isbig = present & (alen > 0)
        slot = np.where(isbig, alen, np.where(present, self._store.block, 0))
        totals = slot.sum(axis=2).max(axis=0)

        s = self._shard
        big, here = isbig[s], present[s]
        starts = self._sh_offs[s, ids]
        src = np.where(big, self._sh_astart[s, ids], np.where(here, starts, 0))
        srcr = np.where(here & ~big, self._sh_nnz[s] - starts - lens[s], 0)
        i32 = lambda a: a.astype(np.int32)  # noqa: E731
        return (i32(src), i32(srcr), i32(slot[s]), i32(np.where(here, lens[s], 0)), i32(big),
                totals, wt)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_rows(self, plan, rows: Sequence[int], pad: int, k: int,
                  out_docs: np.ndarray, out_scores: np.ndarray) -> None:
        """Search planned rows ``rows`` at width ``pad`` in chunks."""
        src, srcr, slot, rlen, big, _, wt = plan
        block = self._store.block
        chunk = max(1, MAX_TILE_ELEMS // pad)
        put = self._put
        for start in range(0, len(rows), chunk):
            sel = np.asarray(rows[start : start + chunk])
            wtblk = put(_weight_blocks(slot[sel], wt[sel], pad, block))
            scores, docs = self._merge(*bm25_search_bitonic(
                self._dev_store,
                put(src[sel]), put(srcr[sel]), put(slot[sel]),
                put(rlen[sel]), put(big[sel]), wtblk,
                pad=pad, sentinel=self.index.n_docs, k=k, block=block,
            ), k)
            out_docs[sel] = docs.cpu().numpy()
            out_scores[sel] = scores.cpu().numpy()

    def _route(self, term_id_lists: Sequence[np.ndarray]):
        """Dedup, plan and route one batch: returns (term lists, weight
        lists or None, plan, over) where ``over`` marks the rows for the
        over-cap hybrid and rows over ``FALLBACK_MAX_PAD`` real postings
        (of the worst shard) are already trimmed. Sets ``last_stats``."""
        term_id_lists, weights, _ = _dedup_term_ids(term_id_lists)
        plan = self._plan_bitonic(term_id_lists, weights)
        # routed on the full slot totals, before any trim, as the JAX engine
        # routes (its bm25.py:484)
        over = plan[5] > self.max_pad
        # trim_to_cap changes only rows over the cap: find them vectorized
        # (a Python loop over every query would outweigh the rest of the
        # host planning). Under the default max_pad no bitonic row holds
        # that many postings, so only hybrid rows trim.
        ids, mask, _ = _pad_rows(term_id_lists)
        real = np.where(mask, self._term_lens[ids], 0).sum(axis=1)
        trim = np.nonzero(real > FALLBACK_MAX_PAD)[0]
        if len(trim) or over.any():
            term_id_lists = list(term_id_lists)
            weights = list(weights) if weights is not None else [
                np.ones(len(ids), np.float32) for ids in term_id_lists]
        for i in trim:
            ids = np.asarray(term_id_lists[i], np.int64)
            term_id_lists[i], weights[i], _, _ = trim_to_cap(
                self._term_lens, ids, FALLBACK_MAX_PAD, np.asarray(weights[i], np.float32))
        if len(trim) and not over[trim].all():
            plan = self._plan_bitonic(term_id_lists, weights)
        self.last_stats = {"n_queries": len(term_id_lists), "n_fallback": int(over.sum()),
                           "n_trimmed": len(trim)}
        return term_id_lists, weights, plan, over

    def _search_bitonic(self, term_id_lists: Sequence[np.ndarray], k: int) -> BM25SearchResult:
        term_id_lists, weights, plan, over = self._route(term_id_lists)
        n = len(term_id_lists)
        out_docs = np.full((n, k), -1, np.int32)
        out_scores = np.zeros((n, k), np.float32)
        buckets: dict = {}
        for i in np.nonzero(~over)[0]:
            # max_pad <= MAX_SORT_WIDTH, a power of two, bounds every pad
            pad = _next_pow2(max(int(plan[5][i]), 1), self._store.block)
            buckets.setdefault(pad, []).append(int(i))
        self.last_widths = {"bitonic": {p: len(r) for p, r in sorted(buckets.items())}}
        for pad, rows in sorted(buckets.items()):
            self._run_rows(plan, rows, pad, k, out_docs, out_scores)
        if over.any():
            rows = np.nonzero(over)[0]
            docs, scores = self._search_fallback(
                [term_id_lists[i] for i in rows], [weights[i] for i in rows], k)
            out_docs[rows] = docs
            out_scores[rows] = scores
        return BM25SearchResult(out_docs, out_scores)

    def _fallback_chunks(self, term_id_lists: Sequence[np.ndarray],
                         weight_lists: Sequence[np.ndarray]):
        """The over-cap hybrid's plan, for rows already trimmed to
        ``FALLBACK_MAX_PAD`` real postings: split into long terms (an aligned
        region in the store) and short ones, bucket by ``(pad_big,
        pad_short)`` of the worst shard with a ``2 * block`` floor on
        ``pad_short`` when long terms exist (keeps the fold seam on an even
        block), chunk by ``q_tile`` and by ``MAX_TILE_ELEMS``. Yields
        ``(rows, pad_big, pad_short, descriptors)``: this shard's long
        starts, aligned lengths and weights, short compact starts, lengths
        and weights, as [rows, TQ] arrays packed left. Port of the JAX
        engine's planner in ``_search_fallback``; a hybrid row is at most
        ``MAX_SORT_WIDTH`` wide (see there)."""
        block = self._store.block
        ids, mask, wt = _pad_rows(term_id_lists, weight_lists)
        lens = self._sh_lens[:, ids]  # [S, R, TQ]
        present = self._present(mask, lens)
        alen = self._sh_alen[:, ids]
        isbig = present & (alen > 0)
        short = present & ~isbig
        bt = np.where(isbig, alen, 0).sum(axis=2).max(axis=0)
        stot = np.where(short, lens, 0).sum(axis=2).max(axis=0)
        buckets: dict = {}
        for i in range(len(ids)):
            ps = _next_pow2(max(int(stot[i]), 1), max(2 * block, MIN_PAD) if bt[i] else MIN_PAD)
            buckets.setdefault((_pad_for_big(int(bt[i]), ps), ps), []).append(i)
        self.last_widths["hybrid"] = {key: len(r) for key, r in sorted(buckets.items())}
        s = self._shard
        isbig, short, lens, alen = isbig[s], short[s], lens[s], alen[s]
        a_start, offs = self._sh_astart[s], self._sh_offs[s]
        for (pad_big, pad_short), rows in sorted(buckets.items()):
            width = max(pad_big, pad_short)
            if width > MAX_SORT_WIDTH:  # ruled out by MAX_SORT_WIDTH's bound
                raise ValueError(f"over-cap row {width} wide, over {MAX_SORT_WIDTH}")
            nb, ns = isbig[rows].sum(axis=1), short[rows].sum(axis=1)
            tqb, tqs = max(int(nb.max()), 1), max(int(ns.max()), 1)
            chunk = min(self.q_tile, max(1, MAX_TILE_ELEMS // width))
            for start in range(0, len(rows), chunk):
                sel = rows[start : start + chunk]
                m = len(sel)
                bstarts = np.zeros((m, tqb), np.int32)
                blens = np.zeros((m, tqb), np.int32)
                bw = np.ones((m, tqb), np.float32)
                ssrc = np.zeros((m, tqs), np.int32)
                srlen = np.zeros((m, tqs), np.int32)
                sw = np.ones((m, tqs), np.float32)
                for r, i in enumerate(sel):
                    b, sh = isbig[i], short[i]
                    nb_i, ns_i = int(b.sum()), int(sh.sum())
                    bstarts[r, :nb_i] = a_start[ids[i, b]]
                    blens[r, :nb_i] = alen[i, b]
                    bw[r, :nb_i] = wt[i, b]
                    ssrc[r, :ns_i] = offs[ids[i, sh]]
                    srlen[r, :ns_i] = lens[i, sh]
                    sw[r, :ns_i] = wt[i, sh]
                yield sel, pad_big, pad_short, (bstarts, blens, bw, ssrc, srlen, sw)

    def _search_fallback(self, term_id_lists: Sequence[np.ndarray],
                         weight_lists: Sequence[np.ndarray], k: int):
        """The over-cap hybrid: per chunk of ``_fallback_chunks``, gather +
        assemble (``_hybrid_rows``; the assembly alone when no row of the
        bucket has a long term), sort, segment top-k. Returns ([N, k] doc
        ids, [N, k] scores)."""
        n = len(term_id_lists)
        out_docs = np.full((n, k), -1, np.int32)
        out_scores = np.zeros((n, k), np.float32)
        sentinel = self.index.n_docs
        block = self._store.block
        put = self._put
        for sel, pad_big, pad_short, desc in self._fallback_chunks(term_id_lists, weight_lists):
            bstarts, blens, bw, ssrc, srlen, sw = desc
            short = (put(ssrc), put(srlen), put(sw))
            if pad_big:
                doc, imp, k_start = _hybrid_rows(
                    self._dev_store, put(bstarts), put(blens),
                    put(_weight_blocks(blens, bw, pad_big, block)), *short,
                    pad_big=pad_big, pad_short=pad_short, sentinel=sentinel, block=block,
                )
            else:  # no long terms in this bucket
                doc, imp = postings_assemble(self._dev_store[4], self._dev_store[5], *short,
                                             pad=pad_short, sentinel=sentinel)
                k_start = 2
            doc, imp = sort_pairs(doc, imp, k_start=k_start)
            scores, docs = self._merge(*segment_topk(doc, imp, k=k, sentinel=sentinel), k)
            out_docs[sel] = docs.cpu().numpy()
            out_scores[sel] = scores.cpu().numpy()
        return out_docs, out_scores

    # ------------------------------------------------------------ dma mode
    def _bucket_pad(self, total: int, base: int = 2) -> int:
        """Smallest power-of-``base`` pad (at least ``MIN_PAD``) holding
        ``total`` aligned postings."""
        return (_next_pow2 if base == 2 else _next_pow4)(max(total, 1), MIN_PAD)

    def _search_group(self, term_id_lists: Sequence[np.ndarray], k: int, pad: int):
        """One chunk of the dma mode: trim each row to ``max_pad`` aligned
        postings of the worst shard (counted), pad the term axis, and run
        the fused search at ``pad``."""
        kept = []
        for ids in term_id_lists:
            ids, _, _, trimmed = trim_to_cap(
                self._term_lens, np.asarray(ids, np.int64), self.max_pad)
            kept.append(ids)
            self.last_stats["n_trimmed"] += int(trimmed)
        m = len(kept)
        tq = max((len(i) for i in kept), default=1) or 1
        qt = np.zeros((m, tq), np.int32)
        qm = np.zeros((m, tq), bool)
        for r, ids in enumerate(kept):
            qt[r, : len(ids)] = ids
            qm[r, : len(ids)] = True
        self.last_widths.setdefault("dma", {})
        self.last_widths["dma"][pad] = self.last_widths["dma"].get(pad, 0) + m
        scores, docs = self._merge(*bm25_search_padded_fused(
            self._aligned_offsets, *self._aligned, self._put(qt), self._put(qm),
            pad=pad, sentinel=self.index.n_docs, k=k,
        ), k)
        return docs.cpu().numpy(), scores.cpu().numpy()

    def _search_dma(self, term_id_lists: Sequence[np.ndarray], k: int, buckets: dict,
                    chunk_of) -> BM25SearchResult:
        n = len(term_id_lists)
        self.last_stats = {"n_queries": n, "n_fallback": 0, "n_trimmed": 0}
        self.last_widths = {}
        out_docs = np.full((n, k), -1, np.int32)
        out_scores = np.zeros((n, k), np.float32)
        for pad, rows in buckets.items():
            step = chunk_of(pad)
            for start in range(0, len(rows), step):
                sel = rows[start : start + step]
                docs, scores = self._search_group([term_id_lists[i] for i in sel], k, pad)
                out_docs[sel] = docs
                out_scores[sel] = scores
        return BM25SearchResult(out_docs, out_scores)

    # -------------------------------------------------------------- search
    def search_term_ids(self, term_id_lists: Sequence[np.ndarray], k: int = 5) -> BM25SearchResult:
        """Batched search. In dma mode queries are grouped by aligned
        posting mass (power-of-4 buckets, capped at ``max_pad``) and each
        group runs at its own width in chunks of ``q_tile``, as the JAX
        engine's ``search_term_ids``."""
        if self.mode == "bitonic":
            return self._search_bitonic(term_id_lists, k)
        buckets: dict = {}
        for i, ids in enumerate(term_id_lists):
            total = int(self._term_lens[np.asarray(ids, np.int64)].sum()) if len(ids) else 0
            buckets.setdefault(self._bucket_pad(min(total, self.max_pad), base=4), []).append(i)
        return self._search_dma(term_id_lists, k, dict(sorted(buckets.items())),
                                lambda pad: self.q_tile)

    def search_stream(self, term_id_lists: Sequence[np.ndarray], k: int = 5) -> BM25SearchResult:
        """Whole-stream search: in dma mode, power-of-2 buckets of the kept
        aligned totals, each in chunks of at most ``MAX_TILE_ELEMS`` slots
        (the JAX engine's ``search_stream``). The bitonic mode buckets its
        rows this way already."""
        if self.mode == "bitonic":
            return self._search_bitonic(term_id_lists, k)
        buckets: dict = {}
        for i, ids in enumerate(term_id_lists):
            _, _, total, _ = trim_to_cap(self._term_lens, np.asarray(ids, np.int64), self.max_pad)
            buckets.setdefault(self._bucket_pad(min(total, self.max_pad)), []).append(i)
        return self._search_dma(term_id_lists, k, dict(sorted(buckets.items())),
                                lambda pad: max(1, MAX_TILE_ELEMS // pad))

    def search(self, queries: Sequence[str], k: int = 5) -> BM25SearchResult:
        with RECORDER.span("retrieval.search", queries=len(queries)):
            with RECORDER.span("retrieval.analyze"):
                term_ids = [self.index.encode_query(self.analyzer(q)) for q in queries]
            return self.search_term_ids(term_ids, k=k)

    def retrieve(self, query: str, k: int = 5) -> List[int]:
        """Top-k doc row indices for one query (the exp_rag.py:426 call shape)."""
        result = self.search([query], k=k)
        return [int(d) for d in result.doc_indices[0] if d >= 0]
