"""BM25 search engine: host analysis and planning + device scoring through
the CUDA gather -> sort -> segment top-k chain.

Port of the bitonic mode of ``probing_rag_tpu/retrieval/bm25.py::
BM25Engine``. Queries are analyzed on the host (the same chain as index
build), repeated terms are collapsed into weights, and each query is
planned into per-(query, term) slot descriptors over the block-alternated
store (``bm25_index.BitonicStore``). Rows are bucketed by power-of-two width
and each bucket chunk runs ``ops.sparse.bm25_search_bitonic``.

Every row first keeps its most selective terms up to ``FALLBACK_MAX_PAD``
real postings (``trim_to_cap``, the JAX engine's over-cap rule). A row of at
most 512K slots holds fewer real postings than that, so the trim only ever
changes the JAX engine's over-cap rows; those run through the same kernels
at the width they need, up to ``ops.sort.MAX_SORT_WIDTH``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.ops.sort import MAX_SORT_WIDTH
from probing_rag_tpu_torch.ops.sparse import bm25_search_bitonic
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index

# bound on one chunk's [rows, pad] tile (device memory, not results)
MAX_TILE_ELEMS = 1 << 26
# real postings a query keeps (the JAX engine's ``fallback_max_pad``)
FALLBACK_MAX_PAD = 1 << 20


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
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


def _weight_blocks(
    slot_rows: np.ndarray,  # [R, TQ] int: per-term slot widths (block-aligned)
    wt_rows: np.ndarray,  # [R, TQ] f32: per-term weights
    pad: int,
    block: int,
) -> np.ndarray:
    """Expand per-term weights into the [R, pad // block] per-block map the
    gather consumes: block b of row r carries the weight of the term whose
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


@dataclass
class BM25SearchResult:
    """Top-k per query."""

    doc_indices: np.ndarray  # [Q, k] int32, -1 for empty slots
    scores: np.ndarray  # [Q, k] f32


class BM25Engine:
    """Device-resident BM25 index + batched search.

    Rows over ``FALLBACK_MAX_PAD`` real postings are trimmed to their most
    selective terms (counted in ``last_stats``); every row is searched at
    its own power-of-two width. Repeated query terms are searched once with
    an occurrence-count weight."""

    def __init__(self, index: BM25Index, device="cuda"):
        if index.nnz >= 2**31:
            raise ValueError("single-shard postings exceed int32 indexing; shard the index")
        self.index = index
        self.device = torch.device(device)
        self.analyzer = index.config.analyzer()
        self.last_stats = {"n_queries": 0, "n_trimmed": 0}
        st = index.bitonic_csr()
        self._store = st
        self._dev_store = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (
                st.doc_e, st.imp_e, st.doc_o, st.imp_o,
                st.doc_c, st.imp_c, st.doc_r, st.imp_r,
            )
        )
        self._term_lens = (index.term_offsets[1:] - index.term_offsets[:-1]).astype(np.int64)
        self._compact_offsets = index.term_offsets[:-1].astype(np.int64)

    # ------------------------------------------------------------ planning
    def _plan_bitonic(
        self,
        term_id_lists: Sequence[np.ndarray],
        weight_lists: Optional[Sequence[np.ndarray]] = None,
    ):
        """Per-(query, term) descriptors: source offset (E/O store | compact),
        reversed-compact offset, slot width (aligned len for long terms, one
        block for short), real length, long-term flag, row slot totals and
        the [N, TQ] weight table (1.0 where absent). Never trims."""
        st = self._store
        block = st.block
        a_start, a_len = st.aligned_start, st.aligned_len
        n = len(term_id_lists)
        tq = max((len(i) for i in term_id_lists), default=1) or 1
        ids = np.zeros((n, tq), np.int64)
        mask = np.zeros((n, tq), bool)
        wt = np.ones((n, tq), np.float32)
        for r, row in enumerate(term_id_lists):  # ragged -> padded (cheap)
            m = len(row)
            if m:
                ids[r, :m] = row
                mask[r, :m] = True
                if weight_lists is not None:
                    wt[r, :m] = weight_lists[r]

        lens = np.where(mask, self._term_lens[ids], 0)
        alens = np.where(mask, a_len[ids], 0)
        isbig = alens > 0
        slot = np.where(isbig, alens, np.where(mask, block, 0)).astype(np.int64)
        totals = slot.sum(axis=1)

        starts = np.where(mask, self._compact_offsets[ids], 0)
        src = np.where(isbig, a_start[ids], starts).astype(np.int32)
        srcr = np.where(isbig | ~mask, 0, st.nnz - starts - lens).astype(np.int32)
        return (
            src,
            srcr,
            slot.astype(np.int32),
            lens.astype(np.int32),
            isbig.astype(np.int32),
            totals,
            wt,
        )

    def _run_rows(self, plan, rows: Sequence[int], pad: int, k: int,
                  out_docs: np.ndarray, out_scores: np.ndarray) -> None:
        """Search planned rows ``rows`` at width ``pad`` in chunks."""
        src, srcr, slot, rlen, big, _, wt = plan
        block = self._store.block
        chunk = max(1, MAX_TILE_ELEMS // pad)
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for start in range(0, len(rows), chunk):
            sel = np.asarray(rows[start : start + chunk])
            wtblk = put(_weight_blocks(slot[sel], wt[sel], pad, block))
            scores, docs = bm25_search_bitonic(
                self._dev_store,
                put(src[sel]), put(srcr[sel]), put(slot[sel]),
                put(rlen[sel]), put(big[sel]), wtblk,
                pad=pad, sentinel=self.index.n_docs, k=k, block=block,
            )
            out_docs[sel] = docs.cpu().numpy()
            out_scores[sel] = scores.cpu().numpy()

    def _search_bitonic(self, term_id_lists: Sequence[np.ndarray], k: int) -> BM25SearchResult:
        term_id_lists, weights, _ = _dedup_term_ids(term_id_lists)
        n = len(term_id_lists)
        plan = self._plan_bitonic(term_id_lists, weights)
        # trim_to_cap changes only rows over the cap: find them from the
        # plan's real lengths (a Python loop over every query would
        # outweigh the rest of the host planning) and plan again with those
        # rows trimmed
        over = np.nonzero(plan[3].sum(axis=1, dtype=np.int64) > FALLBACK_MAX_PAD)[0]
        if len(over):
            term_id_lists = list(term_id_lists)
            if weights is None:
                weights = [np.ones(len(ids), np.float32) for ids in term_id_lists]
            weights = list(weights)
            for i in over:
                ids = np.asarray(term_id_lists[i], np.int64)
                w = np.asarray(weights[i], np.float32)
                term_id_lists[i], weights[i], _, _ = trim_to_cap(
                    self._term_lens, ids, FALLBACK_MAX_PAD, w)
            plan = self._plan_bitonic(term_id_lists, weights)
        self.last_stats = {"n_queries": n, "n_trimmed": len(over)}
        out_docs = np.full((n, k), -1, np.int32)
        out_scores = np.zeros((n, k), np.float32)
        buckets: dict = {}
        for i, total in enumerate(plan[5]):
            pad = _next_pow2(max(int(total), 1), self._store.block)
            if pad > MAX_SORT_WIDTH:
                raise ValueError(
                    f"query needs {int(total)} posting slots after trimming, "
                    f"over the {MAX_SORT_WIDTH}-slot sort width"
                )
            buckets.setdefault(pad, []).append(i)
        for pad, rows in sorted(buckets.items()):
            self._run_rows(plan, rows, pad, k, out_docs, out_scores)
        return BM25SearchResult(out_docs, out_scores)

    # -------------------------------------------------------------- search
    def search_term_ids(self, term_id_lists: Sequence[np.ndarray], k: int = 5) -> BM25SearchResult:
        return self._search_bitonic(term_id_lists, k)

    def search(self, queries: Sequence[str], k: int = 5) -> BM25SearchResult:
        term_ids = [self.index.encode_query(self.analyzer(q)) for q in queries]
        return self.search_term_ids(term_ids, k=k)

    def retrieve(self, query: str, k: int = 5) -> List[int]:
        """Top-k doc row indices for one query (the exp_rag.py:426 call shape)."""
        result = self.search([query], k=k)
        return [int(d) for d in result.doc_indices[0] if d >= 0]
