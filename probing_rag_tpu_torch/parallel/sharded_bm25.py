"""Doc-sharded BM25 search with the collective top-k merge.

Port of ``probing_rag_tpu/parallel/sharded_bm25.py`` (modes ``"bitonic"``
and ``"dma"``). The postings split by doc range into one CSR sub-index a
shard (:func:`shard_index_by_docs`); doc ids stay global, and every shard
uses the global ``n_docs`` as its sentinel. Each rank builds and holds
only its own shard's device store and runs the single engine's search on
it (``retrieval/bm25.py::BM25Engine``: the bitonic search, the over-cap
hybrid, the dma mode's fused search); each chunk's top-k then joins the
k-per-shard ``all_gather`` merge (``mesh.merge_shard_topk``).

Every rank must take the same routing, bucketing and trimming decisions,
or the merge compares unlike things. The single engine's planner reads
per-term tables of every shard ([S, T]; cheap, from the sub-indexes'
offsets) and decides on the worst shard: a row goes to the over-cap hybrid
when its slot total on the worst shard is over ``max_pad``, rows over
``FALLBACK_MAX_PAD`` postings trim against the worst shard's lengths (one
kept term set on every shard), and the dma mode trims against the worst
shard's aligned lengths.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from probing_rag_tpu_torch.parallel.mesh import merge_shard_topk, mesh_shard
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index


def shard_index_by_docs(index: BM25Index, n_shards: int):
    """Split a CSR index into per-doc-range sub-CSRs (host, build time).

    Returns stacked arrays: term_offsets [S, T+1] int32, postings_doc [S,
    NNZmax] int32 (global doc ids), postings_impact [S, NNZmax] f32, each
    shard's tail padded with (n_docs, 0). Equal to the JAX function's."""
    n_docs = index.n_docs
    bounds = np.linspace(0, n_docs, n_shards + 1).astype(np.int64)
    t = index.n_terms
    doc = index.postings_doc
    imp = index.postings_impact
    offs = index.term_offsets.astype(np.int64)
    term_lens = offs[1:] - offs[:-1]
    # postings are doc-sorted within a term, so the (term, doc) key is sorted
    # over the whole array: each shard's cut of every term is one searchsorted
    stride = np.int64(n_docs) + 1
    key = np.repeat(np.arange(t, dtype=np.int64), term_lens) * stride + doc.astype(np.int64)
    term_base = np.arange(t, dtype=np.int64) * stride
    cuts = np.stack([np.searchsorted(key, term_base + b) for b in bounds])  # [S+1, T]
    per_shard: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for s in range(n_shards):
        starts, lens = cuts[s], cuts[s + 1] - cuts[s]
        new_offs = np.zeros(t + 1, np.int64)
        np.cumsum(lens, out=new_offs[1:])
        nnz = int(new_offs[-1])
        pos = np.arange(nnz, dtype=np.int64) - np.repeat(new_offs[:-1], lens) + np.repeat(starts, lens)
        per_shard.append((new_offs, doc[pos], imp[pos]))
    nnz_max = max(1, max(p[1].size for p in per_shard))
    offsets = np.stack([p[0] for p in per_shard]).astype(np.int32)
    docs = np.full((n_shards, nnz_max), n_docs, np.int32)
    imps = np.zeros((n_shards, nnz_max), np.float32)
    for s, (_, d, i) in enumerate(per_shard):
        docs[s, : d.size] = d
        imps[s, : i.size] = i
    return offsets, docs, imps


class ShardedBM25Engine(BM25Engine):
    """BM25 over an index doc-sharded across every rank of ``mesh``: the
    single engine (its modes, ``max_pad``, dedup, ``last_stats`` and
    ``last_widths``) on this rank's shard, with the decisions taken on the
    worst shard and each chunk's top-k merged over the ranks. Every rank
    calls ``search`` with the same queries and gets the same result."""

    def __init__(self, index: BM25Index, mesh, device="cuda", *, mode: str = "bitonic",
                 max_pad: Optional[int] = None, q_tile: int = 256):
        self.mesh = mesh
        super().__init__(index, device, mode=mode, max_pad=max_pad, q_tile=q_tile)

    def _shard_csrs(self, index: BM25Index):
        self._shard, self.n_shards = mesh_shard(self.mesh)
        offsets, docs, imps = shard_index_by_docs(index, self.n_shards)
        s = self._shard
        nnz = int(offsets[s, -1])
        offsets = offsets.astype(np.int64)
        return offsets, (offsets[s], docs[s, :nnz], imps[s, :nnz])

    def _merge(self, scores, docs, k: int):
        return merge_shard_topk(scores, docs, k)
