"""Cell-sharded IVF dense search.

Port of ``probing_rag_tpu/parallel/sharded_ivf.py``. The IVF store
(``retrieval/ivf.py``) shards by coarse cell: cells go to shards by greedy
block-count balancing (:func:`shard_ivf_layout`), each rank keeps only its
own cells' blocks as a local cell-sorted store (:func:`shard_blocks`, one
trailing all-pad block for plan holes), and a query's probed cells fan out
to whichever shards own them. Each rank runs the single-device block
top-k (``ops/ivf.py::ivf_topk``, the ``ivf_topk.cu`` kernel on the card)
over its probed local blocks; the k-per-shard ``all_gather`` merge
(``mesh.merge_shard_topk``) gives the global top-k, exact because stored
ids are global doc ids and every candidate lives on exactly one shard.

Cell-sharding keeps a probed cell's blocks contiguous on one rank, so the
per-shard plan is the single-device plan filtered by ownership
(:meth:`ShardedIVFEngine.plan`, one ``PB`` bucket shared by every shard).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from probing_rag_tpu_torch.ops.dense import prepare_dense_store
from probing_rag_tpu_torch.ops.ivf import QT, ivf_topk
from probing_rag_tpu_torch.parallel.mesh import merge_shard_topk, mesh_shard
from probing_rag_tpu_torch.retrieval.dense import DenseSearchResult
from probing_rag_tpu_torch.retrieval.ivf import (
    IVFDenseIndex,
    _next_pow2,
    expand_tile_blocks,
    host_store_prep,
    probe_cells_host,
    tile_union,
)


class ShardedIVFLayout(NamedTuple):
    owner: np.ndarray  # [nlist] int32 shard of each cell
    local_start: np.ndarray  # [nlist] int32 cell's first block in its shard (block units)
    nb_max: int  # real blocks on the fullest shard (its pad block excluded)


def shard_ivf_layout(index: IVFDenseIndex, n_shards: int) -> ShardedIVFLayout:
    """Greedy balanced cell -> shard assignment (LPT: cells by descending
    block count, each to the least-loaded shard; worst shard <= 4/3 of the
    optimum). Every shard's store has ``nb_max + 1`` blocks (the last one
    all pad). JAX ``shard_ivf_layout``'s tables; its stacked store is
    :func:`shard_blocks` over every shard."""
    nb = index.list_nblocks.astype(np.int64)
    owner = np.zeros(index.nlist, np.int32)
    local_start = np.zeros(index.nlist, np.int32)
    load = np.zeros(n_shards, np.int64)
    for c in np.argsort(-nb, kind="stable"):
        s = int(np.argmin(load))
        owner[c] = s
        local_start[c] = load[s]
        load[s] += nb[c]
    return ShardedIVFLayout(owner, local_start, int(load.max()))


def shard_blocks(index: IVFDenseIndex, lay: ShardedIVFLayout,
                 shard: int) -> Tuple[np.ndarray, np.ndarray]:
    """One shard's block store: ([(nb_max+1)*block, D] f32 rows, zeros in
    pad rows; [(nb_max+1)*block] int32 global doc ids, -1 in pad rows)."""
    block, d = index.block, index.emb_blocked.shape[1]
    rows = (lay.nb_max + 1) * block
    emb = np.zeros((rows, d), np.float32)
    ids = np.full((rows,), -1, np.int32)
    cells = np.nonzero(lay.owner == shard)[0]
    nb = index.list_nblocks[cells].astype(np.int64)
    # block p of cell c: global block start[c] + p -> local block local_start[c] + p
    cell_of = np.repeat(np.arange(cells.size), nb)
    p = np.arange(cell_of.size) - np.repeat(np.cumsum(nb) - nb, nb)
    src_b = index.list_block_start[cells][cell_of].astype(np.int64) + p
    dst_b = lay.local_start[cells][cell_of].astype(np.int64) + p
    src = (src_b[:, None] * block + np.arange(block)).ravel()
    dst = (dst_b[:, None] * block + np.arange(block)).ravel()
    emb[dst] = index.emb_blocked[src]
    ids[dst] = index.ids_blocked[src]
    return emb, ids


class ShardedIVFEngine:
    """IVF search with the store cell-sharded over every rank of ``mesh``.
    Results equal the single-device ``IVFEngine``'s on the same index: the
    same probe plan and candidate set, the score of a candidate computed by
    the same kernel on the same stored vector."""

    def __init__(
        self,
        index: IVFDenseIndex,
        mesh,
        nprobe: int = 32,
        encode_fn=None,  # texts -> [Q, D] embeddings (query encoder)
        device="cuda",
        store_dtype: Optional[torch.dtype] = None,  # default bf16; torch.int8 for SQ8
    ):
        self.index = index
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        self.nprobe = int(min(nprobe, index.nlist))
        self.shard, self.n_shards = mesh_shard(mesh)
        self._lay = shard_ivf_layout(index, self.n_shards)
        emb, ids = shard_blocks(index, self._lay, self.shard)
        store_dtype = torch.bfloat16 if store_dtype is None else store_dtype
        # the single engine's store preparation, on this shard's rows
        self._emb, self._scales, self._sqn = host_store_prep(emb, index.metric, store_dtype,
                                                              self.device)
        self._ids = torch.from_numpy(ids).to(self.device)
        self._cent, self._cent_sqn, _, _ = prepare_dense_store(
            torch.from_numpy(np.asarray(index.centroids, np.float32)).to(self.device),
            metric="l2",
        )

    def probe_cells(self, query_emb: np.ndarray) -> np.ndarray:
        return probe_cells_host(query_emb, self._cent, self._cent_sqn, self.nprobe,
                                self.index.nlist)

    def plan(self, probes: np.ndarray) -> np.ndarray:
        """[Q, nprobe] cell ids -> [S, T, PB] local block descriptors, one
        [T, PB] table a shard: each tile's probed cells (deduplicated) that
        the shard owns, holes pointing at the shard's pad block. PB is the
        power-of-two bucket (at least 8) of the widest (shard, tile), shared
        by every shard."""
        ix, lay = self.index, self._lay
        tiles, keep, _ = tile_union(probes)
        own = lay.owner[tiles]
        nb_all = ix.list_nblocks[tiles].astype(np.int64)
        per = [np.where(keep & (own == s), nb_all, 0) for s in range(self.n_shards)]
        widest = max(int(nb.sum(axis=1).max()) for nb in per)
        pb = _next_pow2(max(widest, 1), 8)
        starts = lay.local_start[tiles]
        return np.stack([expand_tile_blocks(starts, nb, pb, lay.nb_max) for nb in per])

    def search_embeddings(self, query_emb: np.ndarray, k: int = 5) -> DenseSearchResult:
        """Global top-k, the same on every rank."""
        q = np.asarray(query_emb, np.float32)
        nq = q.shape[0]
        desc = self.plan(self.probe_cells(q))[self.shard]
        t = desc.shape[0]
        qpad = q
        if t * QT != nq:
            qpad = np.concatenate([q, np.broadcast_to(q[:1], (t * QT - nq, q.shape[1]))])
        qd = torch.from_numpy(np.ascontiguousarray(qpad)).to(self.device)
        # the kernel's raw scores rank best-first for both metrics (l2 as
        # 2 q.d - |d|^2): the merge needs no sign flip
        vals, gids = ivf_topk(
            qd, torch.from_numpy(desc).to(self.device), self._emb, self._ids,
            k=k, metric=self.index.metric, block=self.index.block,
            sq_norms=self._sqn, scales=self._scales,
        )
        vals, gids = merge_shard_topk(vals[:nq], gids[:nq], k)
        if self.index.metric == "l2":
            vals = -vals + (qd[:nq] ** 2).sum(-1, keepdim=True)
        return DenseSearchResult(gids.cpu().numpy(), vals.cpu().numpy())

    def search(self, queries, k: int = 5) -> DenseSearchResult:
        """Text-query search (the single engine's retriever contract)."""
        if self.encode_fn is None:
            raise ValueError("ShardedIVFEngine needs encode_fn to search raw text")
        return self.search_embeddings(np.asarray(self.encode_fn(list(queries))), k=k)
