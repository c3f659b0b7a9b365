"""IVF dense index: k-means coarse quantizer + cell-sorted block store +
probed search (faiss ``IndexIVFFlat`` parity).

Port of ``probing_rag_tpu/retrieval/ivf.py``. Training is batched Lloyd
iterations on the engine's device (matmul + argmin, ``index_add_`` for the
centroid sums), with the numpy ``default_rng(seed)`` calls of the JAX
package in the same order, so one seed picks the same points. Storage is
one ``[NB*block, D]`` matrix sorted by cell, each cell padded to a
``block``-row multiple (pad rows: id -1, zero vector), plus a trailing
all-pad block for plan holes; same ``<path>.npz``/``<path>.json`` files.
Planning is vectorized numpy: the 8 queries of a tile probe the union of
their cells, deduplicated, expanded into block descriptors. Search runs
``ops.ivf.ivf_topk``; the coarse quantizer runs ``ops.dense.dense_topk`` on
the f32 centroids.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from probing_rag_tpu_torch.ops.dense import MAX_K_PAD, dense_topk, prepare_dense_store
from probing_rag_tpu_torch.ops.ivf import QT, ivf_topk
from probing_rag_tpu_torch.retrieval.dense import DenseSearchResult


def _next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _min_d2_update(xd: torch.Tensor, cd: torch.Tensor, mind2: torch.Tensor) -> torch.Tensor:
    d2 = (xd * xd).sum(-1)[:, None] - 2.0 * (xd @ cd.T) + (cd * cd).sum(-1)[None, :]
    return torch.minimum(mind2, d2.min(dim=-1).values)


def _kmeanspp_init(x: np.ndarray, nlist: int, rng, device="cuda") -> np.ndarray:
    """Batched k-means++ seeding: candidates are drawn in rounds of
    ``nlist // 16`` in proportion to the current min squared distance."""
    n = x.shape[0]
    xd = torch.from_numpy(x).to(device)
    first = x[rng.integers(n)][None]
    chosen = [first]
    inf = torch.full((n,), float("inf"), device=device)
    mind2 = _min_d2_update(xd, torch.from_numpy(first).to(device), inf).cpu().numpy()
    per_round = max(1, nlist // 16)
    while sum(c.shape[0] for c in chosen) < nlist:
        take = min(per_round, nlist - sum(c.shape[0] for c in chosen))
        p = np.maximum(mind2, 0)
        tot = p.sum()
        # fewer nonzero-probability points than ``take`` (degenerate
        # corpora): draw uniformly, as the JAX package does
        if tot <= 0 or int((p > 0).sum()) < take:
            picks = rng.choice(n, take, replace=False)
        else:
            picks = rng.choice(n, take, replace=False, p=p / tot)
        batch = x[picks]
        chosen.append(batch)
        mind2 = _min_d2_update(
            xd, torch.from_numpy(batch).to(device), torch.from_numpy(mind2).to(device)
        ).cpu().numpy()
    return np.concatenate(chosen)[:nlist].copy()


def kmeans(
    x: np.ndarray,  # [N, D] f32 training vectors
    nlist: int,
    *,
    iters: int = 10,
    seed: int = 0,
    sample_per_list: int = 64,  # training points capped at nlist * this
    chunk: int = 65536,
    device="cuda",
) -> np.ndarray:
    """Lloyd's k-means for the coarse quantizer. Returns [nlist, D] f32.
    Empty cells are reseeded from random training points."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    if nlist > n:
        raise ValueError(f"nlist={nlist} > n_train={n}")
    cap = nlist * sample_per_list
    if n > cap:
        x = x[rng.choice(n, cap, replace=False)]
        n = cap
    x = np.ascontiguousarray(x, np.float32)
    cent = _kmeanspp_init(x, nlist, rng, device)
    xd = torch.from_numpy(x).to(device)
    for _ in range(iters):
        c = torch.from_numpy(cent).to(device)
        csq = (c * c).sum(-1)[None, :]
        sums = torch.zeros((nlist, x.shape[1]), dtype=torch.float32, device=device)
        cnts = torch.zeros((nlist,), dtype=torch.float32, device=device)
        for s0 in range(0, n, chunk):
            xc = xd[s0 : s0 + chunk]
            # |x|^2 is constant per row for the argmin
            a = torch.argmin(csq - 2.0 * (xc @ c.T), dim=-1)
            sums.index_add_(0, a, xc)
            cnts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
        sums, cnts = sums.cpu().numpy(), cnts.cpu().numpy()
        empty = cnts == 0
        cent = sums / np.maximum(cnts, 1.0)[:, None]
        if empty.any():
            cent[empty] = x[rng.choice(n, int(empty.sum()), replace=False)]
    return cent


def assign_cells(x: np.ndarray, centroids: np.ndarray, chunk: int = 65536,
                 device="cuda") -> np.ndarray:
    """Nearest-centroid cell id per vector ([N] int32), in chunks."""
    c = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    csq = (c * c).sum(-1)[None, :]
    x = np.asarray(x, np.float32)
    out = [
        torch.argmin(csq - 2.0 * (torch.from_numpy(x[s0 : s0 + chunk]).to(device) @ c.T), dim=-1)
        .to(torch.int32).cpu().numpy()
        for s0 in range(0, x.shape[0], chunk)
    ]
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


@dataclass
class IVFDenseIndex:
    """Cell-sorted, block-padded dense store + coarse quantizer.

    ``emb_blocked``/``ids_blocked`` include the trailing all-pad block
    (``pad_block`` is its block index); ``list_block_start[l]`` /
    ``list_nblocks[l]`` locate cell ``l``'s blocks. ``ids_blocked`` maps
    each stored row back to its original doc index (-1 = pad row)."""

    centroids: np.ndarray  # [nlist, D] f32
    emb_blocked: np.ndarray  # [(NB+1)*block, D] f32 master copy
    ids_blocked: np.ndarray  # [(NB+1)*block] int32
    list_block_start: np.ndarray  # [nlist] int32 (block units)
    list_nblocks: np.ndarray  # [nlist] int32
    metric: str
    block: int
    n_docs: int

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def pad_block(self) -> int:
        return self.emb_blocked.shape[0] // self.block - 1

    def imbalance_factor(self) -> float:
        """faiss's quantizer balance diagnostic ``nlist * sum(n_i^2) / N^2``
        (1.0 = perfectly balanced cells)."""
        cell_of_block = np.repeat(np.arange(self.nlist), self.list_nblocks)
        blk = np.nonzero(self.ids_blocked >= 0)[0] // self.block
        counts = np.bincount(cell_of_block[blk], minlength=self.nlist)
        return float(self.nlist * np.sum(counts.astype(np.float64) ** 2)
                     / max(self.n_docs, 1) ** 2)

    @staticmethod
    def default_nlist(n_docs: int) -> int:
        # ~2*sqrt(N) rounded to pow2, capped so the average cell still
        # fills a few hundred rows
        return int(min(_next_pow2(max(2.0 * np.sqrt(n_docs), 8)), 65536,
                       _next_pow2(max(n_docs // 64, 8))))

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,  # [N, D]
        *,
        nlist: Optional[int] = None,
        block: int = 256,
        metric: str = "l2",
        seed: int = 0,
        iters: int = 10,
        device="cuda",  # where k-means and the cell assignment run
    ) -> "IVFDenseIndex":
        emb = np.ascontiguousarray(embeddings, np.float32)
        n, d = emb.shape
        nlist = nlist or cls.default_nlist(n)
        cent = kmeans(emb, nlist, iters=iters, seed=seed, device=device)
        cells = assign_cells(emb, cent, device=device)

        order = np.argsort(cells, kind="stable")
        counts = np.bincount(cells, minlength=nlist)
        nblocks = -(-counts // block)  # 0 for empty cells
        starts = np.concatenate([[0], np.cumsum(nblocks[:-1])]).astype(np.int32)
        nb_tot = int(nblocks.sum())

        emb_blocked = np.zeros(((nb_tot + 1) * block, d), np.float32)
        ids_blocked = np.full(((nb_tot + 1) * block,), -1, np.int32)
        # dest row = the cell's first block * block + rank within the cell
        cell_sorted = cells[order]
        cell_first = np.concatenate([[0], np.cumsum(counts[:-1])])
        rank = np.arange(n) - cell_first[cell_sorted]
        dest = starts[cell_sorted].astype(np.int64) * block + rank
        emb_blocked[dest] = emb[order]
        ids_blocked[dest] = order.astype(np.int32)
        return cls(cent, emb_blocked, ids_blocked, starts,
                   nblocks.astype(np.int32), metric, block, n)

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path.with_suffix(".npz"),
            centroids=self.centroids,
            emb_blocked=self.emb_blocked,
            ids_blocked=self.ids_blocked,
            list_block_start=self.list_block_start,
            list_nblocks=self.list_nblocks,
        )
        path.with_suffix(".json").write_text(
            json.dumps({"metric": self.metric, "block": self.block, "n_docs": self.n_docs})
        )

    @classmethod
    def load(cls, path: Path) -> "IVFDenseIndex":
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        z = np.load(path.with_suffix(".npz"))
        return cls(z["centroids"], z["emb_blocked"], z["ids_blocked"],
                   z["list_block_start"], z["list_nblocks"],
                   meta["metric"], meta["block"], meta["n_docs"])


def host_store_prep(emb: np.ndarray, metric: str, store_dtype: torch.dtype, device="cuda"):
    """Store preparation: SQ8 per-vector quantization (int8) or a cast,
    and the l2 squared norms of the stored (rounded or dequantized)
    vectors. Runs on ``device``. Returns ``(store, scales | None,
    sq_norms | None)``, each ``[N]`` f32 where present."""
    x = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(device)
    store, sqn, scales, _ = prepare_dense_store(x, metric=metric, store_dtype=store_dtype)
    return store, scales, sqn


def probe_cells_host(query_emb, centroids: torch.Tensor, cent_sqn: torch.Tensor,
                     nprobe: int, nlist: int) -> np.ndarray:
    """[Q, nprobe] nearest-centroid cell ids (the coarse quantizer).

    Cells are ranked by L2 distance to the centroids for both metrics:
    docs were assigned to their L2-nearest centroid (``assign_cells``), so
    the probe must use the same geometry (faiss ``IndexIVFFlat`` over an
    ``IndexFlatL2`` quantizer).

    Up to ``MAX_K_PAD`` cells the probe runs on ``dense_topk``; a wider
    probe ranks the full ``[Q, nlist]`` row of ``2 q.c - |c|^2`` (the same
    key) by a stable sort, ties by cell id ascending, as the JAX probe's
    ``matmul_topk`` does in XLA."""
    k = int(min(nprobe, nlist))
    q = torch.as_tensor(np.asarray(query_emb, np.float32)).to(centroids.device)
    if k <= MAX_K_PAD:
        _, idx = dense_topk(q, centroids, k=k, metric="l2", sq_norms=cent_sqn, k_pad=max(16, k))
    else:
        key = 2.0 * (q @ centroids.T) - cent_sqn[None, :]
        idx = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    return idx.to(torch.int32).cpu().numpy()


def tile_union(probes: np.ndarray):
    """Pad queries to 8-row tiles and dedup each tile's probed cells.

    Returns ``(tiles [T, 8*nprobe] sorted cell ids, keep mask, t)``."""
    q = probes.shape[0]
    t = -(-q // QT)
    if t * QT != q:  # tile-pad with the first query's probes
        probes = np.concatenate(
            [probes, np.broadcast_to(probes[:1], (t * QT - q, probes.shape[1]))]
        )
    tiles = np.sort(probes.reshape(t, -1), axis=1)
    keep = np.ones_like(tiles, bool)
    keep[:, 1:] = tiles[:, 1:] != tiles[:, :-1]
    return tiles, keep, t


def expand_tile_blocks(starts: np.ndarray, nb: np.ndarray, pb: int,
                       pad_block: int) -> np.ndarray:
    """Ragged cell->block expansion (repeat/cumsum): cell j of tile row i
    contributes blocks ``starts[i,j] + 0..nb[i,j]-1``, packed left; holes
    point at ``pad_block``. Returns [T, PB] int32."""
    t = nb.shape[0]
    nb = nb.astype(np.int64)
    starts = starts.astype(np.int64)
    desc = np.full((t, pb), pad_block, np.int32)
    nbf = nb.ravel()
    total = int(nbf.sum())
    if total:
        reps = np.repeat(np.arange(nbf.size), nbf)
        offs = np.arange(total) - np.repeat(np.cumsum(nbf) - nbf, nbf)
        blocks = starts.ravel()[reps] + offs
        tile_of = reps // nb.shape[1]
        per_tile = nb.sum(axis=1)
        tile_first = np.concatenate([[0], np.cumsum(per_tile[:-1])])
        pos = np.arange(total) - np.repeat(tile_first, per_tile)
        desc[tile_of, pos] = blocks.astype(np.int32)
    return desc


class IVFEngine:
    """Device-resident IVF search. ``nprobe`` cells per query; the 8
    queries of a tile probe their cells' union."""

    def __init__(
        self,
        index: IVFDenseIndex,
        nprobe: int = 32,
        encode_fn=None,  # texts -> [Q, D] embeddings (query encoder)
        device="cuda",
        store_dtype: Optional[torch.dtype] = None,  # default bf16; torch.int8 for SQ8
    ):
        self.index = index
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        self.nprobe = int(min(nprobe, index.nlist))
        store_dtype = torch.bfloat16 if store_dtype is None else store_dtype
        self._emb, self._scales, self._sqn = host_store_prep(
            index.emb_blocked, index.metric, store_dtype, self.device
        )
        self._ids = torch.from_numpy(np.ascontiguousarray(index.ids_blocked)).to(self.device)
        self._cent, self._cent_sqn, _, _ = prepare_dense_store(
            torch.from_numpy(np.asarray(index.centroids, np.float32)).to(self.device),
            metric="l2",
        )

    def probe_cells(self, query_emb: np.ndarray, nprobe: Optional[int] = None) -> np.ndarray:
        return probe_cells_host(query_emb, self._cent, self._cent_sqn,
                                nprobe or self.nprobe, self.index.nlist)

    def plan(self, probes: np.ndarray) -> np.ndarray:
        """[Q, nprobe] cell ids -> [T, PB] block descriptors (per-tile
        union, deduplicated, holes -> the pad block; PB is the pow2 bucket
        of the widest tile)."""
        ix = self.index
        tiles, keep, _ = tile_union(probes)
        nb = np.where(keep, ix.list_nblocks[tiles], 0).astype(np.int64)
        per_tile = nb.sum(axis=1)
        pb = _next_pow2(int(per_tile.max()) if per_tile.max() > 0 else 1, 8)
        return expand_tile_blocks(ix.list_block_start[tiles], nb, pb, ix.pad_block)

    def search_embeddings(self, query_emb: np.ndarray, k: int = 5,
                          nprobe: Optional[int] = None) -> DenseSearchResult:
        q = np.asarray(query_emb, np.float32)
        nq = q.shape[0]
        desc = self.plan(self.probe_cells(q, nprobe))
        t = desc.shape[0]
        qpad = q
        if t * QT != nq:
            qpad = np.concatenate([q, np.broadcast_to(q[:1], (t * QT - nq, q.shape[1]))])
        qd = torch.from_numpy(np.ascontiguousarray(qpad)).to(self.device)
        vals, idx = ivf_topk(
            qd, torch.from_numpy(desc).to(self.device), self._emb, self._ids,
            k=k, metric=self.index.metric, block=self.index.block,
            sq_norms=self._sqn, scales=self._scales,
        )
        vals, idx = vals[:nq], idx[:nq]
        if self.index.metric == "l2":
            # |q|^2 of the f32 queries: ascending squared distance
            vals = -vals + (qd[:nq] ** 2).sum(-1, keepdim=True)
        return DenseSearchResult(idx.cpu().numpy(), vals.cpu().numpy())

    def search(self, queries, k: int = 5) -> DenseSearchResult:
        """Text-query search (the pipeline's retriever contract)."""
        if self.encode_fn is None:
            raise ValueError("IVFEngine needs encode_fn to search raw text")
        return self.search_embeddings(np.asarray(self.encode_fn(list(queries))), k=k)
