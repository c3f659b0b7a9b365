"""Row-sharded flat dense search.

Port of ``probing_rag_tpu/parallel/sharded_dense.py``. The store's rows
(documents) split into one contiguous range a shard, of sizes differing by
at most one (the remainder goes one row each to the leading shards:
:func:`shard_rows`, the JAX balanced split). Each rank holds only its own
rows, ranks them on ``ops/dense.py::dense_topk`` (the ``dense_topk.cu``
kernel on the card), turns its local ids into global ones and joins the
k-per-shard ``all_gather`` merge (``mesh.merge_shard_topk``).

JAX pads every shard to one row count (one array over the mesh), ranks
``k + 1`` where a shard carries a pad row and drops that row before the
merge, so that a pad row's 0.0 score never evicts a real candidate. Here a
rank's store is its real rows and nothing else: there is no pad row to
rank past or to drop, and every real score, negative ones included,
competes only with real rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from probing_rag_tpu_torch.ops.dense import PreparedDenseStore, dense_topk
from probing_rag_tpu_torch.parallel.mesh import merge_shard_topk


def shard_rows(n: int, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """The balanced split of ``n`` rows: ([S] first global row of each
    shard, [S] rows of each shard), counts ``n // S`` or ``n // S + 1``."""
    counts = np.full(n_shards, n // n_shards, np.int64)
    counts[: n % n_shards] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return offsets, counts


def sharded_dense_topk(
    queries: torch.Tensor,  # [Q, D], the same on every rank
    store: PreparedDenseStore,  # this rank's rows (prepare_dense_store of its slice)
    *,
    k: int,
    offset: int,  # global id of the store's first row (shard_rows)
    metric: str = "ip",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over every rank's rows: (scores [Q, k] f32, global ids
    [Q, k] int32), the same on every rank. Scores are the
    single-device ``dense_topk``'s (l2: squared distances, ascending). An
    int8 store carries its per-row scales in ``store``."""
    vals, idx = dense_topk(queries, store.embeddings, k=min(k, max(store.n_docs, 1)),
                           metric=metric, sq_norms=store.sq_norms, scales=store.scales,
                           n_total=store.n_docs, k_pad=max(16, k))
    gidx = torch.where(idx >= 0, idx + offset, -1)
    sign = -1.0 if metric == "l2" else 1.0  # the merge keeps the largest
    if vals.shape[1] < k:  # fewer rows than k on this shard: pad the list
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_zeros((vals.shape[0], pad))], 1)
        gidx = torch.cat([gidx, gidx.new_full((gidx.shape[0], pad), -1)], 1)
    top, ids = merge_shard_topk(vals * sign, gidx, k)
    return top * sign, ids
