"""Sharded retrieval and LM tensor parallelism over ``torch.distributed``:
one process (rank) a shard. Port of ``probing_rag_tpu/parallel``."""

from probing_rag_tpu_torch.parallel.mesh import (
    lm_param_shardings,
    make_mesh,
    merge_shard_topk,
    run_ranks,
    shard_lm_params,
)
from probing_rag_tpu_torch.parallel.sharded_bm25 import ShardedBM25Engine
from probing_rag_tpu_torch.parallel.sharded_dense import sharded_dense_topk
from probing_rag_tpu_torch.parallel.sharded_ivf import ShardedIVFEngine

__all__ = [
    "ShardedBM25Engine",
    "ShardedIVFEngine",
    "lm_param_shardings",
    "make_mesh",
    "merge_shard_topk",
    "run_ranks",
    "shard_lm_params",
    "sharded_dense_topk",
]
