"""Process layout, LM tensor-parallel layout, and the collective top-k merge.

Port of ``probing_rag_tpu/parallel/mesh.py`` onto ``torch.distributed``.
JAX runs one process over a device mesh and lets GSPMD (``shard_map``,
``NamedSharding``) place the work; here each shard is a process (a rank)
holding only its own slice, and the collectives are written out:

- mesh dims ``dp`` (batch rows) x ``tp`` (the LM's tensor parallelism).
  Retrieval indexes shard their rows over the whole mesh (``dp`` x ``tp``
  flattened, shard = the rank's place in it); k is tiny, so the merge is
  one small ``all_gather`` (:func:`merge_shard_topk`).
- LM TP layout (``lm_param_shardings``): Megatron-style, ``wq``/``w_gate``
  /``w_up`` split by column, ``wo``/``w_down`` by row, embeddings and an
  untied head by vocab, ``wk``/``wv`` replicated (multi-query attention).
  ``models/gemma.py::forward(tp=...)`` ends each row-split product in an
  ``all_reduce``.

:func:`run_ranks` starts one process per rank (``torch.multiprocessing.
spawn``, a ``file://`` rendezvous). The backend is always the caller's:
``"nccl"`` for ranks on separate cards, ``"gloo"`` for the CPU and for
ranks sharing one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from probing_rag_tpu_torch.models.gemma import GemmaConfig, Params

AXES = ("dp", "tp")
# how long a rank waits in a collective for the others (their set-up, such
# as loading an index, runs before their first collective)
COLLECTIVE_TIMEOUT_S = 600.0

# The split dim of each LM leaf family over ``tp``, written as the JAX
# package's PartitionSpecs: one entry per dim of the stacked leaf, "tp"
# where it splits (mesh.py:44-58). Leaves not named are replicated.
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("tp", None),  # [V, D] by vocab (lookup and tied head)
    "wq": (None, None, "tp"),  # [L, D, H*hd] by column (query heads)
    "wo": (None, "tp", None),  # [L, H*hd, D] by row
    "w_gate": (None, None, "tp"),  # [L, D, F]
    "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None),  # [L, F, D]
    "lm_head": (None, "tp"),  # [D, V] by vocab (untied heads)
}
# the leaves of a quantized weight: each takes its weight's rule
_QUANT_LEAVES = ("q", "qp", "s", "gs", "rs")


def make_mesh(shape: Optional[Tuple[int, int]], device: str):
    """A ``(dp, tp)`` DeviceMesh over the initialized process group's
    ranks (rank r at ``divmod(r, tp)``). With no ``shape``, ``tp`` is the
    largest power of two up to ``min(4, world // 2)`` dividing the world
    size (the JAX rule). ``device``: the ranks' device type ("cpu" or
    "cuda"), always the caller's."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if shape is None:
        tp = 1
        while tp * 2 <= min(4, n // 2) and n % (tp * 2) == 0:
            tp *= 2
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} != {n} ranks")
    dev_type = torch.device(device).type
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape), mesh_dim_names=AXES)


def mesh_shard(mesh) -> Tuple[int, int]:
    """(this rank's shard, the number of shards) when an index shards its
    rows over the whole mesh. The merge runs over the default group, so the
    mesh must hold every rank."""
    n = mesh.size()
    if n != dist.get_world_size():
        raise ValueError(f"a sharded index spans the whole world: mesh of {n} ranks, "
                         f"world of {dist.get_world_size()}")
    return mesh.mesh.flatten().tolist().index(dist.get_rank()), n


def _split_dim(name: str, shape, tp: int) -> Optional[int]:
    """The dim of a leaf ``name`` of ``shape`` split over ``tp`` ranks, or
    None: the rule's dim, dropped where the rule does not fit the leaf's
    rank or the split does not divide the dim (JAX mesh.py:60-77)."""
    spec = _RULES.get(name)
    if spec is None or len(spec) != len(shape):
        return None
    for i, a in enumerate(spec):
        if a == "tp" and shape[i] % tp == 0:
            return i
    return None


def lm_param_shardings(params: Params, tp: int) -> Params:
    """Per leaf of the Gemma parameter tree (plain or quantized), the dim
    split over ``tp`` ranks, or None where the leaf is replicated: the
    JAX ``lm_param_shardings`` rules, with a quantized leaf (``q``, ``qp``,
    ``s``, ``gs``, ``rs``) taking its weight's rule."""

    def walk(tree, parent: str):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, name)
            else:
                rule = parent if name in _QUANT_LEAVES else name
                out[name] = _split_dim(rule, tuple(leaf.shape), tp)
        return out

    return walk(params, "")


def _check_splits(params: Params, dims: Params, tp: int, path: str = "") -> None:
    """Every leaf a rule names must split along it, but for size-1 scale
    dims (broadcast, replicated): the TP forward's collectives assume the
    whole layout, and a grouped or rank-1 int4 scale left whole beside a
    split weight would put a group across a shard boundary."""
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            _check_splits(leaf, dims[name], tp, f"{path}{name}/")
            continue
        rule = path.rstrip("/").split("/")[-1] if name in _QUANT_LEAVES else name
        spec = _RULES.get(rule)
        if spec is None or dims[name] is not None:
            continue
        i = spec.index("tp")
        if len(spec) != leaf.dim() or leaf.shape[i] != 1:
            raise ValueError(f"{path}{name} {tuple(leaf.shape)}: dim {i} does not split over "
                             f"tp {tp} (for int4, the group size must divide the shard)")


def shard_lm_params(params: Params, mesh) -> Params:
    """This rank's slices of ``params`` on the mesh's ``tp`` dim, as
    contiguous copies (the caller may free the whole tree). Raises where a
    split the forward needs does not divide its leaf."""
    tp = mesh["tp"].size()
    rank = mesh.get_local_rank("tp")
    dims = lm_param_shardings(params, tp)
    if tp > 1:
        _check_splits(params, dims, tp)

    def take(tree, dtree):
        out = {}
        for name, leaf in tree.items():
            d = dtree[name]
            if isinstance(leaf, dict):
                out[name] = take(leaf, d)
            elif d is None:
                out[name] = leaf
            else:
                part = leaf.shape[d] // tp
                out[name] = leaf.narrow(d, rank * part, part).contiguous()
        return out

    return take(params, dims)


def mqa_safe_tp(cfg: GemmaConfig, tp: int) -> bool:
    """Whether the TP forward can serve ``cfg`` at ``tp``: multi-query
    attention (one kv head, replicated) always; grouped-query when the kv
    heads split evenly with the query heads."""
    return cfg.n_kv_heads == 1 or cfg.n_kv_heads % tp == 0


def merge_shard_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """The k-per-shard ``all_gather`` merge shared by the sharded engines,
    over the default group: every rank's [Q, k] (scores, global ids) -> the
    global top-k, the same on every rank. Pad slots (``idx < 0``) rank below every hit; rows with
    no hit return 0 / -1. Equal scores keep the lower shard and slot first
    (a stable sort, as ``jax.lax.top_k``). Port of ``_merge_shard_topk``
    (JAX sharded_bm25.py:36-51)."""
    n = dist.get_world_size()
    scores = scores.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    all_s = [torch.empty_like(scores) for _ in range(n)]
    all_i = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(all_s, scores)
    dist.all_gather(all_i, idx)
    flat_s = torch.cat(all_s, dim=1)  # [Q, S*k], shard-major as the JAX transpose
    flat_i = torch.cat(all_i, dim=1)
    flat_s = torch.where(flat_i >= 0, flat_s, float("-inf"))
    top, pos = torch.sort(flat_s, dim=1, descending=True, stable=True)
    top, pos = top[:, :k], pos[:, :k]
    top_i = torch.gather(flat_i, 1, pos)
    hit = torch.isfinite(top)
    return torch.where(hit, top, 0.0), torch.where(hit, top_i, -1)


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, device: str,
               workdir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # eager communicator: collectives can be graph-captured
    dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
    try:
        out = fn(rank, world_size, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, world_size: int, backend: str, device: str, *args) -> list:
    """Runs ``fn(rank, world_size, device, *args)`` in ``world_size``
    spawned processes inside an initialized process group of ``backend``
    and returns each rank's return value (pickled through a file of a
    temporary directory, which also holds the rendezvous file).

    ``device``: "cpu"; "cuda" for one card per rank (rank r on cuda:r);
    or one card for every rank, e.g. "cuda:0" (gloo only). ``fn`` and
    ``args`` must pickle (a module-level function; small arguments: each
    rank makes its own data). A rank that raises makes this raise."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl needs one card per rank (device='cuda'); ranks sharing "
                         "one card or on the CPU use gloo")
    with tempfile.TemporaryDirectory(prefix="ranks") as workdir:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, backend, device, workdir, args),
            nprocs=world_size, join=True)
        out: list[Any] = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
