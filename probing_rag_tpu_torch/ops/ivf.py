"""IVF probed search: each 8-query tile scores the store blocks named by its
descriptors and keeps a running top-k of document ids. A CUDA kernel and
its plain PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_ivf.py`` (``ivf_topk_pallas``, with
the semantics of ``ivf_topk_xla``). :func:`ivf_topk` launches
``kernels/csrc/ivf_topk.cu`` for CUDA tensors and takes
:func:`ivf_topk_plain` for CPU tensors; there is no other switch.

The store is cell-sorted and block-padded (``retrieval/ivf.py`` builds
it): ``[NB * block, D]`` rows, ids ``[NB * block]`` with -1 for pad rows,
the last block all pad. ``l2`` returns ``2 q.d - |d|^2`` (descending); the
engine adds ``|q|^2`` back. Ties rank by document id ascending. Empty slots
are (-inf, -1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from probing_rag_tpu_torch import kernels

QT = 8  # queries per tile
TOPK_MAX = 16  # kernels/csrc/common.cuh TOPK_MAX (the JAX K_PAD)
_MAX_PARTS = 1024  # topk_merge.cuh: partial lists per query, 32 * MERGE_LISTS
_MODES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
REGIMES = {"staged": 0, "wgmma": 1}
STAGED_BLOCKS_PER_SM = 4  # staged: the split over each tile's descriptors
PIECE = 64  # wgmma: rows of a work item (one warpgroup's M)
PIPES = 2  # wgmma: pipelines (partial lists) per block, one block per SM
STAGES = (3, 6)  # the ring's depth, fewest and most
SMEM_LIMIT = 232448  # the H100's opt-in shared memory per block (227 KB)


class IvfPlan(NamedTuple):
    """What :func:`plan_ivf` chose: the regime, ``nsplit`` blocks per tile
    (grid y) and their work items: wgmma, 64-row pieces (item i is piece i
    % pieces of descriptor i // pieces), block y taking items [y * items //
    nsplit, (y + 1) * items // nsplit), at most ``per_split``; staged,
    ``per_split`` descriptors each. ``lists`` partial lists per query, and
    for wgmma the ring's ``stages`` and the dynamic ``smem`` bytes."""

    regime: str
    pieces: int
    per_split: int
    nsplit: int
    lists: int
    stages: int = 0
    smem: int = 0


def _wgmma_smem(mode: int, d: int, stages: int) -> int:
    """ivf_topk.cu ``iw::layout(...).bytes``: the resident 8-query tile,
    then per pipeline its ring, lists, k-th entries, counters, candidate
    buffers and barriers rounded up to 1 KB, plus 1 KB to align the base."""
    chunks = -(-d // 64)
    a_bytes = PIECE * (64 if mode == _MODES[torch.int8] else 128)
    bars = stages * a_bytes + QT * TOPK_MAX * 8 + 3 * QT * 4 + 32 + QT * PIECE * 8
    pipe = -(-(bars + 2 * stages * 8) // 1024) * 1024
    return chunks * QT * 128 + PIPES * pipe + 1024


def plan_ivf(t: int, pb: int, block: int, d: int, dtype: torch.dtype, sm_count: int,
             ptrs) -> IvfPlan:
    """The launch of ``ivf_topk.cu`` for ``t`` tiles of ``pb`` descriptors
    over blocks of ``block`` rows of depth ``d`` in a ``dtype`` store, on a
    card of ``sm_count`` SMs, with the operands' data pointers ``ptrs``.

    wgmma where TMA can describe the store (bf16 or int8, a pitch that is
    a multiple of 16 bytes, 16-byte aligned pointers) and the most stages
    fit: each tile's (descriptor, 64-row piece) items are split into
    contiguous ranges, one block per SM (a whole number of waves), so that
    even one tile fills the card. staged otherwise: each tile's descriptor
    list in slices, about 4 blocks per SM."""
    mode = _MODES[dtype]
    pitch = d * torch.empty((), dtype=dtype).element_size()
    if dtype != torch.float32 and pitch % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        lo, hi = STAGES
        stages = next((s for s in range(hi, lo - 1, -1)
                       if _wgmma_smem(mode, d, s) <= SMEM_LIMIT), 0)
        if stages:
            pieces = -(-block // PIECE)
            items = pb * pieces
            waves = -(-t // sm_count)
            nsplit = max(1, min(items, _MAX_PARTS // PIPES, sm_count * waves // t))
            return IvfPlan("wgmma", pieces, -(-items // nsplit), nsplit, PIPES * nsplit, stages,
                           _wgmma_smem(mode, d, stages))
    nsplit = max(1, min(pb, _MAX_PARTS, -(-STAGED_BLOCKS_PER_SM * sm_count // max(t, 1))))
    per_split = max(1, -(-pb // nsplit))
    nsplit = max(1, -(-pb // per_split))
    return IvfPlan("staged", 1, per_split, nsplit, nsplit)


def _prepare(queries, desc, store, ids, *, k, metric, block, sq_norms, scales):
    """Checks; returns the queries in the sweep's dtype."""
    if not 1 <= k <= TOPK_MAX:
        raise ValueError(f"k must be in [1, {TOPK_MAX}], got {k}")
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if store.dtype not in _MODES:
        raise TypeError(f"store must be bf16, f32 or int8, got {store.dtype}")
    rows, d = store.shape
    if rows % block or queries.dim() != 2 or queries.shape[1] != d or queries.shape[0] % QT:
        raise ValueError(f"need [T*8, D] queries and a [NB*block, D] store, got "
                         f"{tuple(queries.shape)}, {tuple(store.shape)}, block {block}")
    if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[0] != queries.shape[0] // QT:
        raise ValueError(f"need [T, PB] int32 descriptors, got {desc.dtype} {tuple(desc.shape)}")
    if ids.dtype != torch.int32 or ids.shape != (rows,):
        raise ValueError(f"need [{rows}] int32 ids, got {ids.dtype} {tuple(ids.shape)}")
    int8 = store.dtype == torch.int8
    if int8 and (scales is None or scales.shape != (rows,)):
        raise ValueError("int8 IVF store needs [N] per-vector scales")
    if metric == "l2" and (sq_norms is None or sq_norms.shape != (rows,)):
        raise ValueError("l2 needs [N] squared norms")
    dev = store.device
    for name, t in (("queries", queries), ("desc", desc), ("ids", ids),
                    ("sq_norms", sq_norms), ("scales", scales)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, store on {dev}")
    # on the card the kernel skips descriptors outside the store as holes;
    # checking them here would sync the search with the host
    if dev.type == "cpu" and desc.numel():
        lo, hi = torch.aminmax(desc)
        if int(lo) < 0 or int(hi) >= rows // block:
            raise ValueError(f"descriptors must lie in [0, {rows // block}), got [{int(lo)}, {int(hi)}]")
    return queries.float() if store.dtype == torch.float32 else queries.to(torch.bfloat16)


def _topk_by_score_then_id(scores: torch.Tensor, gid: torch.Tensor, k: int):
    """Top-k of each row by (score desc, id asc); -1 ids where -inf."""
    order = torch.sort(gid, dim=1, stable=True).indices
    s = torch.gather(scores, 1, order)
    top, pos = torch.sort(s, dim=1, descending=True, stable=True)
    top = top[:, :k]
    out = torch.gather(torch.gather(gid, 1, order), 1, pos[:, :k])
    return top, torch.where(torch.isneginf(top), -1, out)


def _sweep_plain(qc, desc, store, ids, *, k, block, sq_norms, scales):
    """One tile at a time: gather its ``[PB, block, D]`` rows, score them,
    take the top k. Peak memory is one tile's gather."""
    t, pb = desc.shape
    d = store.shape[1]
    emb_b = store.view(-1, block, d)
    ids_b = ids.view(-1, block)
    vals, out = [], []
    for ti in range(t):
        dt = desc[ti].long()
        s = torch.einsum("qd,pbd->qpb", qc[ti * QT : (ti + 1) * QT].float(), emb_b[dt].float())
        if scales is not None:
            s = s * scales.view(-1, block)[dt][None]
        if sq_norms is not None:
            s = 2.0 * s - sq_norms.view(-1, block)[dt][None]
        idr = ids_b[dt]  # [PB, block]
        s = torch.where(idr[None] >= 0, s, float("-inf")).reshape(QT, pb * block)
        gid = idr.reshape(1, -1).expand(QT, -1)
        v, i = _topk_by_score_then_id(s, gid, min(k, pb * block))
        if v.shape[1] < k:  # fewer rows than k: pad the tail empty
            v = torch.cat([v, v.new_full((QT, k - v.shape[1]), float("-inf"))], 1)
            i = torch.cat([i, i.new_full((QT, k - i.shape[1]), -1)], 1)
        vals.append(v)
        out.append(i)
    if not vals:
        return qc.new_empty((0, k), dtype=torch.float32), desc.new_empty((0, k))
    return torch.cat(vals), torch.cat(out).to(torch.int32)


last_plan: Optional[IvfPlan] = None  # the plan of the last kernel launch


def _sweep_kernel(qc, desc, store, ids, *, k, block, sq_norms, scales):
    global last_plan
    t, pb = desc.shape
    rows, d = store.shape
    dev = store.device
    if not all(x is None or x.is_contiguous() for x in (qc, desc, store, ids, sq_norms, scales)):
        raise ValueError("ivf_topk kernel needs contiguous tensors")
    out_v = torch.empty((t * QT, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((t * QT, k), dtype=torch.int32, device=dev)
    if t == 0:
        return out_v, out_i
    plan = plan_ivf(t, pb, block, d, store.dtype, kernels.sm_count(dev),
                    (qc.data_ptr(), store.data_ptr()))
    part_v = torch.empty((plan.lists, t * QT, TOPK_MAX), dtype=torch.float32, device=dev)
    part_i = torch.empty((plan.lists, t * QT, TOPK_MAX), dtype=torch.int32, device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.ivf_topk(
                qc.data_ptr(), desc.data_ptr(), store.data_ptr(), ids.data_ptr(),
                ptr(sq_norms), ptr(scales), _MODES[store.dtype], REGIMES[plan.regime], t, pb,
                plan.pieces, plan.per_split, plan.nsplit, block, d, rows // block - 1, k,
                plan.stages, plan.smem, part_v.data_ptr(), part_i.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), kernels.stream_ptr(dev),
            ),
            "ivf_topk",
        )
    kernels.LAUNCHES["ivf_topk"] += 1
    last_plan = plan
    return out_v, out_i


def _ivf_topk(sweep, queries, desc, store, ids, *, k, metric, block, sq_norms, scales):
    qc = _prepare(queries, desc, store, ids, k=k, metric=metric, block=block,
                  sq_norms=sq_norms, scales=scales)
    return sweep(qc, desc, store, ids, k=k, block=block,
                 sq_norms=sq_norms if metric == "l2" else None,
                 scales=scales if store.dtype == torch.int8 else None)


def ivf_topk_plain(
    queries: torch.Tensor,  # [T*8, D] tile-padded queries
    desc: torch.Tensor,  # [T, PB] int32 block indices (holes -> the pad block)
    store: torch.Tensor,  # [NB*block, D] bf16 | f32 | int8
    ids: torch.Tensor,  # [NB*block] int32 doc ids (-1 = pad row)
    *,
    k: int,
    metric: str = "ip",
    block: int = 256,
    sq_norms: Optional[torch.Tensor] = None,  # [NB*block] f32 (l2)
    scales: Optional[torch.Tensor] = None,  # [NB*block] f32 (int8)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ivf_topk`: gather, einsum and a sort per
    tile (the semantics of ``ivf_topk_xla``)."""
    return _ivf_topk(_sweep_plain, queries, desc, store, ids, k=k, metric=metric,
                     block=block, sq_norms=sq_norms, scales=scales)


def ivf_topk(
    queries: torch.Tensor,
    desc: torch.Tensor,
    store: torch.Tensor,
    ids: torch.Tensor,
    *,
    k: int,
    metric: str = "ip",
    block: int = 256,
    sq_norms: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [T*8, k] f32, doc ids [T*8, k] int32) over each
    tile's probed blocks. Queries are cast to bf16 for bf16 and int8
    stores. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    dev = store.device
    if dev.type == "cpu":
        sweep = _sweep_plain
    elif dev.type == "cuda":
        sweep = _sweep_kernel
    else:
        raise ValueError(f"no IVF top-k for device {dev}")
    return _ivf_topk(sweep, queries, desc, store, ids, k=k, metric=metric, block=block,
                     sq_norms=sq_norms, scales=scales)
