"""BM25 search over the bitonic postings store: gather -> sort -> segment
top-k, each a CUDA kernel with its plain PyTorch version beside it.

Port of ``probing_rag_tpu/ops/pallas_sparse.py::bm25_search_bitonic`` and
``segment_topk_pallas`` (with ``ops/sparse.py::sorted_segment_topk``'s
contract). The wrappers take the plain version for CPU tensors and launch
the kernel for CUDA tensors; there is no other switch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.ops.sort import sort_pairs

TOPK_MAX = 16  # kernels/csrc/common.cuh TOPK_MAX

# ------------------------------------------------------------------ gather


def _check_gather(store, desc, wtblk, pad: int, block: int) -> None:
    if len(store) != 8:
        raise ValueError("store is (doc_e, imp_e, doc_o, imp_o, doc_c, imp_c, doc_r, imp_r)")
    dev = desc[0].device
    for i, a in enumerate(store):
        want = torch.int32 if i % 2 == 0 else torch.float32
        if a.dtype != want or a.dim() != 1 or a.device != dev:
            raise ValueError(f"store array {i}: need 1-D {want} on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    shape = desc[0].shape
    for a in desc:
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape != shape or a.device != dev:
            raise ValueError(f"descriptors: need [Q, TQ] int32 on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if pad < block or pad % block:
        raise ValueError(f"pad ({pad}) must be a multiple of block ({block})")
    if wtblk is not None and (
        wtblk.dtype != torch.float32 or wtblk.shape != (shape[0], pad // block) or wtblk.device != dev
    ):
        raise ValueError(f"wtblk: need [{shape[0]}, {pad // block}] f32 on {dev}")
    arrays = (*store, *desc) + ((wtblk,) if wtblk is not None else ())
    if dev.type == "cuda" and not all(a.is_contiguous() for a in arrays):
        raise ValueError("bm25_gather needs contiguous arrays")


def bm25_gather_plain(
    store: Sequence[torch.Tensor],
    src, srcr, slot, rlen, big, wtblk: Optional[torch.Tensor],
    *, pad: int, block: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the gather by torch indexing: find each block's
    owning term slot, then read the E/O, compact or reversed copy."""
    doc_e, imp_e, doc_o, imp_o, doc_c, imp_c, doc_r, imp_r = store
    q = src.shape[0]
    dev = src.device
    slot64 = slot.long()
    cum = torch.cumsum(slot64, dim=1) - slot64
    end = cum + slot64
    total = end[:, -1:] if q else end[:, :0]
    nblk = pad // block
    b0 = (torch.arange(nblk, device=dev) * block).expand(q, nblk).contiguous()
    t = torch.searchsorted(end.contiguous(), b0, right=True).clamp(max=src.shape[1] - 1)
    valid = b0 < total  # [Q, nblk]

    def at(a):  # descriptor of each block's owning term, [Q, nblk, 1]
        return torch.gather(a.long(), 1, t)[..., None]

    c, s, sr, L, isbig = at(cum), at(src), at(srcr), at(rlen), at(big) > 0
    odd = (c // block) % 2 == 1
    lane = torch.arange(block, device=dev)[None, None, :]
    # long terms: the aligned region from the E or O copy
    big_idx = s + (b0[..., None] - c) + lane
    # short terms: compact copy at the head (even) / reversed at the tail (odd)
    lead = block - L
    short_in = torch.where(odd, lane >= lead, lane < L)
    short_idx = torch.where(odd, sr + lane - lead, s + lane)

    def pick(e, o, cpt, rev):
        nb = e.numel()
        bi = big_idx.clamp(0, nb - 1)
        si = short_idx.clamp(0, cpt.numel() - 1)
        from_big = torch.where(odd, o[bi], e[bi])
        from_short = torch.where(odd, rev[si], cpt[si])
        return torch.where(isbig, from_big, from_short)

    keep = valid[..., None] & (isbig | short_in)
    doc = torch.where(keep, pick(doc_e, doc_o, doc_c, doc_r), sentinel).to(torch.int32)
    imp = torch.where(keep, pick(imp_e, imp_o, imp_c, imp_r), 0.0)
    if wtblk is not None:
        imp = imp * wtblk[..., None]
    return doc.reshape(q, pad), imp.reshape(q, pad).to(torch.float32)


def bm25_gather(
    store: Sequence[torch.Tensor],  # 8 x 1-D store arrays (BitonicStore order)
    src: torch.Tensor,  # [Q, TQ] int32: E/O offset (long) | compact offset (short)
    srcr: torch.Tensor,  # [Q, TQ] int32: reversed-compact offset (short terms)
    slot: torch.Tensor,  # [Q, TQ] int32: slot width (aligned len | block | 0)
    rlen: torch.Tensor,  # [Q, TQ] int32: real posting count
    big: torch.Tensor,  # [Q, TQ] int32: long-term flag
    wtblk: Optional[torch.Tensor] = None,  # [Q, pad // block] f32 block weights
    *, pad: int, block: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble each query's postings into a [Q, pad] (doc int32, impact f32)
    row whose every ``block`` is sorted, ascending at even block index and
    descending at odd; slots past the row total hold (sentinel, 0).
    ``wtblk`` scales each block's impacts (term-dedup weights)."""
    desc = (src, srcr, slot, rlen, big)
    _check_gather(store, desc, wtblk, pad, block)
    dev = src.device
    if dev.type == "cpu":
        return bm25_gather_plain(
            store, *desc, wtblk, pad=pad, block=block, sentinel=sentinel
        )
    if dev.type != "cuda":
        raise ValueError(f"no gather for device {dev}")
    q, tq = src.shape
    out_doc = torch.empty((q, pad), dtype=torch.int32, device=dev)
    out_imp = torch.empty((q, pad), dtype=torch.float32, device=dev)
    if q == 0:
        return out_doc, out_imp
    cum = (torch.cumsum(slot, dim=1, dtype=torch.int32) - slot).contiguous()
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.bm25_gather(
                *(a.data_ptr() for a in store),
                *(a.data_ptr() for a in desc), cum.data_ptr(),
                wtblk.data_ptr() if wtblk is not None else None,
                q, tq, pad, block, sentinel,
                out_doc.data_ptr(), out_imp.data_ptr(), kernels.stream_ptr(dev),
            ),
            "bm25_gather",
        )
    kernels.LAUNCHES["bm25_gather"] += 1
    return out_doc, out_imp


# ------------------------------------------------------------ segment top-k


def segment_topk_plain(
    doc: torch.Tensor, imp: torch.Tensor, *, k: int, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: run sums by ``scatter_add_`` over run indices, then
    the top-k ranked by (score desc, doc id asc)."""
    q, p = doc.shape
    head = torch.ones_like(doc, dtype=torch.bool)
    head[:, 1:] = doc[:, 1:] != doc[:, :-1]
    run = torch.cumsum(head.long(), dim=1) - 1  # run index of each slot
    sums = torch.zeros((q, p), dtype=torch.float32, device=doc.device)
    sums.scatter_add_(1, run, imp)
    run_doc = torch.full((q, p), sentinel, dtype=torch.int32, device=doc.device)
    run_doc.scatter_(1, run, doc)  # unused run slots keep the sentinel
    # runs are in ascending doc order, so a stable descending sort ranks
    # equal scores by doc id ascending
    vals = torch.where(run_doc != sentinel, sums, float("-inf"))
    kk = min(k, p)
    top, order = torch.sort(vals, dim=1, descending=True, stable=True)
    top, order = top[:, :kk], order[:, :kk]
    ids = torch.gather(run_doc, 1, order)
    hit = torch.isfinite(top)
    out_v = torch.zeros((q, k), dtype=torch.float32, device=doc.device)
    out_i = torch.full((q, k), -1, dtype=torch.int32, device=doc.device)
    out_v[:, :kk] = torch.where(hit, top, 0.0)
    out_i[:, :kk] = torch.where(hit, ids, -1)
    return out_v, out_i


def segment_topk(
    doc: torch.Tensor,  # [Q, P] int32, sorted ascending per row
    imp: torch.Tensor,  # [Q, P] f32
    *, k: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of run sums over sorted postings. Returns (scores
    [Q, k] f32, 0 where empty; doc ids [Q, k] int32, -1 where empty).
    Ranking: score descending, then doc id ascending."""
    if doc.dtype != torch.int32 or imp.dtype != torch.float32:
        raise TypeError(f"need int32 docs and f32 impacts, got {doc.dtype}, {imp.dtype}")
    if doc.dim() != 2 or doc.shape != imp.shape or doc.device != imp.device:
        raise ValueError(f"need matching [Q, P] rows, got {tuple(doc.shape)}, {tuple(imp.shape)}")
    if not 1 <= k <= TOPK_MAX:
        raise ValueError(f"k must be in [1, {TOPK_MAX}], got {k}")
    if doc.device.type == "cpu":
        return segment_topk_plain(doc, imp, k=k, sentinel=sentinel)
    if doc.device.type != "cuda":
        raise ValueError(f"no segment top-k for device {doc.device}")
    if not (doc.is_contiguous() and imp.is_contiguous()):
        raise ValueError("segment_topk needs contiguous rows")
    q, p = doc.shape
    out_v = torch.empty((q, k), dtype=torch.float32, device=doc.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=doc.device)
    if q == 0:
        return out_v, out_i
    lib = kernels.library()
    with torch.cuda.device(doc.device):
        kernels.check(
            lib.segment_topk(
                doc.data_ptr(), imp.data_ptr(), q, p, k, sentinel,
                out_v.data_ptr(), out_i.data_ptr(), kernels.stream_ptr(doc.device),
            ),
            "segment_topk",
        )
    kernels.LAUNCHES["segment_topk"] += 1
    return out_v, out_i


# ---------------------------------------------------------------- chained


def bm25_search_bitonic(
    store: Sequence[torch.Tensor],
    src, srcr, slot, rlen, big, wtblk: Optional[torch.Tensor] = None,
    *, pad: int, sentinel: int, k: int, block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather (every block sorted, alternating) -> bitonic sort starting at
    pass ``2 * block`` -> run sums + top-k. ``pad`` is a power of two >=
    the largest row total. Returns (scores [Q, k], doc ids [Q, k])."""
    doc, imp = bm25_gather(
        store, src, srcr, slot, rlen, big, wtblk,
        pad=pad, block=block, sentinel=sentinel,
    )
    doc, imp = sort_pairs(doc, imp, k_start=2 * block)
    return segment_topk(doc, imp, k=k, sentinel=sentinel)
