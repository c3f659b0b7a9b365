"""BM25 search kernels: the gathers that build query rows of postings, the
segment top-k over sorted rows, and the chains of gather -> sort ->
segment top-k. Each kernel has its plain PyTorch version beside it.

Port of ``probing_rag_tpu/ops/pallas_sparse.py``: ``bm25_search_bitonic``
(``bm25_gather``), ``postings_gather_pallas`` (``postings_gather``),
``postings_assemble_pallas`` (``postings_assemble``),
``segment_topk_pallas`` (with ``ops/sparse.py::sorted_segment_topk``'s
contract) and ``bm25_search_padded_fused``. The wrappers take the plain
version for CPU tensors and launch the kernel for CUDA tensors; there is no
other switch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.ops.sort import sort_pairs

TOPK_MAX = 16  # kernels/csrc/common.cuh TOPK_MAX
# slots one block of segment_topk.cu takes (a multiple of its 4096-slot
# stage), and the most partial lists a row may have (kernels/csrc/
# topk_merge.cuh: 32 lanes x MERGE_LISTS)
SEG_CHUNK = 8192
SEG_MAX_PARTS = 1024

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


# ------------------------------------------------- aligned postings gather


def _check_1d(arrays, dev, what: str) -> None:
    for i, a in enumerate(arrays):
        want = torch.int32 if i % 2 == 0 else torch.float32
        if a.dtype != want or a.dim() != 1 or a.device != dev:
            raise ValueError(f"{what} array {i}: need 1-D {want} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")


def _check_desc(desc, dev) -> Tuple[int, int]:
    shape = desc[0].shape
    for a in desc:
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape != shape or a.device != dev:
            raise ValueError(f"descriptors: need [Q, TQ] int32 on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    return shape


def _check_cuda_arrays(arrays, name: str) -> None:
    """The CUDA kernels read whole rows of contiguous arrays."""
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError(f"{name} needs contiguous arrays")


def postings_gather_plain(
    doc_e, imp_e, starts, lens, doc_o=None, imp_o=None, wtblk=None,
    *, pad: int, block: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the aligned gather by torch indexing: each output
    block's owning term by ``searchsorted`` over the row's inclusive prefix
    of lengths, then that block of the term's slice (from O when the term
    starts at an odd output block and O is given)."""
    q, tq = starts.shape
    dev = starts.device
    nblk = pad // block
    lens64 = lens.long()
    end = torch.cumsum(lens64, dim=1)
    b0 = (torch.arange(nblk, device=dev) * block).expand(q, nblk).contiguous()
    if tq == 0:
        return (torch.full((q, pad), sentinel, dtype=torch.int32, device=dev),
                torch.zeros((q, pad), dtype=torch.float32, device=dev))
    t = torch.searchsorted(end.contiguous(), b0, right=True)
    valid = (t < tq)[..., None]  # [Q, nblk, 1]
    t = t.clamp(max=tq - 1)
    cum = torch.gather(end - lens64, 1, t)
    first = torch.gather(starts.long(), 1, t) + (b0 - cum)
    idx = first[..., None] + torch.arange(block, device=dev)
    idx = torch.where(valid, idx, 0).clamp(0, doc_e.numel() - 1)
    doc, imp = doc_e[idx], imp_e[idx]
    if doc_o is not None:
        odd = ((cum // block) % 2 == 1)[..., None]
        doc = torch.where(odd, doc_o[idx], doc)
        imp = torch.where(odd, imp_o[idx], imp)
    doc = torch.where(valid, doc, sentinel).to(torch.int32)
    imp = torch.where(valid, imp, 0.0)
    if wtblk is not None:
        imp = imp * wtblk[..., None]
    return doc.reshape(q, pad), imp.reshape(q, pad).to(torch.float32)


def postings_gather(
    doc_e: torch.Tensor,  # [N] int32 postings (aligned CSR, or the store's E copy)
    imp_e: torch.Tensor,  # [N] f32
    starts: torch.Tensor,  # [Q, TQ] int32 slice starts, multiples of block
    lens: torch.Tensor,  # [Q, TQ] int32 slice lengths, multiples of block (0 masked)
    *,
    pad: int,
    sentinel: int,
    block: int = 1024,
    doc_o: Optional[torch.Tensor] = None,  # [N] int32: the store's O copy
    imp_o: Optional[torch.Tensor] = None,
    wtblk: Optional[torch.Tensor] = None,  # [Q, pad // block] f32 block weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate each query's term slices ``[start, start + len)`` into a
    [Q, pad] (doc int32, impact f32) row: the contract of
    ``postings_gather_pallas``. A term past ``pad`` is cut; slots past the
    row total hold (sentinel, 0). With the O copy given, each term reads
    from O when its slice starts at an odd output block and from E
    otherwise, so over the block-alternated store every block comes out
    sorted, ascending at even block index and descending at odd. ``wtblk``
    scales each output block's impacts (the hybrid's dedup weights)."""
    dev = starts.device
    arrays = (doc_e, imp_e) + ((doc_o, imp_o) if doc_o is not None else ())
    _check_1d(arrays, dev, "postings")
    if (doc_o is None) != (imp_o is None) or (doc_o is not None and doc_o.numel() != doc_e.numel()):
        raise ValueError("the O copy needs both arrays, as long as the E copy")
    q, tq = _check_desc((starts, lens), dev)
    if pad < block or pad % block:
        raise ValueError(f"pad ({pad}) must be a multiple of block ({block})")
    if wtblk is not None and (
        wtblk.dtype != torch.float32 or wtblk.shape != (q, pad // block) or wtblk.device != dev
    ):
        raise ValueError(f"wtblk: need [{q}, {pad // block}] f32 on {dev}")
    if dev.type == "cpu":
        return postings_gather_plain(doc_e, imp_e, starts, lens, doc_o, imp_o, wtblk,
                                     pad=pad, block=block, sentinel=sentinel)
    if dev.type != "cuda":
        raise ValueError(f"no postings gather for device {dev}")
    _check_cuda_arrays(arrays + (starts, lens) + ((wtblk,) if wtblk is not None else ()),
                       "postings_gather")
    if block % 4 or any(a.data_ptr() % 16 for a in arrays):
        raise ValueError("postings_gather reads 16-byte vectors: block must be a multiple "
                         "of 4 and the postings arrays 16-byte aligned")
    out_doc = torch.empty((q, pad), dtype=torch.int32, device=dev)
    out_imp = torch.empty((q, pad), dtype=torch.float32, device=dev)
    if q == 0:
        return out_doc, out_imp
    ends = torch.cumsum(lens, dim=1, dtype=torch.int64)
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.postings_gather(
                doc_e.data_ptr(), imp_e.data_ptr(),
                doc_o.data_ptr() if doc_o is not None else None,
                imp_o.data_ptr() if imp_o is not None else None,
                starts.data_ptr(), ends.data_ptr(),
                wtblk.data_ptr() if wtblk is not None else None,
                q, tq, pad, block, sentinel,
                out_doc.data_ptr(), out_imp.data_ptr(), kernels.stream_ptr(dev),
            ),
            "postings_gather",
        )
    kernels.LAUNCHES["postings_gather"] += 1
    return out_doc, out_imp


# ------------------------------------------------- compact short-term assembly

# postings_assemble.cu: threads of a block (terms one scan chunk covers) and
# the slots a block writes per step, 4 a thread
ASSEMBLE_THREADS = 512
ASSEMBLE_TILE = 4 * ASSEMBLE_THREADS
ASSEMBLE_BLOCKS_PER_SM = 2


class AssemblePlan(NamedTuple):
    """The grid of ``postings_assemble.cu``: block (x, y) writes slots
    ``[x * span, (x + 1) * span)`` of row y (the last block of a row stops
    at ``pad``)."""

    span: int  # slots of a row each block writes, a multiple of ASSEMBLE_TILE
    grid: Tuple[int, int]  # (blocks along a row, rows)


def plan_assemble(q: int, pad: int, sm_count: int) -> AssemblePlan:
    """Split [q, pad] into blocks of whole tiles, for about
    ``ASSEMBLE_BLOCKS_PER_SM`` blocks on each of ``sm_count`` SMs where
    ``pad`` has the tiles: a block takes ``ceil(tiles / per_row)`` tiles,
    so a row has at most ``per_row`` blocks (the grid has at most
    ``2 * sm_count + q`` at any ``pad``), one a tile while the row has at
    most ``per_row`` tiles, and over ``per_row / 2`` once it has more (the
    grid then covers every SM)."""
    tiles = max(-(-pad // ASSEMBLE_TILE), 1)
    per_row = -(-ASSEMBLE_BLOCKS_PER_SM * sm_count // max(q, 1))
    span = -(-tiles // per_row) * ASSEMBLE_TILE
    return AssemblePlan(span, (-(-pad // span), q))


last_plan: Optional[AssemblePlan] = None  # the plan of the last postings_assemble launch


def postings_assemble_plain(
    doc_c, imp_c, src, rlen, wt=None, *, pad: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the assembly: every posting's (row, column, source)
    by ``repeat_interleave`` over the lengths, then one scatter."""
    q, tq = src.shape
    dev = src.device
    doc = torch.full((q, pad), sentinel, dtype=torch.int32, device=dev)
    imp = torch.zeros((q, pad), dtype=torch.float32, device=dev)
    lens = rlen.long().reshape(-1)
    n = int(lens.sum())
    if n == 0:
        return doc, imp
    term = torch.repeat_interleave(torch.arange(q * tq, device=dev), lens, output_size=n)
    rank = torch.arange(n, device=dev) - (torch.cumsum(lens, 0) - lens)[term]
    col = (torch.cumsum(rlen.long(), 1) - rlen.long()).reshape(-1)[term] + rank
    row = term // max(tq, 1)
    s = src.long().reshape(-1)[term] + rank
    vals = imp_c[s]
    if wt is not None:
        vals = vals * wt.reshape(-1)[term]
    keep = col < pad
    doc[row[keep], col[keep]] = doc_c[s[keep]]
    imp[row[keep], col[keep]] = vals[keep]
    return doc, imp


def postings_assemble(
    doc_c: torch.Tensor,  # [N] int32 compact postings (the store's guarded copy)
    imp_c: torch.Tensor,  # [N] f32
    src: torch.Tensor,  # [Q, TQ] int32 compact starts (0 masked)
    rlen: torch.Tensor,  # [Q, TQ] int32 posting counts (0 masked)
    wt: Optional[torch.Tensor] = None,  # [Q, TQ] f32 per-term weights
    *,
    pad: int,
    sentinel: int,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack each query's short posting lists back to back into a [Q, pad]
    (doc int32, impact f32) row, each impact times its term's weight, with
    (sentinel, 0) past the row total: the contract of
    ``postings_assemble_pallas`` (weights as f32). ``pad`` is at least the
    largest row total (a posting past it is cut), and a multiple of 4.
    ``out`` (two [Q, pad] views with contiguous rows, one row stride and
    every row 16-byte aligned, e.g. the last ``pad`` columns of a wider
    buffer) receives the rows and is returned. The kernel's grid is
    ``plan_assemble``'s; no other launch runs before it."""
    global last_plan
    dev = src.device
    _check_1d((doc_c, imp_c), dev, "compact postings")
    q, tq = _check_desc((src, rlen), dev)
    if wt is not None and (wt.dtype != torch.float32 or wt.shape != (q, tq) or wt.device != dev):
        raise ValueError(f"wt: need [{q}, {tq}] f32 on {dev}")
    if pad % 4:
        raise ValueError(f"postings_assemble writes 16-byte vectors: pad ({pad}) must be a "
                         "multiple of 4")
    if out is not None:
        od, oi = out
        if od.dtype != torch.int32 or oi.dtype != torch.float32 or od.shape != (q, pad) \
                or oi.shape != (q, pad) or od.device != dev or oi.device != dev:
            raise ValueError(f"out: need [{q}, {pad}] int32 and f32 views on {dev}")
        if od.stride(1) != 1 or oi.stride(1) != 1 or od.stride(0) != oi.stride(0):
            raise ValueError("postings_assemble writes rows that are contiguous, one stride apart")
        if od.data_ptr() % 16 or oi.data_ptr() % 16 or od.stride(0) % 4:
            raise ValueError("postings_assemble writes 16-byte vectors: every row of out "
                             "must start 16-byte aligned")
    if dev.type == "cpu":
        got = postings_assemble_plain(doc_c, imp_c, src, rlen, wt, pad=pad, sentinel=sentinel)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1])
        return out
    if dev.type != "cuda":
        raise ValueError(f"no postings assembly for device {dev}")
    _check_cuda_arrays((doc_c, imp_c, src, rlen) + ((wt,) if wt is not None else ()),
                       "postings_assemble")
    if out is None:
        out = (torch.empty((q, pad), dtype=torch.int32, device=dev),
               torch.empty((q, pad), dtype=torch.float32, device=dev))
    od, oi = out
    if q == 0 or pad == 0:
        return out
    plan = plan_assemble(q, pad, kernels.sm_count(dev))
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.postings_assemble(
                doc_c.data_ptr(), imp_c.data_ptr(), src.data_ptr(), rlen.data_ptr(),
                wt.data_ptr() if wt is not None else None,
                q, tq, pad, od.stride(0), plan.span, sentinel,
                od.data_ptr(), oi.data_ptr(), kernels.stream_ptr(dev),
            ),
            "postings_assemble",
        )
    kernels.LAUNCHES["postings_assemble"] += 1
    last_plan = plan
    return out


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


def segment_plan(q: int, p: int, k: int) -> Tuple[int, int, Tuple[int, int, int]]:
    """How the CUDA segment top-k splits [q, p] rows: (slots a block
    takes, blocks a row, shape of the partial lists ``[chunks, q, k]``).
    The chunk starts at ``SEG_CHUNK`` and doubles until a row has at most
    ``SEG_MAX_PARTS`` chunks, the most the merge launch takes; an empty row
    still has one (empty) chunk."""
    chunk = SEG_CHUNK
    while -(-p // chunk) > SEG_MAX_PARTS:
        chunk *= 2
    n = max(1, -(-p // chunk))
    return chunk, n, (n, q, k)


def segment_topk(
    doc: torch.Tensor,  # [Q, P] int32, sorted ascending per row
    imp: torch.Tensor,  # [Q, P] f32
    *, k: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of run sums over sorted postings. Returns (scores
    [Q, k] f32, 0 where empty; doc ids [Q, k] int32, -1 where empty).
    Ranking: score descending, then doc id ascending. On the card the rows
    are split into chunks (:func:`segment_plan`), each with its partial
    list, and a second launch merges each row's lists."""
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
    chunk, nchunks, part_shape = segment_plan(q, p, k)
    part_v = torch.empty(part_shape, dtype=torch.float32, device=doc.device)
    part_i = torch.empty(part_shape, dtype=torch.int32, device=doc.device)
    lib = kernels.library()
    with torch.cuda.device(doc.device):
        kernels.check(
            lib.segment_topk(
                doc.data_ptr(), imp.data_ptr(), q, p, k, sentinel, chunk, nchunks,
                part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                kernels.stream_ptr(doc.device),
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


def bm25_search_padded_fused(
    term_offsets: torch.Tensor,  # [T + 1] int32 aligned offsets (aligned_csr)
    postings_doc: torch.Tensor,  # [A] int32 aligned postings
    postings_impact: torch.Tensor,  # [A] f32
    qterms: torch.Tensor,  # [Q, TQ] int32 term ids (0 where masked)
    qmask: torch.Tensor,  # [Q, TQ] bool
    *, pad: int, sentinel: int, k: int, block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The "dma" engine mode's search over the aligned CSR: gather of each
    term's aligned slice (padding entries are (sentinel, 0)) -> full sort
    -> run sums + top-k. ``pad`` is a multiple of ``block`` at least the
    largest row's aligned total. Returns (scores [Q, k], doc ids [Q, k])."""
    off = term_offsets.long()
    qt = qterms.long()
    lens = torch.where(qmask, off[qt + 1] - off[qt], 0).to(torch.int32)
    starts = torch.where(qmask, off[qt], 0).to(torch.int32)
    doc, imp = postings_gather(postings_doc, postings_impact, starts, lens,
                               pad=pad, sentinel=sentinel, block=block)
    doc, imp = sort_pairs(doc, imp)
    return segment_topk(doc, imp, k=k, sentinel=sentinel)
