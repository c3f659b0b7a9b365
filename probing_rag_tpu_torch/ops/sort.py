"""Row-wise (int32 key, f32 value) sort: the CUDA sort and its plain
PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_sort.py`` (``sort_pairs_pallas`` and
``sort_pairs_pallas_wide``): one CUDA sort (``kernels/csrc/bitonic_sort.cu``)
covers every power-of-two width from 2 to ``MAX_SORT_WIDTH``: the bitonic
network inside shared-memory tiles of ``SORT_TILE`` pairs, then one merge
pass for each doubling of the sorted runs above the tile
(:func:`sort_schedule` plans them). Keys come out ascending and every
(key, value) pair is preserved; the order of values within one key is free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from probing_rag_tpu_torch import kernels

# The widest row the BM25 engine sorts. Its over-cap hybrid keeps at most
# 2^20 real postings a row (retrieval/bm25.py FALLBACK_MAX_PAD); a long
# term has at least 256 of them (the store's min_len) and takes a whole
# number of 1024-blocks, so at most 4x its postings in slots: at most 2^22
# long-term slots, plus the short tail's reserved slack, in a power of two.
MAX_SORT_WIDTH = 1 << 23
# rows wider than this are the TPU's "wide" sort (_bitonic_wide_kernel);
# the launch counts keep the two apart
NARROW_SORT_MAX = 1 << 15
# pairs one block sorts in shared memory (bitonic_sort.cu takes 2..16384)
SORT_TILE = 16384


@dataclass(frozen=True)
class SortPass:
    """One launch of the CUDA sort. ``src`` and ``dst`` name the buffers:
    ``"in"`` (the inputs), ``"out"`` and ``"scratch"`` (a contiguous pair
    the wrapper allocates). ``"tile"`` runs the stages ``k_lo`` .. ``k_hi``
    on tiles of ``tile`` pairs in shared memory (every tile ascending when
    ``tile_asc``);
    ``"merge"`` merges sorted runs of ``run`` pairs into runs of ``2 *
    run`` (odd input runs stored descending when ``desc_odd``, odd output
    runs written descending when ``rev_odd``); ``"copy"`` copies."""

    kind: str
    src: str
    dst: str
    tile: int = 0
    k_lo: int = 0
    k_hi: int = 0
    tile_asc: bool = False
    run: int = 0
    desc_odd: bool = False
    rev_odd: bool = False


def sort_schedule(p: int, k_start: int, k_last: int, *, in_place: bool = False
                  ) -> List[SortPass]:
    """The passes that sort [Q, p] rows from stage ``k_start`` through
    stage ``k_last`` (``min(k_stop, p)``), each a round trip through device
    memory. Up to the tile (``min(p, tile)``) one tile pass does it all, its
    blocks alternating by index in the row. Wider, the tile pass (skipped
    when ``k_start`` is past the tile) leaves every tile ascending, and each
    merge pass doubles the runs up to ``k_last``: at most ``log2(p / tile)
    + 1`` passes. The first merge after a skipped tile pass reads the odd
    runs of ``k_start // 2`` backwards (the ``k_start`` precondition leaves
    them descending); below a ``k_stop`` the last merge writes odd blocks
    reversed. The passes alternate between ``"out"`` and ``"scratch"``, in
    the parity that makes the last one write ``"out"``. A merge never reads
    the rows it writes: sorting in place (``in_place``, ``"in"`` is
    ``"out"``), a first merge that would write ``"out"`` reads a copy."""
    if k_start > k_last:
        return []
    tile = min(p, SORT_TILE)
    if k_last <= tile:
        return [SortPass("tile", "in", "out", tile=tile, k_lo=k_start, k_hi=k_last)]
    steps = []
    if k_start <= tile:
        steps.append(dict(kind="tile", tile=tile, k_lo=k_start, k_hi=tile, tile_asc=True))
        run = tile
    else:
        run = k_start // 2
    while run < k_last:
        steps.append(dict(kind="merge", run=run, desc_odd=not steps,
                          rev_odd=2 * run == k_last < p))
        run *= 2
    n = len(steps)
    passes, src = [], "in"
    if in_place and steps[0]["kind"] == "merge" and n % 2 == 1:
        passes.append(SortPass("copy", "in", "scratch"))
        src = "scratch"
    for i, step in enumerate(steps):
        dst = "out" if (n - 1 - i) % 2 == 0 else "scratch"
        passes.append(SortPass(src=src, dst=dst, **step))
        src = dst
    return passes


def launch_pass(lib, s: SortPass, bufs: dict, q: int, p: int, stream: int) -> None:
    """Launches one pass of :func:`sort_schedule` on [q, p] rows. ``bufs``
    maps each buffer name to its (keys, values, row stride) on the card."""
    sk, sv, sld = bufs[s.src]
    dk, dv, dld = bufs[s.dst]
    if s.kind == "copy":
        dk.copy_(sk)
        dv.copy_(sv)
        return
    ptrs = (sk.data_ptr(), sv.data_ptr(), dk.data_ptr(), dv.data_ptr(), q, p, sld, dld)
    if s.kind == "tile":
        code = lib.sort_tile_pass(*ptrs, s.tile, s.k_lo, s.k_hi, int(s.tile_asc), stream)
    else:
        code = lib.sort_merge_pass(*ptrs, s.run, int(s.desc_odd), int(s.rev_odd), stream)
    kernels.check(code, f"sort_{s.kind}_pass")


def sort_pairs_plain(
    keys: torch.Tensor, vals: torch.Tensor, *, k_start: int = 2,
    k_stop: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: stable ``torch.sort`` of the keys, values gathered.
    With ``k_stop`` below the row width, each aligned ``k_stop`` block is
    sorted on its own, descending at odd block index (the state the
    network leaves after stage ``k_stop``). Like the network, it returns
    the rows unchanged when ``k_start`` is past ``min(k_stop, P)``."""
    q, p = keys.shape
    k_last = p if k_stop is None else min(p, k_stop)
    if k_start > k_last:
        return keys.clone(), vals.clone()
    if k_last == p:
        out_k, idx = torch.sort(keys, dim=1, stable=True)
        return out_k, torch.gather(vals, 1, idx)
    nb = p // k_last
    out_k, idx = torch.sort(keys.reshape(q, nb, k_last), dim=2, stable=True)
    out_v = torch.gather(vals.reshape(q, nb, k_last), 2, idx)
    out_k[:, 1::2] = out_k[:, 1::2].flip(2)
    out_v[:, 1::2] = out_v[:, 1::2].flip(2)
    return out_k.reshape(q, p), out_v.reshape(q, p)


def _pow2(name: str, v: int) -> None:
    if v < 2 or v & (v - 1):
        raise ValueError(f"{name} must be a power of two >= 2, got {v}")


def _check(keys, vals, k_start: int, k_stop: Optional[int], out) -> None:
    if keys.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"need int32 keys and f32 values, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 2 or keys.shape != vals.shape:
        raise ValueError(f"need matching [Q, P] rows, got {tuple(keys.shape)}, {tuple(vals.shape)}")
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, values on {vals.device}")
    p = keys.shape[1]
    if p < 2 or p & (p - 1) or p > MAX_SORT_WIDTH:
        raise ValueError(f"row width must be a power of two in [2, {MAX_SORT_WIDTH}], got {p}")
    _pow2("k_start", k_start)
    if k_stop is not None:
        _pow2("k_stop", k_stop)
    if out is not None:
        ok, ov = out
        if (ok.dtype, ov.dtype) != (keys.dtype, vals.dtype) or ok.shape != keys.shape \
                or ov.shape != keys.shape or ok.device != keys.device or ov.device != keys.device:
            raise ValueError("out must be (int32, f32) rows of the inputs' shape and device")


def _row_stride(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """The common row stride of two [Q, P] views whose rows are contiguous."""
    if a.stride(1) != 1 or b.stride(1) != 1 or a.stride(0) != b.stride(0):
        raise ValueError(f"sort_pairs needs {what} with contiguous rows and one row stride")
    return a.stride(0)


def sort_pairs(
    keys: torch.Tensor,  # [Q, P] int32, P a power of two
    vals: torch.Tensor,  # [Q, P] f32
    *,
    k_start: int = 2,
    k_stop: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise ascending sort of (key, value) pairs.

    ``k_start`` skips the network's passes below it: the caller guarantees
    that every aligned ``k_start // 2``-wide block of each row is already
    sorted, ascending at even block index and descending at odd (the BM25
    gather produces exactly this with ``k_start = 2 * block``).

    ``k_stop`` ends the network after stage ``k_stop``: every aligned
    ``k_stop``-wide block comes out sorted, ascending at even block index
    and descending at odd, which establishes ``k_start = 2 * k_stop`` for a
    later, wider sort. Rows come back unchanged when ``k_start`` is past
    ``min(k_stop, P)``, as in the Pallas network.

    ``out`` (two [Q, P] views) receives the result and is returned; it may
    be the inputs themselves, to sort in place, and its rows may lie in a
    wider buffer (any row stride, contiguous rows). The BM25 over-cap
    hybrid sorts its short tail this way inside the full row's slack.

    CPU tensors take the plain version; CUDA tensors launch the passes of
    :func:`sort_schedule`."""
    _check(keys, vals, k_start, k_stop, out)
    if keys.device.type == "cpu":
        got = sort_pairs_plain(keys, vals, k_start=k_start, k_stop=k_stop)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1])
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"no sort for device {keys.device}")
    ld_in = _row_stride(keys, vals, "keys and values")
    out_k, out_v = out if out is not None else (torch.empty_like(keys), torch.empty_like(vals))
    ld_out = _row_stride(out_k, out_v, "out")
    q, p = keys.shape
    k_last = p if k_stop is None else min(p, k_stop)
    in_place = out_k.data_ptr() == keys.data_ptr()
    if k_start > k_last or q == 0:
        if not in_place:
            out_k.copy_(keys)
            out_v.copy_(vals)
        return out_k, out_v
    passes = sort_schedule(p, k_start, k_last, in_place=in_place)
    bufs = {"in": (keys, vals, ld_in), "out": (out_k, out_v, ld_out)}
    if any("scratch" in (s.src, s.dst) for s in passes):
        bufs["scratch"] = (torch.empty((q, p), dtype=torch.int32, device=keys.device),
                           torch.empty((q, p), dtype=torch.float32, device=keys.device), p)
    lib = kernels.library()
    stream = kernels.stream_ptr(keys.device)
    with torch.cuda.device(keys.device):
        for s in passes:
            launch_pass(lib, s, bufs, q, p, stream)
    kernels.LAUNCHES["bitonic_sort" if p <= NARROW_SORT_MAX else "bitonic_sort_wide"] += 1
    return out_k, out_v
