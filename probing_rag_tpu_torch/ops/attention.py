"""Attention as the JAX package computes it, two CUDA kernels and their
plain PyTorch versions, with the KV cache's int8 and int4 formats
(quantizers, nibble packing, dequantizers).

Not a port of a Pallas kernel. The JAX package leaves attention to XLA
(``probing_rag_tpu/models/gemma.py::_attn_core``, ``:755``, called by
``_attention``, ``:787``), which fuses the convert of a bf16, int8 or int4
cache into the score and value dots. Plain PyTorch ops cannot fuse it: they
write an f32 copy of the cache, f32 scores ``[B, H, T, S]`` and their
softmax, and run f32 products over them. Two kernels compute
``_attn_core``'s function and read K and V in their stored type:

- :func:`decode_attention`: the few query positions of a decode step or a
  speculative verify round (G x T <= 64 query rows a kv head) against the
  whole cache, with a dense mask; ``kernels/csrc/decode_attention.cu``
  (three passes, counted as one launch; tensor cores for bf16 compute).
- :func:`prefill_attention`: any number of query positions (prefill over
  the cache, the no-cache forward of the capture and the traces) with bf16
  compute, the mask in structured form ``(kpos <= qpos) & valid``;
  ``kernels/csrc/prefill_attention.cu`` (three launches counted as one;
  wgmma behind a TMA ring, planned by :func:`plan_prefill_attention`).

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
version (:func:`decode_attention_plain`, :func:`prefill_attention_plain`);
there is no other switch. ``models/gemma.py::_block`` routes: the
probabilities asked for -> plain ops; bf16 compute over the cache at G x T
<= 64 -> :func:`decode_attention`; other bf16 calls ->
:func:`prefill_attention`; f32 compute (a checking mode) ->
:func:`decode_attention` where :func:`kernel_takes` holds, else plain ops.

The cache layer is ``init_kv_cache``'s: K and V ``[B, KV, S, hd]`` in bf16
or f32; int8 with f32 scales ``[B, KV, S]`` (one a slot and kv head); or
nibble-packed int4 ``uint8 [B, KV, S, hd/2]`` with f32 scales ``[B, KV*G,
S]``, one per :func:`kv4_group` lanes of the head dim. The int4 weights of
quantized serving share the nibble packing (:func:`pack_int4`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from probing_rag_tpu_torch import kernels

# decode_attention.cu: slots per tile, query rows (G x T) and head dim it takes
TILE = 128
MAX_ROWS = 64
MAX_HEAD_DIM = 256
# prefill_attention.cu: the head dims it takes, slots a prep chunk (the rest
# of its geometry is plan_prefill_attention's)
PREFILL_HEAD_DIMS = (32, 64, 128, 256)
PREFILL_CHUNK = 256
# splits: about this many blocks an SM over all (batch row, kv head) pairs
_BLOCKS_PER_SM = 2
_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2, torch.uint8: 3}

# Sub-channel group width of the int4 KV cache: one scale per 32 head-dim
# lanes (per token, per kv-head); a head_dim 32 does not divide gets one
# group per head.
KV4_GROUP = 32


def kv4_group(head_dim: int) -> int:
    return KV4_GROUP if head_dim % KV4_GROUP == 0 else head_dim


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] -> uint8 pairs along the last axis: byte j
    holds columns (2j, 2j+1) as (lo, hi) nibbles biased by +8."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 pack needs an even last dim, got {tuple(q.shape)}")
    u = (q + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(qp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``[..., F/2]`` -> int8 ``[..., F]``."""
    lo = (qp & 0xF).to(torch.int8) - 8
    hi = (qp >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*qp.shape[:-1], qp.shape[-1] * 2)


def quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, f32 scales [..., 1]); one scale per row."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s


def quant_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values in [-7, 7] [..., hd], f32 scales [..., G]):
    one symmetric max-abs scale per :func:`kv4_group` slice of the head dim."""
    hd = x.shape[-1]
    g = kv4_group(hd)
    xg = x.float().reshape(*x.shape[:-1], hd // g, g)
    s = xg.abs().amax(dim=-1) / 7.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xg / s[..., None]), -7, 7)
    return q.reshape(x.shape).to(torch.int8), s


def dequant_kv4(q: torch.Tensor, s_m: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """q [..., KV, S, hd] int4 values (as int8), s_m [..., KV*G, S] f32 ->
    [..., KV, S, hd] in ``dt``."""
    hd = q.shape[-1]
    ng = hd // kv4_group(hd)
    kv, s_len = q.shape[-3], q.shape[-2]
    s = s_m.reshape(*s_m.shape[:-2], kv, ng, s_len).transpose(-1, -2)[..., None]  # [.., KV, S, G, 1]
    xg = q.reshape(*q.shape[:-1], ng, hd // ng).to(dt) * s.to(dt)
    return xg.reshape(q.shape)


def dequant_kv(buf: torch.Tensor, scale: Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """A cache layer in ``dt`` (the JAX ``_block``'s dequantize): int4
    ``dt(q) * dt(group scale)``, int8 ``dt(q) * dt(slot scale)``, a bf16 or
    f32 layer cast."""
    if buf.dtype == torch.uint8:
        return dequant_kv4(unpack_int4(buf), scale, dt)
    if buf.dtype == torch.int8:
        return buf.to(dt) * scale[..., None].to(dt)
    return buf.to(dt)


def attn_core(
    q: torch.Tensor,  # [B, T, KV, G, hd]
    k: torch.Tensor,  # [B, KV, S, hd]
    v: torch.Tensor,  # [B, KV, S, hd]
    mask: torch.Tensor,  # [B, 1, T, S] bool (True = attend)
    return_probs: bool = False,
):
    """f32 scores, -1e30 masking, softmax, f32-accumulated value sum (the
    JAX einsums with ``preferred_element_type=f32``). Returns ([B, T, H*hd]
    f32, the f32 softmax [B, H, T, S] if ``return_probs`` else None)."""
    b, t, kv, groups, hd = q.shape
    scores = torch.einsum("btkgh,bksh->bkgts", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksh->btkgh", probs.to(v.dtype).float(), v.float())
    out = out.reshape(b, t, kv * groups * hd)
    return out, (probs.reshape(b, kv * groups, t, -1) if return_probs else None)


def kernel_takes(t: int, groups: int, head_dim: int) -> bool:
    """Whether the kernel takes ``t`` query positions of ``groups`` query
    heads a kv head at ``head_dim`` (32, 64, 128 or 256: a lane holds 8
    head-dim lanes, four lanes share a slot's row in the score pass, a warp
    holds whole rows in the value pass): the decode step and the verify
    round of Gemma-2B and Mistral-7B. Prefill does not, nor a head_dim of
    16 (``tiny_mistral``): those run the plain ops."""
    return (t * groups <= MAX_ROWS and 32 <= head_dim <= MAX_HEAD_DIM
            and MAX_HEAD_DIM % head_dim == 0)


@dataclass(frozen=True)
class AttentionPlan:
    """How :func:`decode_attention` cuts the slots: ``tiles`` of ``TILE``
    slots, ``tiles_per_split`` of them a block, ``nsplit`` blocks a (batch
    row, kv head)."""

    tiles: int
    tiles_per_split: int
    nsplit: int


# the plan of the last call launched on the card (read by chip_smoke.py)
last_plan: AttentionPlan | None = None


def plan_decode_attention(pairs: int, s: int, sm_count: int = 132) -> AttentionPlan:
    """Splits for ``pairs`` (batch row, kv head) pairs over ``s`` slots:
    about ``_BLOCKS_PER_SM`` blocks an SM in all, every split at least one
    tile and none empty."""
    tiles = math.ceil(s / TILE)
    want = max(1, math.ceil(_BLOCKS_PER_SM * sm_count / pairs))
    per = math.ceil(tiles / min(want, tiles))
    return AttentionPlan(tiles, per, math.ceil(tiles / per))


def _check(q, k, v, mask, k_scale, v_scale, dt):
    """Shapes and types both versions take. Returns (b, t, h, hd, kv, s)."""
    b, t, h, hd, kv, s = _check_cache(q, k, v, k_scale, v_scale, dt)
    if tuple(mask.shape) != (b, 1, t, s) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{b}, 1, {t}, {s}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    return b, t, h, hd, kv, s


def _check_cache(q, k, v, k_scale, v_scale, dt):
    """q against one cache layer and its scales. Returns (b, t, h, hd, kv, s)."""
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dt must be bf16 or f32, got {dt}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B, T, H, hd] and k, v [B, KV, S, hd(/2)], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    kv, s = k.shape[1], k.shape[2]
    if k.dtype != v.dtype or k.dtype not in _KINDS:
        raise TypeError(f"k and v must share a bf16, f32, int8 or uint8 (int4) type, got "
                        f"{k.dtype}, {v.dtype}")
    if k.shape[0] != b or h % kv or k.shape[3] != (hd // 2 if k.dtype == torch.uint8 else hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    quantized = k.dtype in (torch.int8, torch.uint8)
    if quantized != (k_scale is not None) or quantized != (v_scale is not None):
        raise ValueError("an int8 or int4 cache needs k_scale and v_scale, and only it")
    if quantized:
        rows = kv * (hd // kv4_group(hd)) if k.dtype == torch.uint8 else kv
        want = (b, rows, s)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"scales must be {want}, got {tuple(k_scale.shape)}, "
                             f"{tuple(v_scale.shape)}")
    return b, t, h, hd, kv, s


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           dt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: the cache dequantized to
    ``dt`` (:func:`dequant_kv`), then :func:`attn_core`."""
    b, t, h, hd, kv, s = _check(q, k, v, mask, k_scale, v_scale, dt)
    kd, vd = dequant_kv(k, k_scale, dt), dequant_kv(v, v_scale, dt)
    return attn_core(q.reshape(b, t, kv, h // kv, hd), kd, vd, mask)[0]


def rounding_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, *, k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       dt: torch.dtype = torch.bfloat16, rel: float = 1e-5) -> torch.Tensor:
    """How far, element by element, an output ``[B, T, H*hd]`` computed as
    :func:`decode_attention_plain` computes it may lie from that version's
    when its f32 probabilities differ from the plain ones by at most ``rel``
    of themselves (scores and sums in another order).

    Each probability ``p`` is rounded to ``dt`` before the value sum. Where
    ``p (1 - rel)`` and ``p (1 + rel)`` round to the same value, both
    versions round to it and that slot adds no difference; where they round
    to neighbours, the slot may differ by that one step times ``|v|``. Add
    ``rel`` of the sum of ``|p v|`` for the f32 sums' order. At ``dt`` f32
    every slot may differ by up to ``2 rel p |v|``."""
    b, t, h, hd, kv, s = _check(q, k, v, mask, k_scale, v_scale, dt)
    vd = dequant_kv(v, v_scale, dt).float()
    g = h // kv
    _, p = attn_core(q.reshape(b, t, kv, g, hd), dequant_kv(k, k_scale, dt), vd, mask,
                     return_probs=True)
    p = p.reshape(b, kv, g, t, s)
    step = (p * (1 + rel)).to(dt).float() - (p * (1 - rel)).to(dt).float()
    w = step + rel * p.to(dt).float()
    return torch.einsum("bkgts,bksh->btkgh", w, vd.abs()).reshape(b, t, h * hd)


def _strides(x: torch.Tensor, what: str):
    """Byte strides of ``x``'s first two dims; its last two must be
    contiguous (slots of a row back to back)."""
    if x.stride(-1) != 1 or x.stride(-2) != x.shape[-1]:
        raise ValueError(f"{what}: the kernel needs contiguous slot rows, strides {x.stride()}")
    return x.stride(0) * x.element_size(), x.stride(1) * x.element_size()


def _cache_strides(k, v, k_scale, v_scale):
    """The kernels' cache strides: (byte strides of the cache's batch and
    kv-head dims, element strides of the scales' batch and row dims)."""
    kv_b, kv_h = _strides(k, "k")
    if (_strides(v, "v") != (kv_b, kv_h) or k.data_ptr() % 16 or v.data_ptr() % 16
            or kv_b % 16 or kv_h % 16):
        raise ValueError("k and v must share strides, with 16-byte aligned bases and strides")
    sc_b = sc_r = 0
    if k_scale is not None:
        if (k_scale.stride() != v_scale.stride() or k_scale.stride(-1) != 1
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
            raise ValueError("k_scale and v_scale must be f32 with contiguous slots and "
                             "shared strides")
        sc_b, sc_r = k_scale.stride(0), k_scale.stride(1)
    return kv_b, kv_h, sc_b, sc_r


def _on_device(dev, what: str, **tensors) -> None:
    """Every tensor given lies on ``dev`` (None is skipped)."""
    for name, x in tensors.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, k on {dev}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     dt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``_attn_core``'s output ``[B, T, H*hd]`` f32 for q ``[B, T, H, hd]``
    over every slot of one cache layer: ``k``, ``v`` ``[B, KV, S, hd]``
    (bf16 or f32), int8 with ``k_scale``/``v_scale`` ``[B, KV, S]``, or
    int4 (uint8 ``[B, KV, S, hd/2]``) with ``[B, KV*G, S]``; ``mask`` bool
    ``[B, 1, T, S]``; ``dt`` the compute type the cache is dequantized to
    and the probabilities are rounded to (the kernel takes ``q`` in it). A
    kv-head slice of a cache (tensor parallelism) is taken as it is: each
    (batch row, kv head) needs only contiguous slot rows. CPU tensors take the plain version; CUDA tensors
    launch the kernel (:func:`kernel_takes` must hold)."""
    b, t, h, hd, kv, s = _check(q, k, v, mask, k_scale, v_scale, dt)
    dev = k.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, mask, k_scale=k_scale, v_scale=v_scale, dt=dt)
    if dev.type != "cuda":
        raise ValueError(f"no decode_attention for device {dev}")
    _on_device(dev, "decode_attention", q=q, v=v, mask=mask, k_scale=k_scale, v_scale=v_scale)
    if q.dtype != dt:
        raise TypeError(f"decode_attention kernel needs q in {dt}, got {q.dtype}")
    groups = h // kv
    if not kernel_takes(t, groups, hd):
        raise ValueError(f"decode_attention kernel takes G x T <= {MAX_ROWS} query rows and a "
                         f"head_dim that is a power of two from 8 to {MAX_HEAD_DIM}; got G "
                         f"{groups}, T {t}, head_dim {hd}")
    kv_b, kv_h, sc_b, sc_r = _cache_strides(k, v, k_scale, v_scale)
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    global last_plan
    plan = plan_decode_attention(b * kv, s, kernels.sm_count(dev))
    r = groups * t
    q = q.contiguous()
    scores = torch.empty((b * kv, r, s), dtype=torch.float32, device=dev)
    part_m = torch.empty((b * kv, r, plan.nsplit), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_o = torch.empty((plan.nsplit, b * kv, r, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, h * hd), dtype=torch.float32, device=dev)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))  # as the card's divide by a scalar
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if k_scale is None else k_scale.data_ptr(),
                0 if v_scale is None else v_scale.data_ptr(), mask.data_ptr(),
                scores.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
                out.data_ptr(), _KINDS[k.dtype], int(dt == torch.bfloat16), b, kv, groups, t, s,
                hd, kv4_group(hd), kv_b, kv_h, sc_b, sc_r, mask.stride(0), mask.stride(2),
                plan.tiles_per_split, plan.nsplit, scale, kernels.stream_ptr(dev),
            ),
            "decode_attention",
        )
    kernels.LAUNCHES["decode_attention"] += 1
    last_plan = plan
    return out


# --------------------------------------------------------------- prefill

# prefill_attention.cu's layout constants (its namespace pattn)
_SMEM_BUDGET = 232_448  # shared memory a block may use (227 KB)
_SMEM_SLACK = 1024  # the dynamic base aligned up to 1024 bytes
_CONSUMER_ROWS = 64  # query rows a consumer warpgroup: wgmma's M
_CONSUMERS = 2
_PERSISTENT_CONSUMERS = 3  # 192 query rows an item
# setmaxnreg, consumer and producer: 2 x consumer + producer <= 3 x 168; a
# producer that widens a raw ring gets 56; the persistent regime's 512
# threads: 3 x 160 + 32 <= 4 x 128
_REGS = {0: (232, 40), 1: (224, 56), 2: (224, 56), 3: (224, 56)}
_PERSISTENT_REGS = (160, 32)
_MAX_STAGES = 6
_PERSISTENT_MAX_STAGES = 8
# the persistent regime: a bf16 cache of at most this many slot tiles at a
# head dim in the range (pattn::kPersistentTiles, kPersistentMinHd / MaxHd)
PERSISTENT_MAX_TILES = 4
PERSISTENT_HEAD_DIMS = (64, 128)
_RAW_MAX_STAGES = 4
_RAW_MAX_BYTES = 16_384  # raw rows a raw stage at most
_ROW_BYTES = {0: lambda hd: hd * 2, 1: lambda hd: hd * 4, 2: lambda hd: hd, 3: lambda hd: hd // 2}


@dataclass(frozen=True)
class PrefillPlan:
    """How ``prefill_attention.cu`` runs one (cache kind, head dim): a block
    of ``threads`` = ``consumers`` warpgroups of ``rows`` query rows (``rows
    // groups`` positions x the G heads of one kv head) and one producer
    warpgroup, at ``consumer_regs`` / ``producer_regs`` registers a thread
    (setmaxnreg); K and V tiles of ``tile`` slots (the wgmma N of S = Q
    K^T) in one ring of ``stages`` stages, in the order the consumers read
    them; for a cache that is not bf16, a raw ring of ``raw_stages`` stages
    of ``raw_slots`` slots that the producer widens into the ring;
    ``smem`` bytes of dynamic shared memory a block, with 1024 of alignment
    slack. ``positions`` a work item: ``consumers x (rows // groups)``.
    ``regime`` "tiles" (PR 15's: a block a work item, ``q_buffers`` 1) or
    "persistent" (a block an SM walking the items, two Q buffers); ``grid``
    the blocks of the launch."""

    regime: str
    grid: int
    q_buffers: int
    tile: int
    rows: int
    consumers: int
    positions: int
    threads: int
    consumer_regs: int
    producer_regs: int
    stages: int
    raw_slots: int
    raw_stages: int
    smem: int


def _prefill_smem(kind: int, hd: int, tile: int, raw: int, r: int, rd: int,
                  qb: int = 1) -> int:
    """Bytes of the block's layout: ``qb`` Q buffers, ``r`` ring stages (a
    bf16 tile and its keff), ``rd`` raw stages (rows, scales, keff), with
    two Q buffers each item's facts (its tile count and positions), the
    mbarriers (Q's full, and with two buffers their empty; the rings' full
    and empty), the slack."""
    rb = _ROW_BYTES[kind](hd)
    scales = raw if kind == 2 else hd // 32 * raw if kind == 3 else 0
    raw_stage = raw * (rb + 4) + scales * 4
    consumers = _PERSISTENT_CONSUMERS if qb > 1 else _CONSUMERS  # two buffers: persistent
    meta = qb * (4 + _PERSISTENT_CONSUMERS * _CONSUMER_ROWS) * 4 if qb > 1 else 0  # items' facts
    return (qb * consumers * _CONSUMER_ROWS * hd * 2 + r * tile * (hd * 2 + 4) + rd * raw_stage
            + meta + 8 * ((2 * qb if qb > 1 else 1) + 2 * (r + rd)) + _SMEM_SLACK)


def prefill_regime(kind: torch.dtype, head_dim: int, slots: int) -> str:
    """``prefill_attention.cu``'s regime for ``slots`` slots of a ``kind``
    cache at ``head_dim`` (``pattn::regime``): "persistent" for a bf16
    cache of at most ``PERSISTENT_MAX_TILES`` slot tiles at a head dim in
    ``PERSISTENT_HEAD_DIMS`` (the Contriever encoder's 12 x 64 over at
    most 512 keys), else "tiles" (PR 15's; Gemma-2B's 256, Mistral-7B's
    128 over its 1,024-slot prompts, the tiny configs' 32)."""
    tile = 64 if head_dim >= 256 else 128
    lo, hi = PERSISTENT_HEAD_DIMS
    persistent = (kind == torch.bfloat16 and lo <= head_dim <= hi
                  and -(-slots // tile) <= PERSISTENT_MAX_TILES)
    return "persistent" if persistent else "tiles"


def plan_prefill_attention(kind: torch.dtype, head_dim: int, groups: int, slots: int,
                           t: int = 1, bkv: int = 1, sms: int = 1) -> PrefillPlan:
    """The geometry of ``prefill_attention.cu`` for ``slots`` slots of a
    cache of dtype ``kind`` (bf16, f32, int8, or uint8 for int4) at
    ``head_dim`` with ``groups`` query heads a kv head, and its grid for
    ``t`` positions of ``bkv`` (batch row, kv head) pairs on ``sms`` SMs;
    the C entry checks it against the kernel's own. Tiles of 64 slots at
    head dim 256 (the score tile's 32 registers, its bf16 fragments' 16 and
    the output's 128 fit the consumers' 224), 128 below. The regime is
    :func:`prefill_regime`'s. PR 15's: a bf16 cache the most ring stages
    that fit, up to 6; beside a raw ring (at most 16 KB of raw rows a raw
    stage) 4 ring stages where three raw stages still fit, else 3, then as
    many raw stages as fit, up to 4; a block an item of two consumer
    warpgroups (384 threads). Persistent: three consumer warpgroups (192
    query rows an item, 512 threads), two Q buffers and the most ring
    stages that fit beside them, up to 8 (8 at head dim 64, 3 at 128);
    ``min(sms, items)`` blocks."""
    if kind not in _KINDS or head_dim not in PREFILL_HEAD_DIMS:
        raise ValueError(f"no prefill plan for a {kind} cache at head_dim {head_dim}")
    if not 1 <= groups <= _CONSUMER_ROWS:
        raise ValueError(f"no prefill plan for {groups} query heads a kv head")
    if min(slots, t, bkv, sms) < 1:
        raise ValueError(f"no prefill plan for {slots} slots, {t} positions, {bkv} (row, kv "
                         f"head) pairs on {sms} SMs")
    k = _KINDS[kind]
    regime = prefill_regime(kind, head_dim, slots)
    qb = 2 if regime == "persistent" else 1
    tile = 64 if head_dim >= 256 else 128
    rb = _ROW_BYTES[k](head_dim)
    raw = 0 if k == 0 else tile if tile * rb <= _RAW_MAX_BYTES else _RAW_MAX_BYTES // rb

    def fits(r, rd):
        return _prefill_smem(k, head_dim, tile, raw, r, rd, qb) <= _SMEM_BUDGET

    if k == 0:
        top = _PERSISTENT_MAX_STAGES if regime == "persistent" else _MAX_STAGES
        r, rd = next((r for r in range(top, 2, -1) if fits(r, 0)), 2), 0
    else:
        r = 4 if fits(4, 3) else 3 if fits(3, 3) else 2
        rd = next((rd for rd in range(_RAW_MAX_STAGES, 1, -1) if fits(r, rd)), 1)
    consumers = _PERSISTENT_CONSUMERS if regime == "persistent" else _CONSUMERS
    regs = _PERSISTENT_REGS if regime == "persistent" else _REGS[k]
    positions = consumers * (_CONSUMER_ROWS // groups)
    items = -(-t // positions) * bkv
    return PrefillPlan(regime=regime, grid=min(items, sms) if regime == "persistent" else items,
                       q_buffers=qb, tile=tile, rows=_CONSUMER_ROWS, consumers=consumers,
                       positions=positions, threads=128 * (consumers + 1),
                       consumer_regs=regs[0], producer_regs=regs[1], stages=r,
                       raw_slots=raw, raw_stages=rd,
                       smem=_prefill_smem(k, head_dim, tile, raw, r, rd, qb))


# the plan of the last prefill launched on the card (read by chip_smoke.py)
last_prefill_plan: PrefillPlan | None = None


def prefill_kernel_takes(groups: int, head_dim: int) -> bool:
    """Whether ``prefill_attention.cu`` takes ``groups`` query heads a kv
    head at ``head_dim``: a consumer warpgroup holds 64 query rows (64 / G
    positions x the G heads), and the head dim is one of its instantiations
    (Gemma-2B G 8 x 256, Mistral-7B G 4 x 128, the tiny test model G 2 x
    32). ``tiny_mistral`` (head dim 16) does not: it runs the plain ops."""
    return 1 <= groups <= _CONSUMER_ROWS and head_dim in PREFILL_HEAD_DIMS


def structured_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The dense mask ``[B, 1, T, S]`` of the structured one: slot s is
    attended from query t where ``kpos[b, s] <= qpos[b, t]`` and ``valid[b,
    s]`` (None: every slot valid). Cache path: kpos the slot index, qpos the
    cursor plus t; no-cache path: both the RoPE positions."""
    mask = kpos[:, None, :] <= qpos[:, :, None]
    if valid is not None:
        mask = mask & valid[:, None, :]
    return mask[:, None]


def _check_prefill(q, k, v, qpos, kpos, valid, k_scale, v_scale, dt, out_dtype):
    b, t, h, hd, kv, s = _check_cache(q, k, v, k_scale, v_scale, dt)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if tuple(qpos.shape) != (b, t) or tuple(kpos.shape) != (b, s):
        raise ValueError(f"need qpos [{b}, {t}] and kpos [{b}, {s}], got {tuple(qpos.shape)}, "
                         f"{tuple(kpos.shape)}")
    if qpos.is_floating_point() or kpos.is_floating_point() or qpos.dtype == torch.bool:
        raise TypeError(f"qpos and kpos must be integers, got {qpos.dtype}, {kpos.dtype}")
    if valid is not None and (tuple(valid.shape) != (b, s) or valid.dtype != torch.bool):
        raise ValueError(f"valid must be bool [{b}, {s}], got {valid.dtype} {tuple(valid.shape)}")
    return b, t, h, hd, kv, s


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            qpos: torch.Tensor, kpos: torch.Tensor,
                            valid: Optional[torch.Tensor], *,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            dt: torch.dtype = torch.bfloat16,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`prefill_attention`: the dense mask
    (:func:`structured_mask`), then :func:`decode_attention_plain`, cast to
    ``out_dtype``."""
    _check_prefill(q, k, v, qpos, kpos, valid, k_scale, v_scale, dt, out_dtype)
    out = decode_attention_plain(q, k, v, structured_mask(qpos, kpos, valid), k_scale=k_scale,
                                 v_scale=v_scale, dt=dt)
    return out.to(out_dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                      kpos: torch.Tensor, valid: Optional[torch.Tensor], *,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      dt: torch.dtype = torch.bfloat16,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``_attn_core``'s output ``[B, T, H*hd]`` f32 for q ``[B, T, H, hd]``
    over K and V ``[B, KV, S, hd]`` in any of the cache's formats (as
    :func:`decode_attention` takes them; the no-cache forward's own K and
    V are a bf16 "cache" of S = T slots) under the mask ``(kpos[b, s] <=
    qpos[b, t]) & valid[b, s]`` (qpos ``[B, T]``, kpos ``[B, S]`` integers,
    valid ``[B, S]`` bool or None). A row with no attendable slot is the
    plain softmax's: the mean of ``bf16(1/S) v`` over all S slots.
    ``out_dtype`` bf16: the output rounded to bf16 as the kernel stores it
    (the encoder's cast, without a pass of its own). The encoder's key
    padding mask is ``qpos = kpos = 0`` with ``valid`` the mask. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    takes bf16 compute and :func:`prefill_kernel_takes`, and each (batch
    row, kv head) needs only contiguous slot rows (a kv-head slice is taken
    as it is)."""
    b, t, h, hd, kv, s = _check_prefill(q, k, v, qpos, kpos, valid, k_scale, v_scale, dt,
                                        out_dtype)
    dev = k.device
    if dev.type == "cpu":
        return prefill_attention_plain(q, k, v, qpos, kpos, valid, k_scale=k_scale,
                                       v_scale=v_scale, dt=dt, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no prefill_attention for device {dev}")
    _on_device(dev, "prefill_attention", q=q, v=v, qpos=qpos, kpos=kpos, valid=valid,
               k_scale=k_scale, v_scale=v_scale)
    if dt != torch.bfloat16 or q.dtype != torch.bfloat16:
        raise TypeError(f"prefill_attention kernel takes bf16 compute and q, got {dt}, {q.dtype}")
    groups = h // kv
    if not prefill_kernel_takes(groups, hd):
        raise ValueError(f"prefill_attention kernel takes G <= {_CONSUMER_ROWS} and a head_dim "
                         f"in {PREFILL_HEAD_DIMS}; got G {groups}, head_dim {hd}")
    kv_b, kv_h, sc_b, sc_r = _cache_strides(k, v, k_scale, v_scale)
    q = q.contiguous()
    qpos = qpos.to(torch.int32).contiguous()
    kpos = kpos.to(torch.int32).contiguous()
    valid = (torch.ones((b, s), dtype=torch.bool, device=dev) if valid is None
             else valid.contiguous())
    global last_prefill_plan
    plan = plan_prefill_attention(k.dtype, hd, groups, s, t, b * kv, kernels.sm_count(dev))
    ntiles = -(-s // plan.tile)
    nchunks = -(-s // PREFILL_CHUNK)
    keff = torch.empty((b, ntiles * plan.tile), dtype=torch.int32, device=dev)
    tmin = torch.empty((b, ntiles), dtype=torch.int32, device=dev)
    vpart = torch.empty((nchunks, b * kv, hd), dtype=torch.float32, device=dev)
    vsum = torch.empty((b * kv, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, t, h * hd), dtype=out_dtype, device=dev)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.prefill_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if k_scale is None else k_scale.data_ptr(),
                0 if v_scale is None else v_scale.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
                valid.data_ptr(), keff.data_ptr(), tmin.data_ptr(), vpart.data_ptr(),
                vsum.data_ptr(), out.data_ptr(), _KINDS[k.dtype], b, kv, groups, t, s, hd,
                kv4_group(hd), kv_b, kv_h, sc_b, sc_r, plan.tile, plan.stages, plan.raw_slots,
                plan.raw_stages, plan.smem, int(plan.regime == "persistent"), plan.grid,
                int(out_dtype == torch.bfloat16), scale,
                kernels.stream_ptr(dev),
            ),
            "prefill_attention",
        )
    kernels.LAUNCHES["prefill_attention"] += 1
    last_prefill_plan = plan
    return out
