"""The transformer block's elementwise work: three CUDA kernels and their
plain PyTorch versions.

Not a port of a Pallas kernel. The JAX package leaves this work to XLA,
which fuses it into a few passes over the block's activations:
``rms_norm`` (``probing_rag_tpu/models/gemma.py:338``), ``rope``
(``:743``), the K/V swap, quantization and ``dynamic_update_slice`` into
the cache (``:847-906``), the residual adds (``:913``, ``:947``) and
``act(gate) * up`` (``:915-932``). Plain PyTorch ops run it as some 150
kernels a layer, each writing an f32 copy. The three kernels here keep
the intermediates in registers:

- :func:`add_rms_norm` (``kernels/csrc/rms_norm.cu``): the residual add
  folded into the RMSNorm that follows it; a layer makes two launches
  (``attn_norm`` adds the previous block's MLP output, ``mlp_norm`` the
  attention output) and ``final_norm`` adds the last block's.
- :func:`rope_qk_cache` (``kernels/csrc/rope_kv.cu``): split-half RoPE of
  q and k, and k and v written into the layer's cache slots at the cursor
  in the cache's stored type (a cast, or int8 / int4 quantization), or, with
  no cache, into contiguous ``[B, KV, T, hd]`` tensors.
- :func:`gated_act` (``kernels/csrc/gated_act.cu``): ``act(gate) * up`` for
  GeGLU (tanh gelu) and SwiGLU (silu).

Each is bound by device-memory bytes on the H100 at a prefill's rows (a few
operations a byte, below its ridge of ~295), by latency at a decode step's:
the kernels read each input once and write each output once, and their
launch geometry comes from :func:`plan_norm`, :func:`plan_rope` and
:func:`plan_act`. CUDA tensors launch the kernel or raise on a dtype, shape or
stride it does not take; CPU tensors take the plain version (``*_plain``),
which is the JAX package's arithmetic as PyTorch ops. There is no other
switch. The checks run on every device, before either version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.ops.attention import kv4_group, pack_int4, quant_kv, quant_kv4

_FLOATS = {torch.bfloat16: 0, torch.float32: 1}
# the cache's stored types in rope_kv.cu: bf16, f32, int8, int4 (uint8 pairs)
_CACHE_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2, torch.uint8: 3}
ACTIVATIONS = {"gelu": 0, "silu": 1}
# rms_norm.cu: a row of a multiple of 8 up to this width
NORM_VEC = 8
NORM_MAX_D = 16384
ROPE_MAX_HEAD_DIM = 256


# ------------------------------------------------------------ plain versions


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = True
) -> torch.Tensor:
    """RMSNorm in f32 (the JAX ``rms_norm``): ``x * rsqrt(mean(x^2) + eps)``
    times ``1 + w`` (Gemma) or ``w``, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w32 = weight.float()
    return (normed * ((1.0 + w32) if plus_one else w32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half. x: [B, T, n, head_dim], positions: [B, T]."""
    hd = x.shape[-1]
    exponent = -torch.arange(0, hd // 2, dtype=torch.float32, device=x.device) / (hd // 2)
    freqs = torch.pow(theta, exponent)  # a scalar base: no host-to-device copy
    angles = positions[..., None].float() * freqs  # [B, T, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _cache_update(kv: dict, name: str, x: torch.Tensor, layer: int, slots: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Writes the new tokens' ``x`` [B, KV, T, hd] into ``kv[name]`` at the
    T buffer ``slots`` (a device tensor) of ``layer`` IN PLACE (quantized
    for an int8 or int4 cache, with their scales) and returns all S slots
    of the layer as stored, with its scales (None for a bf16 or f32
    cache): the shapes never depend on the cursor."""
    buf = kv[name][layer]
    if buf.dtype == torch.uint8:  # int4, nibble-packed; scales [L, B, KV*G, S]
        q, s = quant_kv4(x)  # s [B, KV, T, G]
        b, kvh, t, g = s.shape
        scales = kv[f"{name}_scale"][layer]
        buf.index_copy_(2, slots, pack_int4(q))
        scales.index_copy_(2, slots, s.transpose(-1, -2).reshape(b, kvh * g, t))
        return buf, scales
    if buf.dtype == torch.int8:  # scales [L, B, KV, S]
        q, s = quant_kv(x)
        scales = kv[f"{name}_scale"][layer]
        buf.index_copy_(2, slots, q)
        scales.index_copy_(2, slots, s[..., 0])
        return buf, scales
    buf.index_copy_(2, slots, x.to(buf.dtype))
    return buf, None


def add_rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool, *,
                       delta: Optional[torch.Tensor] = None,
                       dt: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_rms_norm`: the add in ``x``'s dtype, then
    :func:`rms_norm`, cast to ``dt``."""
    _check_norm(x, weight, delta, dt)
    resid = x if delta is None else x + delta.to(x.dtype)
    return resid, rms_norm(resid, weight, eps, plus_one).to(dt)


def rope_qk_cache_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, theta: float, *,
                        cache: Optional[Tuple] = None):
    """Plain version of :func:`rope_qk_cache`: :func:`rope` of q and k, the
    swap to ``[B, KV, T, hd]``, then :func:`_cache_update` at the slots
    ``pos + [0, T)`` or, without a cache, contiguous copies."""
    _check_rope(q, k, v, positions, cache)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta).transpose(1, 2)
    v = v.transpose(1, 2)
    if cache is None:
        return q, k.contiguous(), v.contiguous(), None, None
    kv, layer, pos = cache
    slots = pos + torch.arange(q.shape[1], dtype=torch.int64, device=pos.device)
    k, k_scale = _cache_update(kv, "k", k, layer, slots)
    v, v_scale = _cache_update(kv, "v", v, layer, slots)
    return q, k, v, k_scale, v_scale


def gated_act_plain(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    """Plain version of :func:`gated_act`: ``act(gate)`` rounded to the
    compute type, then the product rounded to it."""
    _check_gated(gate, up, activation)
    act = F.gelu(gate, approximate="tanh") if activation == "gelu" else F.silu(gate)
    return act * up


# --------------------------------------------------------------- tolerances
#
# Where a kernel may not equal its plain version bit for bit (a torch whose
# reduction is laid out otherwise, a libm that rounds otherwise), how far
# each output element may lie from it. Each bound is an f32 interval around the
# plain version's unrounded value, then carried through the rounding to the
# compute type: where both ends round to one value the kernel must give
# exactly that value (bf16: most elements); where they round to neighbours,
# it may give either. A fault (a dropped (1 + w), a skipped intermediate
# rounding, a wrong rotation) lands outside it.

# the norm's f32 sum of squares in another order than torch's mean (a torch
# whose reduction lays a row out otherwise than rms_norm.cu follows; the
# CPU's): a few f32 ulps of the sum (each side's rounding grows with log2
# of the width over its tree, and with the elements a thread sums in a row),
# halved by the rsqrt; 2^-19 of the value bounds it with room
NORM_REL = 2.0 ** -19
# cosf / sinf / powf of one library against another (the tests' JAX): a few
# f32 ulps of each, and an ulp of the frequency grows by the angle
ROPE_REL = 2.0 ** -21
# tanhf / expf against another implementation, and the gelu expression
# contracted into FMAs otherwise: 2^-18 of |act| (a few ulps of tanh's
# argument, grown by at most |inner| ~ 5 where 1 + tanh is small), plus
# 2^-21 of |x| for gelu (its 1 + tanh cancels for negative x, where an
# ulp of tanh near -1 is one of |x| / 2)
ACT_REL = 2.0 ** -18
ACT_X_REL = 2.0 ** -21


def rounding_bound(ref: torch.Tensor, err: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """How far a value within ``err`` of the f32 ``ref`` may lie from
    ``ref`` rounded to ``dt``, element by element: at f32, ``err`` plus an
    ulp; at bf16, the distance between the roundings of ``ref - err`` and
    ``ref + err`` (0 where both round to one value)."""
    if dt == torch.float32:
        return err + ref.abs() * 2.0 ** -23
    return (ref + err).to(dt).float() - (ref - err).to(dt).float()


def norm_tolerance(resid: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool,
                   dt: torch.dtype) -> torch.Tensor:
    """The per-element bound of :func:`add_rms_norm`'s ``normed`` around
    the plain one: ``NORM_REL`` of the f32 value, through the rounding to
    ``dt``. ``resid`` is the f32 input of the norm (x + delta)."""
    ref = rms_norm(resid.float(), weight, eps, plus_one)
    return rounding_bound(ref, NORM_REL * ref.abs(), dt)


def rope_tolerance(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The per-element bound of the rotated ``x`` [B, T, n, hd] (in its own
    dtype) around the plain :func:`rope`: ``ROPE_REL (|x1| + |x2|) (|angle|
    + 4)`` in f32 (cos and sin a few ulps off, the angle an ulp of the
    frequency times the position), through the rounding. On the card the
    kernel and the plain ops call the same cosf, sinf and powf, so it
    expects no difference at all; the bound is for a libm that differs."""
    hd = x.shape[-1]
    ref = rope(x.float(), positions, theta)
    x1, x2 = x.float().abs().chunk(2, dim=-1)
    freqs = torch.pow(theta, -torch.arange(0, hd // 2, dtype=torch.float32,
                                           device=x.device) / (hd // 2))
    angle = (positions[..., None].float() * freqs).abs()[..., None, :]
    err = ROPE_REL * (x1 + x2) * (angle + 4.0)
    return rounding_bound(ref, torch.cat([err, err], dim=-1), x.dtype)


def gated_tolerance(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    """The per-element bound of :func:`gated_act` around the plain one:
    ``act`` within ``ACT_REL |act|`` (gelu: plus ``ACT_X_REL |x|``) of the
    f32 value, rounded to the compute type at both ends, each end times
    ``up`` rounded again; the bound is the distance between the two (0 at
    bf16 where ``act`` rounds to one value, as the product of two bf16
    values is exact in f32), plus an ulp at f32."""
    dt = gate.dtype
    g = gate.float()
    act = F.gelu(g, approximate="tanh") if activation == "gelu" else F.silu(g)
    err = ACT_REL * act.abs() + (ACT_X_REL * g.abs() if activation == "gelu" else 0.0)
    u = up.float()
    lo = ((act - err).to(dt).float() * u).to(dt).float()
    hi = ((act + err).to(dt).float() * u).to(dt).float()
    out = (hi - lo).abs()
    if dt == torch.float32:
        out = out + (act * u).abs() * 2.0 ** -23
    return out


# ------------------------------------------------------------------ planners
#
# The kernels' launch geometry, chosen here from the shapes and passed to
# the C entries, which check it. The CPU tests carry each plan out in numpy
# (tests/test_torch_block_plan.py).

# rms_norm.cu: up to this many rows a row is a block of its own (a decode
# step's 8, a verify round's 40: spread over as many SMs); from it on the
# "stream" regime packs rows into blocks of NORM_STREAM_THREADS threads
NORM_STREAM_ROWS = 1024
NORM_STREAM_THREADS = 128
NORM_CHUNKS = (4, 8, 16)  # vectors a thread takes at a time
NORM_MAX_THREADS = 512  # a block; 256 for chunks of 8 vectors or more
# rope_kv.cu: row steps a warp holds at once; a block's threads
ROPE_MAX_STEPS = 6
ROPE_MAX_THREADS = 512
# up to this many tokens (a decode step's 8, a verify round's 40) a warp
# takes one step (up to 16 warps a token), so a token's rows spread over
# warps; from it on a warp takes as many of a token's steps as it holds,
# ROPE_STREAM_WARPS warps a block
ROPE_STREAM_TOKENS = 256
ROPE_STREAM_WARPS = 4
# a lane's vectors at a decode step into an int8 / int4 cache, where a row
# then fits a warp: a key or value row a warp halves each lane's divides
ROPE_DECODE_VEC_BYTES = 8


def _last_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def torch_row_threads(units: int, rows: int) -> int:
    """The threads torch's CUDA reduction gives one row of ``units`` loads
    (4-wide vectors from 128 wide on, else elements) over ``rows`` rows:
    its ``block_width`` from ``setReduceConfig`` (``ATen/native/cuda/
    Reduce.cuh``), at most 512 threads a block, at least a warp.
    ``rms_norm.cu`` holds the same rule and refuses another width."""
    mt = NORM_MAX_THREADS
    d0 = _last_pow2(units) if units < mt else mt
    d1 = _last_pow2(rows) if rows < mt else mt
    width = min(d0, 32)
    height = min(d1, mt // width)
    width = min(d0, mt // height)
    return max(width, 32)


def _norm_cap(chunk: int) -> int:
    """A block's threads at most for a chunk of that many vectors."""
    return 256 if chunk >= 8 else NORM_MAX_THREADS


class NormPlan(NamedTuple):
    regime: str  # "latency": a row a block; "stream": rows packed into blocks
    width: int  # threads a row (torch's)
    rows_block: int
    blocks: int
    per: int  # vectors (from 128 wide; else elements) a thread sums
    chunk: int  # of them it loads at once; more than one chunk: read again


def plan_norm(rows: int, d: int) -> NormPlan:
    """``rms_norm.cu``'s launch over ``rows`` rows of width ``d``: the
    threads a row are torch's (:func:`torch_row_threads`), so the sum keeps
    torch's order; what the rows decide is how many share a block."""
    units = d // 4 if d >= 128 else d
    width = torch_row_threads(units, rows)
    per = -(-units // width)
    # the smallest chunk that holds the thread's vectors and takes the width
    # (a wider row: the largest that takes it, a chunk at a time)
    fits = [c for c in (NORM_CHUNKS if d >= 128 else (4,)) if width <= _norm_cap(c)]
    chunk = next((c for c in fits if c >= per), fits[-1])
    cap = _norm_cap(chunk)
    if rows < NORM_STREAM_ROWS:
        regime, rows_block = "latency", 1
    else:
        regime, rows_block = "stream", max(1, min(NORM_STREAM_THREADS, cap) // width)
    return NormPlan(regime, width, rows_block, max(1, -(-rows // rows_block)), per, chunk)


class RopePlan(NamedTuple):
    regime: str  # "decode": a step a warp; "stream": a token's steps a warp
    vec_bytes: int  # a lane's vectors: 16, or 8 at a decode step where a row fits a warp
    lanes_row: int  # lanes a row: its half over vec_bytes vectors, a power of two
    rows_step: int  # rows a warp takes at once (32 / lanes_row)
    steps: int  # a token's steps: its h + 2 kvh rows over rows_step
    steps_warp: int
    warps_token: int
    tokens_block: int
    blocks: int


def plan_rope(b: int, t: int, h: int, kvh: int, hd: int, dt: torch.dtype,
              quantized: bool = False) -> RopePlan:
    """``rope_kv.cu``'s launch over ``b * t`` tokens of ``h`` query and
    ``kvh`` key / value heads of ``hd`` in ``dt``, into an int8 / int4
    cache if ``quantized``: a lane holds a vector of each half of a row,
    ``32 / lanes_row`` rows a warp step. A decode step or verify round (up
    to ``ROPE_STREAM_TOKENS`` tokens) gives a warp one step, into a
    quantized cache in 8-byte vectors where a row then fits a warp and a
    token 16 warps; a prefill packs a token's steps into as few warps as
    hold them."""
    es = torch.empty((), dtype=dt).element_size()
    rows = h + 2 * kvh
    max_warps = ROPE_MAX_THREADS // 32

    def geometry(vec_bytes):  # (lanes a row, rows a step, steps a token)
        lanes = 1
        while lanes < hd // 2 * es // vec_bytes:
            lanes *= 2
        return lanes, max(1, 32 // lanes), -(-rows // max(1, 32 // lanes))

    tokens = b * t
    vec_bytes = 16
    if tokens <= ROPE_STREAM_TOKENS:  # a step a warp, or as few as a block's warps allow
        lanes, _, steps = geometry(ROPE_DECODE_VEC_BYTES)
        if quantized and lanes <= 32 and steps <= max_warps:
            vec_bytes = ROPE_DECODE_VEC_BYTES
        regime = "decode"
    else:
        regime = "stream"
    lanes, rows_step, steps = geometry(vec_bytes)
    if regime == "decode":
        steps_warp = -(-steps // max_warps)
    else:
        steps_warp = -(-steps // -(-steps // ROPE_MAX_STEPS))
    warps_token = -(-steps // steps_warp)
    tokens_block = 1 if regime == "decode" else max(1, ROPE_STREAM_WARPS // warps_token)
    return RopePlan(regime, vec_bytes, lanes, rows_step, steps, steps_warp, warps_token,
                    tokens_block, max(1, -(-tokens // tokens_block)))


# gated_act.cu (its constants are these; the C entry refuses another
# plan): one pass at every size, a vector of ACT_VEC_BYTES a thread in
# blocks of ACT_THREADS, as many blocks as the vectors need
ACT_VEC_BYTES = 8
ACT_THREADS = 128
ACT_MAX_INDEX = 2**31 - 1  # the kernel's thread indices in 32-bit ints


class ActPlan(NamedTuple):
    vec_bytes: int  # a thread's vector (the last one ragged where n is not a multiple)
    threads: int  # a block
    blocks: int


def plan_act(n: int, dt: torch.dtype) -> ActPlan:
    """``gated_act.cu``'s launch over ``n`` values of ``dt``: one pass, a
    vector of ``ACT_VEC_BYTES`` a thread (the last ragged where ``n`` is
    not a multiple of it), neighbouring threads on neighbouring vectors,
    ``ACT_THREADS`` a block and as many blocks as the vectors need (a
    decode step's [8 x 16,384] bf16: 256 blocks, every SM). On the card one
    pass takes a same-bytes ``torch.add``'s time at a prefill's rows and a
    few percent more at a decode step's (``chip_smoke.py`` phase 9a), where
    a resident grid looping over the tensor was slower, so no size takes
    another geometry and the SM count does not enter. Depends on the shapes
    alone, so a captured decode step keeps its geometry."""
    vecs = -(-n // (ACT_VEC_BYTES // torch.empty((), dtype=dt).element_size()))
    blocks = max(1, -(-vecs // ACT_THREADS))
    if blocks * ACT_THREADS > ACT_MAX_INDEX:
        raise ValueError(f"gated_act kernel indexes its threads in 32-bit ints: {n} values of "
                         f"{dt} need more")
    return ActPlan(ACT_VEC_BYTES, ACT_THREADS, blocks)


# the last launches' plans (chip_smoke.py prints them)
last_plan = {"rms_norm": None, "rope_kv": None, "gated_act": None}


# ------------------------------------------------------------------- checks


def _check_norm(x, weight, delta, dt) -> Tuple[int, int]:
    """Returns (rows, width)."""
    if x.dtype != torch.float32:
        raise TypeError(f"add_rms_norm takes the f32 residual stream, got {x.dtype}")
    if dt not in _FLOATS or weight.dtype not in _FLOATS:
        raise TypeError(f"add_rms_norm takes bf16 or f32 for dt and the weight, got {dt}, "
                        f"{weight.dtype}")
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight must be [{d}], got {tuple(weight.shape)}")
    if delta is not None:
        if delta.shape != x.shape or delta.dtype not in _FLOATS:
            raise ValueError(f"delta must be bf16 or f32 of x's shape {tuple(x.shape)}, got "
                             f"{delta.dtype} {tuple(delta.shape)}")
    if not x.is_contiguous() or (delta is not None and not delta.is_contiguous()):
        raise ValueError("add_rms_norm takes contiguous x and delta")
    return x.numel() // max(d, 1), d


def _check_rope(q, k, v, positions, cache):
    """Returns (b, t, h, kvh, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B, T, H, hd] and k, v [B, T, KV, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != hd or hd % 2:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(positions.shape) != (b, t) or positions.dtype != torch.int64:
        raise ValueError(f"positions must be int64 [{b}, {t}], got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("rope_qk_cache takes contiguous q, k and v (the products' outputs)")
    if cache is not None:
        kv, layer, pos = cache
        buf = kv["k"]
        if buf.dtype not in _CACHE_KINDS or kv["v"].dtype != buf.dtype:
            raise TypeError(f"no rope_qk_cache for a {buf.dtype} cache")
        row = hd // 2 if buf.dtype == torch.uint8 else hd
        if buf.dim() != 5 or buf.shape[1] != b or buf.shape[2] != kvh or buf.shape[4] != row:
            raise ValueError(f"cache {tuple(buf.shape)} does not hold k {tuple(k.shape)}")
        if pos.dim() != 0 or pos.dtype != torch.int64:
            raise ValueError(f"the cursor must be a 0-dim int64 tensor, got {pos.dtype} "
                             f"{tuple(pos.shape)}")
    return b, t, h, kvh, hd


def _check_gated(gate, up, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if gate.dtype not in _FLOATS or up.dtype != gate.dtype or up.shape != gate.shape:
        raise TypeError(f"gate and up must share a bf16 or f32 type and a shape, got "
                        f"{gate.dtype} {tuple(gate.shape)}, {up.dtype} {tuple(up.shape)}")
    if not (gate.is_contiguous() and up.is_contiguous()):
        raise ValueError("gated_act takes contiguous gate and up")


def _on_cuda(what: str, *tensors) -> bool:
    """True for CUDA tensors (all on one device), False for CPU tensors;
    raises for any other device or a mix."""
    devs = {x.device for x in tensors if x is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {dev}")
    return dev.type == "cuda"


def _aligned(what: str, *tensors) -> None:
    for x in tensors:
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{what} needs 16-byte aligned tensors")


# ----------------------------------------------------------------- wrappers


def add_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = True, *,
                 delta: Optional[torch.Tensor] = None,
                 dt: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(resid, normed)``: ``resid = x + f32(delta)`` (``x`` itself without
    a delta) in f32 and ``normed = rms_norm(resid, weight)`` in ``dt``, for
    the f32 residual stream ``x`` [.., D], ``delta`` [.., D] in bf16 or f32
    (the attention output, the previous block's MLP output) and the
    weight [D] in its stored type. The add is exact and equal to the plain
    one; the kernel sums the squares in the order of torch's CUDA
    reduction (``rms_norm.cu``), so ``normed`` is expected bit-equal to the
    plain version on the card, and lies within :func:`norm_tolerance` of it
    where torch orders its sum otherwise. CPU tensors take
    :func:`add_rms_norm_plain`."""
    rows, d = _check_norm(x, weight, delta, dt)
    if not _on_cuda("add_rms_norm", x, weight, delta):
        return add_rms_norm_plain(x, weight, eps, plus_one, delta=delta, dt=dt)
    if d % NORM_VEC or d > NORM_MAX_D or not weight.is_contiguous():
        raise ValueError(f"rms_norm kernel takes a contiguous weight and a width that is a "
                         f"multiple of {NORM_VEC} up to {NORM_MAX_D}, got {d}")
    _aligned("add_rms_norm", x, weight, delta)
    resid = x if delta is None else torch.empty_like(x)
    normed = torch.empty(x.shape, dtype=dt, device=x.device)
    plan = last_plan["rms_norm"] = plan_norm(rows, d)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(
            lib.rms_norm(
                x.data_ptr(), 0 if delta is None else delta.data_ptr(), weight.data_ptr(),
                resid.data_ptr(), normed.data_ptr(),
                0 if delta is None else 1 + _FLOATS[delta.dtype], _FLOATS[weight.dtype],
                _FLOATS[dt], rows, d, float(np.float32(eps)), int(plus_one), plan.width,
                plan.rows_block, plan.blocks, plan.chunk, kernels.stream_ptr(x.device),
            ),
            "rms_norm",
        )
    kernels.LAUNCHES["rms_norm"] += 1
    return resid, normed


def rope_qk_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  theta: float, *, cache: Optional[Tuple] = None):
    """Split-half RoPE of ``q`` [B, T, H, hd] and ``k`` [B, T, KV, hd] at
    ``positions`` [B, T] int64 (in f32, rounded to q's dtype), with the
    rotated k and ``v`` written where attention reads them. Returns ``(q,
    k, v, k_scale, v_scale)``:

    - ``cache = (kv_cache, layer, pos)`` (``init_kv_cache``'s dict, the
      layer, the cursor as a 0-dim int64 tensor on the cache's device): k
      and v go IN PLACE into ``kv_cache["k"/"v"][layer]`` at the slots
      ``[pos, pos + T)`` in the cache's stored type (bf16 or f32: a cast;
      int8: one ``absmax / 127`` scale a slot and kv head; int4: one ``/ 7``
      scale a ``kv4_group`` of lanes, nibble-packed), as
      :func:`_cache_update` writes them; the kernel reads ``pos`` on the
      device, so a CUDA graph may capture the call. Returns the layer's
      views ``[B, KV, S, hd]`` and its scales (None for bf16 or f32).
    - no cache: k and v as new contiguous ``[B, KV, T, hd]`` tensors in q's
      dtype (the layout ``prefill_attention`` takes).

    On the card the kernel rotates q IN PLACE in its buffer (the product's
    output, a temporary) and returns it; the plain version returns a new
    tensor. Slots at or past S are not written. CPU tensors take
    :func:`rope_qk_cache_plain`."""
    b, t, h, kvh, hd = _check_rope(q, k, v, positions, cache)
    kv = pos = None
    if cache is not None:
        kv, layer, pos = cache
    tensors = (q, k, v, positions) + ((kv["k"], kv["v"], pos) if kv is not None else ())
    if not _on_cuda("rope_qk_cache", *tensors):
        return rope_qk_cache_plain(q, k, v, positions, theta, cache=cache)
    if hd > ROPE_MAX_HEAD_DIM or hd % 16:
        raise ValueError(f"rope_kv kernel takes a head dim that is a multiple of 16 up to "
                         f"{ROPE_MAX_HEAD_DIM}, got {hd}")
    if kv is None:
        kind, s = _CACHE_KINDS[q.dtype], t
        kbuf = torch.empty((b, kvh, t, hd), dtype=q.dtype, device=q.device)
        vbuf = torch.empty_like(kbuf)
        ks = vs = None
    else:
        kbuf, vbuf = kv["k"][layer], kv["v"][layer]
        kind, s = _CACHE_KINDS[kbuf.dtype], kbuf.shape[2]
        ks = kv.get("k_scale")
        vs = kv.get("v_scale")
        ks, vs = (None, None) if kind < 2 else (ks[layer], vs[layer])
        if kind >= 2:
            rows = kvh * (hd // kv4_group(hd)) if kind == 3 else kvh
            if (ks is None or tuple(ks.shape) != (b, rows, s) or ks.stride() != vs.stride()
                    or ks.stride(-1) != 1 or ks.dtype != torch.float32
                    or vs.dtype != torch.float32):
                raise ValueError(f"an int8 / int4 cache needs f32 scales [L, {b}, {rows}, {s}] "
                                 f"with contiguous slots")
    if (kbuf.stride() != vbuf.stride() or kbuf.stride(-1) != 1
            or kbuf.stride(-2) != kbuf.shape[-1]):
        raise ValueError(f"rope_kv kernel needs k and v caches with contiguous slot rows and "
                         f"shared strides, got {kbuf.stride()}, {vbuf.stride()}")
    sc_b, sc_r = (ks.stride(0), ks.stride(1)) if ks is not None else (0, 0)
    _aligned("rope_qk_cache", q, k, v, kbuf, vbuf)
    plan = last_plan["rope_kv"] = plan_rope(b, t, h, kvh, hd, q.dtype, kind >= 2)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(
            lib.rope_kv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
                0 if pos is None else pos.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
                0 if ks is None else ks.data_ptr(), 0 if vs is None else vs.data_ptr(),
                _FLOATS[q.dtype], kind, b, t, h, kvh, hd, s, kv4_group(hd),
                positions.stride(0), positions.stride(1), kbuf.stride(0), kbuf.stride(1),
                sc_b, sc_r, float(theta), plan.vec_bytes, plan.lanes_row, plan.steps_warp,
                plan.warps_token,
                plan.tokens_block, plan.blocks, kernels.stream_ptr(q.device),
            ),
            "rope_kv",
        )
    kernels.LAUNCHES["rope_kv"] += 1
    return q, kbuf, vbuf, ks, vs


def gated_act(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    """``act(gate) * up`` on ``gate``, ``up`` [.., F] in bf16 or f32, for
    ``activation`` "gelu" (tanh form, GeGLU) or "silu" (SwiGLU): ``act``
    computed in f32 and rounded to the compute type, then the product
    rounded to it, as the plain ops round. On the card the kernel writes
    the result IN PLACE into ``gate``'s buffer (the product's output, a
    temporary) and returns it, its launch geometry from :func:`plan_act`;
    the plain version returns a new tensor. CPU tensors take
    :func:`gated_act_plain`."""
    _check_gated(gate, up, activation)
    if not _on_cuda("gated_act", gate, up):
        return gated_act_plain(gate, up, activation)
    _aligned("gated_act", gate, up)
    n = gate.numel()
    plan = last_plan["gated_act"] = plan_act(n, gate.dtype)
    if n == 0:
        return gate
    lib = kernels.library()
    with torch.cuda.device(gate.device):
        kernels.check(
            lib.gated_act(gate.data_ptr(), up.data_ptr(), gate.data_ptr(), _FLOATS[gate.dtype],
                          ACTIVATIONS[activation], n, plan.vec_bytes, plan.threads,
                          plan.blocks, kernels.stream_ptr(gate.device)),
            "gated_act",
        )
    kernels.LAUNCHES["gated_act"] += 1
    return gate
