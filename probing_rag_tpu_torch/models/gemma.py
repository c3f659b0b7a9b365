"""Gemma-architecture LM in PyTorch with functional activation capture.

Port of ``probing_rag_tpu/models/gemma.py``: the forward returns the
residual-stream activations at the requested (layer, site) pairs as part
of its output, in place of the reference's transformer_lens hooks.

Architecture (Gemma 1, google/gemma-2b):
- embeddings scaled by sqrt(d_model) in f32; tied LM head
- RMSNorm with (1 + w) scaling, pre-norm blocks
- rotary position embeddings (split-half) on q/k, theta 10000
- multi-query attention (1 kv head for the 2B config), head_dim 256
- GeGLU MLP (tanh gelu(gate) * up)
Mistral semantics (plain RMSNorm weights, SwiGLU, unscaled embeddings,
untied head) come from the same code through ``GemmaConfig`` flags.

Layouts are the JAX package's, so converting its parameters is a copy:
weights ``[in, out]`` stacked over layers (``[L, ...]``), the KV cache
``[L, B, KV, S, hd]``. Matmuls run in ``compute_dtype``; the residual stream
and norms stay f32. Attention computes the JAX package's function: f32
scores, ``-1e30`` masking, softmax, the probabilities rounded to the
compute type. ``_block`` routes each call (``ops/attention.py`` holds the
kernels' wrappers, which read the cache in its stored type):

- ``attn_probs_layer`` (the probabilities are returned): plain ops over
  the dequantized cache;
- bf16 compute over the cache at G x T <= 64 query rows a kv head (the
  decode step, the speculative verify round): ``decode_attention``;
- every other bf16 call (prefill over the cache, the no-cache forward of
  the capture and the traces): ``prefill_attention``, with the mask in
  structured form ``(kpos <= qpos) & valid`` (``forward`` passes the three
  tensors beside the dense mask);
- f32 compute (a checking mode): ``decode_attention`` over the cache where
  ``kernel_takes`` holds, else the plain ops.

The block's elementwise work runs on ``ops/block.py``'s kernels on every
path: ``add_rms_norm`` with the previous residual add folded in (so a
block takes ``delta``, the previous block's MLP output, and the final
norm adds the last one), ``rope_qk_cache`` (RoPE and the cache write at
the device-side cursor) and ``gated_act``.

Quantized serving (``quantize_lm_params``) keeps the JAX boundary formats:
per-channel int8 ``{"q": int8, "s": f32}``, grouped int4 ``{"qp": uint8,
"gs": f32}`` and rank-1 int4 ``{"qp": uint8, "rs": f32 [K, 1], "s": f32
[1, F]}``, int4 values nibble-packed two to a byte. Every w8a16 product,
the tied head included, runs on ``ops/matmul.py::matmul_int8``; every w4a16
product (rank-1 at every row count below the w4a8 threshold, grouped up to
``_INT4_DEQUANT_ROWS`` rows, the tied head of an int4 embedding) on
``ops/matmul.py::matmul_int4``, which reads the packed nibbles. The
weight is unpacked only for the embedding lookup's rows, grouped int4
above ``_INT4_DEQUANT_ROWS`` rows and rank-1's w4a8 product. The KV cache
may be int8 or int4 (``init_kv_cache``).

Tensor parallelism (``forward(tp=group)``, parameters from
``parallel/mesh.py::shard_lm_params``): JAX gets it from GSPMD with the
forward unchanged; here the collectives are written out. Each rank holds
``n_heads / tp`` query heads (``wq`` by column), ``w_gate``/``w_up`` by
column, ``wo``/``w_down`` by row (each of these two products ends in an
``all_reduce``), the embedding and an untied head by vocab (the lookup
zeroes the ids outside the rank's rows and all-reduces; the head's
vocab-sharded logits are all-gathered). ``wk``/``wv`` and the KV cache
are replicated. The residual stream, the captures and the logits are the
same on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the KV cache's formats live with the attention kernel that reads them
from probing_rag_tpu_torch.ops.attention import (
    attn_core,
    decode_attention,
    dequant_kv,
    kernel_takes,
    kv4_group,
    pack_int4,
    prefill_attention,
    prefill_kernel_takes,
    structured_mask,
    unpack_int4,
)
# the block's elementwise kernels; rms_norm, rope and _cache_update are
# their plain pieces
from probing_rag_tpu_torch.ops.block import (  # noqa: F401
    _cache_update,
    add_rms_norm,
    gated_act,
    rms_norm,
    rope,
    rope_qk_cache,
)
from probing_rag_tpu_torch.ops.matmul import matmul_int4, matmul_int8

Params = Dict[str, Any]


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256_000
    d_model: int = 2048
    n_layers: int = 18
    n_heads: int = 8
    n_kv_heads: int = 1
    head_dim: int = 256
    d_ff: int = 16_384
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # probers read these layers (range(6, 17, 2) for gemma-2b)
    probe_layers: Tuple[int, ...] = (6, 8, 10, 12, 14, 16)
    compute_dtype: torch.dtype = torch.bfloat16
    resid_dtype: torch.dtype = torch.float32
    # ---- family semantics (Gemma defaults; Mistral/Llama flip all four) ----
    norm_plus_one: bool = True  # RMSNorm scale (1 + w) vs plain w
    mlp_activation: str = "gelu"  # GeGLU "gelu" vs SwiGLU "silu"
    scale_embeddings: bool = True  # sqrt(d_model) input-embedding scaling
    tied_head: bool = True  # LM head == embed.T vs separate params["lm_head"]
    # above this many activation rows (batch x tokens) an int8 weight runs
    # w8a8 (rank-1 int4: w4a8); 0 = never. Prefill crosses it, decode not.
    act_int8_rows: int = 0

    @classmethod
    def gemma_2b(cls) -> "GemmaConfig":
        return cls()

    @classmethod
    def mistral_7b(cls) -> "GemmaConfig":
        return cls(
            vocab_size=32_000,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=14_336,
            probe_layers=(12, 14, 16, 18, 20, 22),
            norm_plus_one=False,
            mlp_activation="silu",
            scale_embeddings=False,
            tied_head=False,
        )

    @classmethod
    def tiny_mistral(cls, vocab_size: int = 512) -> "GemmaConfig":
        """Scaled-down Mistral semantics (GQA, silu, untied head) for tests."""
        return cls(
            vocab_size=vocab_size,
            d_model=64,
            n_layers=4,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            probe_layers=(1, 2),
            norm_plus_one=False,
            mlp_activation="silu",
            scale_embeddings=False,
            tied_head=False,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "GemmaConfig":
        """A scaled-down config with the full code path, for tests."""
        return cls(
            vocab_size=vocab_size,
            d_model=64,
            n_layers=4,
            n_heads=2,
            n_kv_heads=1,
            head_dim=32,
            d_ff=128,
            probe_layers=(1, 2),
        )


@dataclass(frozen=True)
class CaptureSpec:
    """Which residual-stream activations the forward returns: an ordered
    tuple of (layer, site) pairs, site ``resid_mid`` (after the attention
    branch) or ``resid_post`` (after the MLP branch). ``captures`` is
    stacked in this order: [n_sites, batch, seq, d_model]."""

    sites: Tuple[Tuple[int, str], ...] = ()

    @classmethod
    def for_probing(cls, cfg: GemmaConfig, position: str = "resid_post") -> "CaptureSpec":
        return cls(tuple((l, position) for l in cfg.probe_layers))

    @property
    def n_sites(self) -> int:
        return len(self.sites)


# ------------------------------------------------------------------ params


def _init_leaves(cfg: GemmaConfig, generator: torch.Generator, device, dtype: torch.dtype):
    """``init_params``' leaves as ``(name, layer_leaf, tensor)``, each drawn
    when it is asked for and in this order (embed, final norm, the layer
    families, an untied head), so that a caller consuming them one at a
    time holds one at a time. Dense weights are drawn in f32 from
    ``generator`` on ``device``, scaled by 1 / sqrt(fan_in) and cast to
    ``dtype``."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers

    def norm_init(*shape):
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return fill(shape, dtype=dtype, device=device)

    def dense_init(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.div_(math.sqrt(shape[-2])).to(dtype)

    yield "embed", False, dense_init(cfg.vocab_size, d)
    yield "final_norm", False, norm_init(d)
    for name, shape in (("attn_norm", (L, d)), ("wq", (L, d, h * hd)), ("wk", (L, d, kv * hd)),
                        ("wv", (L, d, kv * hd)), ("wo", (L, h * hd, d)), ("mlp_norm", (L, d)),
                        ("w_gate", (L, d, f)), ("w_up", (L, d, f)), ("w_down", (L, f, d))):
        yield name, True, (norm_init if name.endswith("norm") else dense_init)(*shape)
    if not cfg.tied_head:
        yield "lm_head", False, dense_init(d, cfg.vocab_size)


def init_params(
    cfg: GemmaConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with the JAX ``init_params`` distribution: dense
    weights N(0, 1) / sqrt(fan_in), norm weights at identity. Each leaf is
    drawn in f32 on ``device`` from ``generator`` and cast to ``dtype``."""
    params: Params = {}
    for name, layer_leaf, w in _init_leaves(cfg, generator, device, dtype):
        (params.setdefault("layers", {}) if layer_leaf else params)[name] = w
    return params


def init_quantized_lm_params(
    cfg: GemmaConfig,
    generator: torch.Generator,
    bits: int = 8,
    group_size: Optional[int] = None,
    int4_scheme: str = "grouped",
    device="cuda",
) -> Params:
    """Random init straight into the quantized serving format, one leaf at
    a time: each leaf is drawn as ``init_params(..., dtype=torch.bfloat16)``
    draws it (the same generator calls, in the same order), quantized as
    ``quantize_lm_params`` quantizes it, and dropped before the next is
    drawn. The tree is bit-equal to ``quantize_lm_params(init_params(cfg,
    generator, device, torch.bfloat16), bits, group_size, int4_scheme)``
    from the same generator state. The peak is the quantized tree plus one
    leaf's f32 draw and its bf16 cast (bit-equality with ``init_params``
    needs its one f32 ``randn`` a leaf), where quantize-of-init holds the
    whole bf16 tree. Port of the JAX stacked form (``unstacked=True`` is an
    XLA workaround and is not ported)."""
    _check_quant_args(bits, int4_scheme)
    if bits == 4 and group_size is None:
        group_size = _group_size_for((cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff))
    params: Params = {}
    for name, layer_leaf, w in _init_leaves(cfg, generator, device, torch.bfloat16):
        if name in _QUANTIZED:  # the bf16 leaf is freed here, before the next draw
            w = _quant_leaf(name, w, bits, group_size, int4_scheme, 8)
        (params.setdefault("layers", {}) if layer_leaf else params)[name] = w
    return params


def param_count(params: Params) -> int:
    """Elements over every leaf of a (possibly quantized) parameter tree."""
    return sum(param_count(v) if isinstance(v, dict) else v.numel() for v in params.values())


# ------------------------------------------------ int8/int4 quantization

# Above this many activation rows the grouped-int4 product dequantizes the
# weight to a transient compute-dtype copy instead of the per-group batched
# product, whose [rows, K, F] partials would outweigh it (the JAX rule).
_INT4_DEQUANT_ROWS = 1024


def _per_matrix(fn, w: torch.Tensor, *args) -> Params:
    """``fn`` over the trailing [D, F] matrices of a layer-stacked ``w``
    one at a time, so that only one matrix's f32 copy exists; the results
    are stacked over the leading dims."""
    if w.dim() == 2:
        return fn(w, *args)
    flat = w.reshape(-1, *w.shape[-2:])
    out: Params = {}
    for i in range(flat.shape[0]):
        for name, v in fn(flat[i], *args).items():
            if name not in out:
                out[name] = torch.empty((flat.shape[0], *v.shape), dtype=v.dtype, device=v.device)
            out[name][i] = v
    return {name: v.reshape(*w.shape[:-2], *v.shape[1:]) for name, v in out.items()}


# vocab rows the per-row embedding quantization takes at a time
_EMBED_ROW_BLOCK = 16384


def _quant_rows(w: torch.Tensor, nbits: int) -> Params:
    """Per-row quantization of the [V, D] embedding (each row's scale is
    its own) in blocks of ``_EMBED_ROW_BLOCK`` rows: eager temporaries of
    the whole table would take about three times its f32 size."""
    parts = [_quant_channel_2d(w[i : i + _EMBED_ROW_BLOCK], -1, nbits)
             for i in range(0, w.shape[0], _EMBED_ROW_BLOCK)]
    return {name: torch.cat([part[name] for part in parts]) for name in parts[0]}


def _quant_channel_2d(w: torch.Tensor, axis: int, nbits: int) -> Params:
    """Symmetric per-channel quantization along ``axis`` (the max is taken
    over it): ``{"q": int8, "s": f32}``, or ``{"qp", "s"}`` at 4 bits."""
    qmax = (1 << (nbits - 1)) - 1
    w32 = w.float()
    s = w32.abs().amax(dim=axis, keepdim=True) / qmax
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w32 / s), -qmax, qmax).to(torch.int8)
    return {"qp": pack_int4(q), "s": s} if nbits == 4 else {"q": q, "s": s}


def _quant_grouped_2d(w: torch.Tensor, group_size: int) -> Params:
    """Sub-channel int4: one scale per (``group_size`` rows of the
    reduction dim, output column). ``{"qp": [D, F/2], "gs": [D/group, F]}``."""
    w32 = w.float()
    d, f = w32.shape
    wg = w32.reshape(d // group_size, group_size, f)
    s = wg.abs().amax(dim=-2, keepdim=True) / 7.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wg / s), -7, 7).to(torch.int8)
    return {"qp": pack_int4(q.reshape(d, f)), "gs": s[..., 0, :]}


def _quant_rank1_2d(w: torch.Tensor, group_size: int) -> Params:
    """Rank-1 sub-channel int4: ``scale[k, f] = rs[k] * s[f]``, fitted to the
    per-(group, column) max-abs matrix by 3 rounds of max-plus alternating
    minimization, after which no weight is clipped. ``{"qp": [D, F/2],
    "rs": [K, 1], "s": [1, F]}``."""
    w32 = w.float()
    d, f = w32.shape
    k = d // group_size
    wg = w32.reshape(k, group_size, f)
    m = torch.clamp(wg.abs().amax(dim=-2) / 7.0, min=1e-12)  # [K, F]
    rs = torch.ones((k, 1), dtype=torch.float32, device=w.device)
    for _ in range(3):
        s = (m / rs).amax(dim=-2, keepdim=True)  # [1, F]
        rs = (m / s).amax(dim=-1, keepdim=True)  # [K, 1]
    scale4 = rs[:, :, None] * s[None, :, :]  # [K, 1, F] >= m
    q = torch.clamp(torch.round(wg / scale4), -7, 7).to(torch.int8)
    return {"qp": pack_int4(q.reshape(d, f)), "rs": rs, "s": s}


def _group_size_for(dims, cap: int = 128) -> int:
    """Largest group <= ``cap`` dividing every one of ``dims``."""
    gcd = math.gcd(*dims)
    g = min(cap, gcd)
    while gcd % g:  # a divisor of the gcd divides every dim
        g -= 1
    return g


def _default_group_size(params: Params, cap: int = 128) -> int:
    """Largest group <= ``cap`` dividing every grouped reduction dim
    (d_model, n_heads * head_dim, d_ff, and an untied head's d_model)."""
    dims = [params["layers"][n].shape[-2] for n in ("wq", "wo", "w_down")]
    if "lm_head" in params:
        dims.append(params["lm_head"].shape[-2])
    return _group_size_for(dims, cap)


# the leaves quantize_lm_params quantizes: the embedding, an untied head and
# the seven matmul weight families
_QUANTIZED = ("embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _check_quant_args(bits: int, int4_scheme: str) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if int4_scheme not in ("grouped", "rank1"):
        raise ValueError(f"int4_scheme must be 'grouped' or 'rank1', got {int4_scheme!r}")


def _quant_leaf(name: str, w: torch.Tensor, bits: int, group_size: Optional[int],
                int4_scheme: str, embed_bits: int) -> Params:
    """One leaf of ``_QUANTIZED`` in its quantized form: the embedding per
    vocab row at ``embed_bits`` (``s`` [V, 1]); at 8 bits every other leaf
    per output channel (``s`` [.., 1, F]); at 4 bits the layer families and
    the head sub-channel int4 by ``int4_scheme``, one matrix at a time."""
    if name == "embed":
        return _quant_rows(w, embed_bits)
    if bits == 8:
        return _per_matrix(_quant_channel_2d, w, -2, 8)
    if w.shape[-2] % group_size:
        raise ValueError(f"group_size {group_size} must divide reduction dim {w.shape[-2]}")
    fn = _quant_rank1_2d if int4_scheme == "rank1" else _quant_grouped_2d
    return _per_matrix(fn, w, group_size)


def quantize_lm_params(
    params: Params,
    bits: int = 8,
    group_size: Optional[int] = None,
    embed_bits: Optional[int] = None,
    int4_scheme: str = "grouped",
) -> Params:
    """Symmetric quantization of the seven matmul weight families and the
    embedding, on the parameters' device, one weight matrix at a time.

    ``bits=8``: per-output-channel int8, ``{"q": int8, "s": f32 [.., 1, F]}``,
    so the forward computes ``(x @ q) * s``. The embedding is quantized per
    vocab row (``s`` [V, 1]), which serves both the lookup and the tied head
    (as a per-logit column scale). ``bits=4``: the layer families (and an
    untied head) become sub-channel int4, ``int4_scheme`` ``"grouped"`` (one
    scale per (group, column)) or ``"rank1"`` (the scale matrix factorized
    as ``rs[k] * s[f]``); the embedding stays per-row int8 unless
    ``embed_bits=4``. ``group_size=None`` picks the largest group <= 128
    that divides every grouped reduction dim of this tree."""
    _check_quant_args(bits, int4_scheme)
    embed_bits = 8 if embed_bits is None else embed_bits
    if bits == 8 and embed_bits != 8:
        raise ValueError("embed_bits only applies to bits=4")
    if embed_bits not in (8, 4):
        raise ValueError(f"embed_bits must be 8 or 4, got {embed_bits}")
    if group_size is None:
        group_size = _default_group_size(params)

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in _QUANTIZED:
        tree = out["layers"] if name in out["layers"] else out
        if name in tree:
            tree[name] = _quant_leaf(name, tree[name], bits, group_size, int4_scheme, embed_bits)
    return out


def _quant_acts(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations: [..., D] -> (int8 values, f32
    scales [..., 1]); the row max is taken in f32. With ``group`` the rows
    are split over its ranks along D (a row-split product under TP) and
    the max is all-reduced, so every rank quantizes with the unsharded
    row's scale."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = amax / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq @ q`` of int8 operands: ``torch._int_mm`` on the
    card (s8 x s8 -> s32 in cuBLASLt, which needs more than 16 rows, so
    fewer are padded with zero rows, and the right operand column-major,
    so ``q`` is copied transposed), an f64 product on the CPU (its sums of
    int8 products are exact)."""
    if xq.device.type == "cuda":
        m = xq.shape[0]
        if m <= 16:
            xq = torch.cat([xq, xq.new_zeros((17 - m, xq.shape[1]))])
        return torch._int_mm(xq, q.T.contiguous().T)[:m]
    return (xq.double() @ q.double()).to(torch.int32)


def _int4_kernel_scheme(w, rows: int, act8_rows: int) -> Optional[str]:
    """The ``matmul_int4`` scheme in which ``_mm`` multiplies ``rows``
    activation rows by ``w``, or None where it takes another route: not an
    int4 leaf, grouped above ``_INT4_DEQUANT_ROWS`` rows, rank-1 w4a8 from
    ``act8_rows`` rows."""
    if not isinstance(w, dict):
        return None
    if "gs" in w:
        return "grouped" if rows <= _INT4_DEQUANT_ROWS else None
    if "rs" in w:
        return None if act8_rows and rows >= act8_rows else "rank1"
    return None


def _w4a16(x2: torch.Tensor, w, scheme: str, dt: torch.dtype):
    """``matmul_int4`` of the ``[rows, D]`` activations and one int4 leaf
    or a list of them: rank-1 takes ``x2`` as it is (its group factor folds
    into it before the cast to ``dt``), grouped ``x2`` in ``dt``."""
    x4 = x2 if scheme == "rank1" else x2.to(dt)
    return matmul_int4(x4.contiguous(), w, dt=dt, scheme=scheme)


def _mm(x: torch.Tensor, w, dt: torch.dtype, act8_rows: int = 0,
        amax_group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``x @ w`` for plain and quantized weights (the branches of the JAX
    ``_mm``). ``act8_rows``: from that many activation rows (prefill) an
    int8 weight runs w8a8 and a rank-1 int4 weight w4a8, the activations
    quantized per row and both scales applied outside the exact int32
    product (on an unpacked copy of an int4 weight); below it (decode)
    int8 runs w8a16 on the ``matmul_int8`` kernel and rank-1 int4 w4a16 on
    ``matmul_int4``, its group factor folded into the activations. Grouped
    int4 runs ``matmul_int4`` up to ``_INT4_DEQUANT_ROWS`` rows and
    multiplies by a transient dequantized copy above. ``amax_group``: the
    TP group of a row-split product, whose w8a8 activation scale is the max
    over its ranks."""
    if not isinstance(w, dict):
        return x.to(dt) @ w.to(dt)
    lead, d = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, d)
    scheme = _int4_kernel_scheme(w, rows, act8_rows)
    if scheme:
        y = _w4a16(x2, w, scheme, dt)
        return y.reshape(*lead, y.shape[-1])
    if "gs" in w:  # grouped int4 past _INT4_DEQUANT_ROWS: qp [D, F/2], gs [K, F]
        gs = w["gs"]
        k, f = gs.shape
        qg = unpack_int4(w["qp"]).reshape(k, d // k, f)
        y = x2.to(dt) @ (qg.to(dt) * gs[:, None, :].to(dt)).reshape(d, f)
        return y.reshape(*lead, f)
    if "rs" in w:  # rank-1 int4 w4a8: the group factor folds into the activations
        rs, s = w["rs"], w["s"]
        k = rs.shape[0]
        xs32 = (x2.float().reshape(rows, k, d // k) * rs).reshape(rows, d)
        xq, xs = _quant_acts(xs32, amax_group)
        y = (_int8_product(xq, unpack_int4(w["qp"])).float() * xs * s.float()).to(dt)
        return y.reshape(*lead, s.shape[-1])
    q, s = w["q"], w["s"]  # per-channel int8
    if act8_rows and rows >= act8_rows:
        xq, xs = _quant_acts(x2, amax_group)
        y = (_int8_product(xq, q).float() * xs * s.float()).to(dt)
    else:
        y = matmul_int8(x2.to(dt).contiguous(), q, s, dt=dt)
    return y.reshape(*lead, q.shape[1])


def _mm_shared(x: torch.Tensor, ws, dt: torch.dtype, act8_rows: int = 0) -> list:
    """``[_mm(x, w, dt, act8_rows) for w in ws]`` for weights that share
    ``x`` (a layer's wq, wk and wv; its w_gate and w_up). Where ``_mm``
    would send each of them to ``matmul_int4`` in one scheme, one
    ``matmul_int4`` call takes them all (which launches them together on
    the card where its planner can), with the same values."""
    rows = math.prod(x.shape[:-1])
    schemes = {_int4_kernel_scheme(w, rows, act8_rows) for w in ws}
    if len(schemes) == 1 and None not in schemes:
        ys = _w4a16(x.reshape(rows, x.shape[-1]), list(ws), schemes.pop(), dt)
        return [y.reshape(*x.shape[:-1], y.shape[-1]) for y in ys]
    return [_mm(x, w, dt, act8_rows) for w in ws]


def _all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum over ``group``'s ranks of their partial ``x`` (in f32, as
    the residual stream), or ``x`` without a group."""
    if group is None:
        return x
    x = x.float().contiguous()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int = -1
                ) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim``, concatenated in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _attention(q, k, v, mask, return_probs: bool = False):
    b, t, h, hd = q.shape
    kv = k.shape[1]
    return attn_core(q.reshape(b, t, kv, h // kv, hd), k, v, mask, return_probs)


def _rank_kv_heads(x: Optional[torch.Tensor], kvh: int, tp: dist.ProcessGroup
                   ) -> Optional[torch.Tensor]:
    """This rank's kv heads of a cache layer [B, KV, S, ..] or of its
    scales [B, KV * rows, S] (int4: a row per group): the heads of the
    rank's query heads."""
    if x is None:
        return None
    share = kvh // dist.get_world_size(tp)
    rows = x.shape[1] // kvh
    return x.narrow(1, dist.get_rank(tp) * share * rows, share * rows)


def _block(
    lp: Params,  # this layer's params (leaves without the L axis)
    x: torch.Tensor,  # [B, T, D] f32 residual stream
    positions: torch.Tensor,
    mask: torch.Tensor,
    cfg: GemmaConfig,
    cache: Optional[Tuple],  # (kv_cache, layer, cursor) | None
    return_probs: bool = False,
    tp: Optional[dist.ProcessGroup] = None,
    *,
    smask: Tuple,  # ``mask`` as (qpos [B, T], kpos [B, S], valid [B, S] | None)
    delta: Optional[torch.Tensor] = None,  # the previous block's MLP output
):
    """One transformer block. Its residual input is ``x + delta`` (``x``
    without a delta): the previous block's last residual add is folded
    into this block's first norm. Returns (resid_in = x + delta in f32,
    resid_mid, mlp_out, the layer's attention probs [B, H, T, S] f32 if
    ``return_probs`` else None); the block's ``resid_post`` is ``resid_mid
    + mlp_out``, which the next block's first norm (or the final norm)
    adds. ``mlp_out`` is in the compute type (f32 under TP).

    With ``cache``, the new tokens' K/V are written into the layer's slice
    of the stacked cache at the slots ``cursor + [0, T)`` IN PLACE (the
    caller's cache tensors change), and attention reads all of the layer's
    slots under the mask.

    With ``tp``, ``lp`` holds this rank's slices: its query heads attend
    over their kv heads of the replicated cache, and ``wo`` and ``w_down``
    give partial sums that are all-reduced (the returned probs are the
    rank's heads)."""
    b, t, d = x.shape
    dt = cfg.compute_dtype
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    a8 = cfg.act_int8_rows
    eps, plus_one = cfg.norm_eps, cfg.norm_plus_one

    resid_in, attn_in = add_rms_norm(x, lp["attn_norm"], eps, plus_one, delta=delta, dt=dt)
    q, k, v = _mm_shared(attn_in, (lp["wq"], lp["wk"], lp["wv"]), dt, a8)
    q = q.reshape(b, t, -1, hd)  # h heads, h / tp under TP
    k, v = k.reshape(b, t, kvh, hd), v.reshape(b, t, kvh, hd)
    # k and v come back as the layer's cache [B, KV, S, hd] or, with no
    # cache, as contiguous [B, KV, T, hd]
    q, k, v, k_scale, v_scale = rope_qk_cache(q.contiguous(), k.contiguous(), v.contiguous(),
                                              positions.long(), cfg.rope_theta, cache=cache)

    if tp is not None and kvh > 1:  # the kv heads of this rank's query heads
        k, v, k_scale, v_scale = (_rank_kv_heads(a, kvh, tp) for a in (k, v, k_scale, v_scale))
    groups = q.shape[2] // k.shape[1]
    probs = None
    if not return_probs and cache is not None and kernel_takes(t, groups, hd):
        # a decode step or a verify round: the cache read in its stored type
        attn = decode_attention(q, k, v, mask, k_scale=k_scale, v_scale=v_scale, dt=dt)
    elif not return_probs and dt == torch.bfloat16 and prefill_kernel_takes(groups, hd):
        # prefill or the no-cache forward
        attn = prefill_attention(q, k, v, *smask, k_scale=k_scale, v_scale=v_scale, dt=dt)
    else:
        attn, probs = _attention(q, dequant_kv(k, k_scale, dt), dequant_kv(v, v_scale, dt), mask,
                                 return_probs)
    attn_out = _all_reduce(_mm(attn.to(dt), lp["wo"], dt, a8, tp), tp)
    resid_mid, x_in = add_rms_norm(resid_in, lp["mlp_norm"], eps, plus_one,
                                   delta=attn_out.contiguous(), dt=dt)
    gate, up = _mm_shared(x_in, (lp["w_gate"], lp["w_up"]), dt, a8)
    hidden = gated_act(gate.contiguous(), up.contiguous(), cfg.mlp_activation)
    mlp_out = _all_reduce(_mm(hidden, lp["w_down"], dt, a8, tp), tp)
    return resid_in, resid_mid, mlp_out.contiguous(), probs


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    cfg: GemmaConfig,
    *,
    capture: CaptureSpec = CaptureSpec(),
    kv_cache: Optional[Params] = None,  # init_kv_cache's dict
    positions: Optional[torch.Tensor] = None,  # [B, T] RoPE positions
    attn_valid: Optional[torch.Tensor] = None,  # no-cache: [B,T]; cache: [B,S] slot validity
    attn_probs_layer: Optional[int] = None,  # also return this layer's attention probs
    logits_last_only: bool = False,  # head only on the final position
    tp: Optional[dist.ProcessGroup] = None,  # tensor-parallel group (shard_lm_params' params)
):
    """LM forward. Returns (logits [B,T,V] f32, new_kv_cache | None,
    captures [n_sites, B, T, D] | None), and with ``attn_probs_layer`` (an
    index into the layers, negative from the last) a fourth value: that
    layer's f32 attention softmax [B, H, T, S].

    With ``kv_cache``, ``tokens`` are the T new tokens appended at buffer
    offset ``kv_cache['pos']`` (a 0-dim int64 tensor on the cache's device,
    never read on the host; the tokens are written in place into
    ``kv_cache``'s tensors) and attention spans all S slots of the cache
    under the mask ``key_pos <= buf_idx`` (causal within the new block),
    as the JAX forward masks them: the shapes do not depend on the cursor,
    so a step can be captured in a CUDA graph. For left-padded prompts,
    pass per-row RoPE ``positions`` and mark pad slots invalid in
    ``attn_valid`` — masking uses buffer indices, rotation uses
    ``positions``.

    ``tp``: the process group of a tensor-parallel run, ``params`` this
    rank's slices (``parallel/mesh.py::shard_lm_params``); every rank
    passes the same tokens and gets the same outputs (module docstring)."""
    b, t = tokens.shape
    dev = tokens.device
    emb = params["embed"]
    ids, inside = tokens, None
    if tp is not None:  # vocab-sharded: this rank looks up its own rows
        from probing_rag_tpu_torch.parallel.mesh import mqa_safe_tp  # imports this module

        if not mqa_safe_tp(cfg, dist.get_world_size(tp)):
            raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over tp "
                             f"{dist.get_world_size(tp)}")
        rows_here = (emb["s"] if isinstance(emb, dict) else emb).shape[0]
        local = tokens - dist.get_rank(tp) * rows_here
        inside = (local >= 0) & (local < rows_here)
        ids = local.clamp(0, rows_here - 1)
    if isinstance(emb, dict):  # quantized per row: dequantize the looked-up rows
        rows = emb["q"][ids] if "q" in emb else unpack_int4(emb["qp"][ids])
        x = rows.to(cfg.resid_dtype) * emb["s"][ids]
    else:
        x = emb[ids].to(cfg.resid_dtype)
    if tp is not None:
        x = _all_reduce(x * inside[..., None], tp).to(cfg.resid_dtype)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)

    if kv_cache is not None:
        base = torch.as_tensor(kv_cache["pos"], dtype=torch.int64, device=dev)
        n_slots = kv_cache["k"].shape[3]
        slots = base + torch.arange(t, dtype=torch.int64, device=dev)  # [T]
        buf_idx = slots[None, :]  # [1, T]
        if positions is None:
            positions = buf_idx.expand(b, t)
        key_pos = torch.arange(n_slots, dtype=torch.int64, device=dev)
        smask = (buf_idx.expand(b, t), key_pos[None, :].expand(b, n_slots), attn_valid)
    else:
        if positions is None:
            positions = torch.arange(t, dtype=torch.int64, device=dev)[None, :].expand(b, t)
        smask = (positions, positions, attn_valid)  # causal in the positions
    mask = structured_mask(*smask)  # [B, 1, T, S], for decode_attention and the plain ops

    want: Dict[Tuple[int, str], list] = {}
    for i, (layer, site) in enumerate(capture.sites):
        want.setdefault((layer, site), []).append(i)
    caps = [None] * capture.n_sites
    probs_layer = None if attn_probs_layer is None else attn_probs_layer % cfg.n_layers
    attn_probs = None
    lp_all = params["layers"]
    delta = None  # the last block's MLP output, added by the next norm
    for layer in range(cfg.n_layers):
        lp = {name: ({k: v[layer] for k, v in w.items()} if isinstance(w, dict) else w[layer])
              for name, w in lp_all.items()}
        cache = None
        if kv_cache is not None:
            cache = (kv_cache, layer, base)
        resid_in, resid_mid, delta, probs = _block(lp, x, positions, mask, cfg, cache,
                                                   return_probs=layer == probs_layer, tp=tp,
                                                   smask=smask, delta=delta)
        if probs is not None:
            attn_probs = _all_gather(probs, tp, dim=1)
        for i in want.get((layer - 1, "resid_post"), ()):
            caps[i] = resid_in
        for i in want.get((layer, "resid_mid"), ()):
            caps[i] = resid_mid
        x = resid_mid

    last_post = want.get((cfg.n_layers - 1, "resid_post"), ())
    if logits_last_only and not last_post:
        # prefill only reads logits[:, -1]: norming and slicing only the last
        # position avoids the [B, T, vocab] logits tensor
        x, delta = x[:, -1:].contiguous(), delta[:, -1:].contiguous()
    resid_post, x = add_rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one,
                                 delta=delta, dt=cfg.compute_dtype)
    for i in last_post:
        caps[i] = resid_post
    if logits_last_only:
        x = x[:, -1:]
    dt = cfg.compute_dtype
    if not cfg.tied_head:
        logits = _mm(x.to(dt), params["lm_head"], dt, cfg.act_int8_rows)
    elif isinstance(emb, dict):
        # the per-row embedding scale is the head's per-logit column scale
        x2 = x.to(dt).reshape(-1, cfg.d_model).contiguous()
        if "q" in emb:
            logits = matmul_int8(x2, emb["q"], emb["s"], dt=dt, transpose_rhs=True)
        else:
            logits = matmul_int4(x2, emb, dt=dt, scheme="channel", transpose_rhs=True)
        logits = logits.reshape(*x.shape[:-1], emb["s"].shape[0])
    else:
        logits = x.to(dt) @ emb.to(dt).T
    logits = _all_gather(logits.float(), tp)  # vocab shards under TP

    new_cache = None
    if kv_cache is not None:
        new_cache = dict(kv_cache, pos=base + t)
    captures = torch.stack(caps) if caps else None
    if attn_probs_layer is not None:
        return logits, new_cache, captures, attn_probs
    return logits, new_cache, captures


def init_kv_cache(
    cfg: GemmaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
) -> Params:
    """KV cache in the JAX layout [L, B, KV, S, hd], zero-filled.

    ``dtype=torch.int8``: values quantized per (token, kv-head), with f32
    scales ``k_scale``/``v_scale`` [L, B, KV, S]. ``dtype="int4"``: one
    scale per (token, kv-head, ``kv4_group`` lanes of the head dim),
    stored [L, B, KV*G, S] (the JAX merged layout), and the values
    nibble-packed as uint8 [L, B, KV, S, hd/2] (``pack_int4``): a quarter
    of a bf16 cache."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    vshape, sshape, vdt = shape, shape[:-1], dtype
    if dtype == "int4":
        g = cfg.head_dim // kv4_group(cfg.head_dim)
        vshape, vdt = (*shape[:-1], cfg.head_dim // 2), torch.uint8
        sshape = (cfg.n_layers, batch, cfg.n_kv_heads * g, max_len)
    cache = {
        "k": torch.zeros(vshape, dtype=vdt, device=device),
        "v": torch.zeros(vshape, dtype=vdt, device=device),
        "pos": torch.zeros((), dtype=torch.int64, device=device),
    }
    if dtype in (torch.int8, "int4"):
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return cache
