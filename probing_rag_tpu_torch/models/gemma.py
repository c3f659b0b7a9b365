"""Gemma-architecture LM in PyTorch with functional activation capture.

Port of the bf16/f32 path of ``probing_rag_tpu/models/gemma.py``: the
forward returns the residual-stream activations at the requested
(layer, site) pairs as part of its output, in place of the reference's
transformer_lens hooks.

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
and norms stay f32. Attention is written as the JAX package writes it, in
plain ops: f32 scores, ``-1e30`` masking, softmax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def init_params(
    cfg: GemmaConfig,
    generator: torch.Generator,
    device="cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with the JAX ``init_params`` distribution: dense
    weights N(0, 1) / sqrt(fan_in), norm weights at identity. Each leaf is
    drawn in f32 on ``device`` from ``generator`` and cast to ``dtype``."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers

    def norm_init(*shape):
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return fill(shape, dtype=dtype, device=device)

    def dense_init(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.div_(math.sqrt(shape[-2])).to(dtype)

    params: Params = {
        "embed": dense_init(cfg.vocab_size, d),
        "final_norm": norm_init(d),
        "layers": {
            "attn_norm": norm_init(L, d),
            "wq": dense_init(L, d, h * hd),
            "wk": dense_init(L, d, kv * hd),
            "wv": dense_init(L, d, kv * hd),
            "wo": dense_init(L, h * hd, d),
            "mlp_norm": norm_init(L, d),
            "w_gate": dense_init(L, d, f),
            "w_up": dense_init(L, d, f),
            "w_down": dense_init(L, f, d),
        },
    }
    if not cfg.tied_head:
        params["lm_head"] = dense_init(d, cfg.vocab_size)
    return params


# ----------------------------------------------------------------- modules


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = True
) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w32 = weight.float()
    return (normed * ((1.0 + w32) if plus_one else w32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half. x: [B, T, n, head_dim], positions: [B, T]."""
    hd = x.shape[-1]
    exponent = -torch.arange(0, hd // 2, dtype=torch.float32, device=x.device) / (hd // 2)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions[..., None].float() * freqs  # [B, T, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) @ w.to(dt)


def _attn_core(
    q: torch.Tensor,  # [B, T, KV, G, hd]
    k: torch.Tensor,  # [B, KV, S, hd]
    v: torch.Tensor,  # [B, KV, S, hd]
    mask: torch.Tensor,  # [B, 1, T, S] bool (True = attend)
) -> torch.Tensor:
    """f32 scores, -1e30 masking, softmax, f32-accumulated value sum (the
    JAX einsums with ``preferred_element_type=f32``). Returns [B, T, H*hd]
    f32."""
    b, t, kv, groups, hd = q.shape
    scores = torch.einsum("btkgh,bksh->bkgts", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, torch.tensor(-1e30, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksh->btkgh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, t, kv * groups * hd)


def _attention(q, k, v, mask) -> torch.Tensor:
    b, t, h, hd = q.shape
    kv = k.shape[1]
    return _attn_core(q.reshape(b, t, kv, h // kv, hd), k, v, mask)


def _block(
    lp: Params,  # this layer's params (leaves without the L axis)
    x: torch.Tensor,  # [B, T, D] f32 residual stream
    positions: torch.Tensor,
    mask: torch.Tensor,
    cfg: GemmaConfig,
    cache: Optional[Tuple],  # (ck [L,B,KV,S,hd], cv, layer, pos, n_keys) | None
):
    """One transformer block. Returns (resid_mid, resid_post).

    With ``cache``, the new tokens' K/V are written into the layer's slice
    of the stacked cache IN PLACE (the caller's cache tensors change), and
    attention reads the cache's first ``n_keys`` slots."""
    b, t, d = x.shape
    dt = cfg.compute_dtype
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    attn_in = rms_norm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_plus_one).to(dt)
    q = _mm(attn_in, lp["wq"], dt).reshape(b, t, h, hd)
    k = _mm(attn_in, lp["wk"], dt).reshape(b, t, kvh, hd)
    v = _mm(attn_in, lp["wv"], dt).reshape(b, t, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)  # [B, KV, T, hd]
    v = v.transpose(1, 2)
    if cache is not None:
        ck, cv, layer, pos, n_keys = cache
        ck[layer, :, :, pos : pos + t] = k.to(ck.dtype)
        cv[layer, :, :, pos : pos + t] = v.to(cv.dtype)
        k = ck[layer, :, :, :n_keys]
        v = cv[layer, :, :, :n_keys]

    attn = _attention(q, k.to(dt), v.to(dt), mask)
    attn_out = _mm(attn.to(dt), lp["wo"], dt).to(cfg.resid_dtype)
    resid_mid = x + attn_out

    x_in = rms_norm(resid_mid, lp["mlp_norm"], cfg.norm_eps, cfg.norm_plus_one).to(dt)
    gate = _mm(x_in, lp["w_gate"], dt)
    gate = F.gelu(gate, approximate="tanh") if cfg.mlp_activation == "gelu" else F.silu(gate)
    up = _mm(x_in, lp["w_up"], dt)
    mlp_out = _mm(gate * up, lp["w_down"], dt).to(cfg.resid_dtype)
    return resid_mid, resid_mid + mlp_out


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    cfg: GemmaConfig,
    *,
    capture: CaptureSpec = CaptureSpec(),
    kv_cache: Optional[Params] = None,  # {"k": [L,B,KV,S,hd], "v": ..., "pos": int}
    positions: Optional[torch.Tensor] = None,  # [B, T] RoPE positions
    attn_valid: Optional[torch.Tensor] = None,  # no-cache: [B,T]; cache: [B,S] slot validity
    logits_last_only: bool = False,  # head only on the final position
):
    """LM forward. Returns (logits [B,T,V] f32, new_kv_cache | None,
    captures [n_sites, B, T, D] | None).

    With ``kv_cache``, ``tokens`` are the T new tokens appended at buffer
    offset ``kv_cache['pos']`` (written in place into ``kv_cache``'s
    tensors) and attention spans the cache prefix plus the new tokens
    (causal within the new block). For left-padded prompts, pass per-row
    RoPE ``positions`` and mark pad slots invalid in ``attn_valid`` —
    masking uses buffer indices, rotation uses ``positions``. Keys past the
    new tokens are masked in the JAX forward; here they are not read, which
    gives the same softmax for every query row with a valid key. A row with
    none (a pad slot) averages over a different key count; nothing reads
    those rows."""
    b, t = tokens.shape
    dev = tokens.device
    emb = params["embed"]
    x = emb[tokens].to(cfg.resid_dtype)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)

    if kv_cache is not None:
        base = int(kv_cache["pos"])
        n_keys = base + t
        buf_idx = base + torch.arange(t, dtype=torch.int64, device=dev)[None, :]  # [1, T]
        if positions is None:
            positions = buf_idx.expand(b, t)
        key_pos = torch.arange(n_keys, dtype=torch.int64, device=dev)
        mask = (key_pos[None, None, :] <= buf_idx[:, :, None]).expand(b, t, n_keys)
        if attn_valid is not None:
            mask = mask & attn_valid[:, None, :n_keys]
    else:
        if positions is None:
            positions = torch.arange(t, dtype=torch.int64, device=dev)[None, :].expand(b, t)
        mask = positions[:, :, None] >= positions[:, None, :]  # causal
        if attn_valid is not None:
            mask = mask & attn_valid[:, None, :]
    mask = mask[:, None]  # [B, 1, T, S]

    want: Dict[int, list] = {}
    for i, (layer, site) in enumerate(capture.sites):
        want.setdefault(layer, []).append((i, site))
    caps = [None] * capture.n_sites
    lp_all = params["layers"]
    for layer in range(cfg.n_layers):
        lp = {name: w[layer] for name, w in lp_all.items()}
        cache = None
        if kv_cache is not None:
            cache = (kv_cache["k"], kv_cache["v"], layer, base, n_keys)
        resid_mid, resid_post = _block(lp, x, positions, mask, cfg, cache)
        for i, site in want.get(layer, ()):
            caps[i] = resid_mid if site == "resid_mid" else resid_post
        x = resid_post

    if logits_last_only:
        # prefill only reads logits[:, -1]: slicing before the head avoids
        # the [B, T, vocab] logits tensor
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    dt = cfg.compute_dtype
    if cfg.tied_head:
        logits = x.to(dt) @ emb.to(dt).T
    else:
        logits = _mm(x, params["lm_head"], dt)
    logits = logits.float()

    new_cache = None
    if kv_cache is not None:
        new_cache = {"k": kv_cache["k"], "v": kv_cache["v"], "pos": base + t}
    captures = torch.stack(caps) if caps else None
    return logits, new_cache, captures


def init_kv_cache(
    cfg: GemmaConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> Params:
    """KV cache in the JAX layout [L, B, KV, S, hd], zero-filled."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }
