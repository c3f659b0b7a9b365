"""Dense-retrieval text encoder (Contriever/BERT architecture) in PyTorch.

Port of ``probing_rag_tpu/models/encoder.py``: a BERT-base post-LN encoder
with mean pooling over the attention mask, Contriever's published pooling
(``facebook/contriever-msmarco``). LayerNorm uses the population variance,
GELU is exact, padded keys are masked with -1e30. The residual stream and
the norms are f32; the projections run in ``compute_dtype``; attention
scores are f32 sums of ``compute_dtype`` products, as the JAX einsums with
``preferred_element_type=f32`` compute them.

Layouts are the JAX package's (linear weights ``[in, out]``, layer leaves
stacked ``[L, ...]``), so ``weights.encoder_params_from_jax`` is a copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30_522  # bert-base-uncased
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_positions: int = 512
    n_token_types: int = 2
    norm_eps: float = 1e-12
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def contriever(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        return cls(vocab_size=256, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_positions=64)


def init_encoder_params(
    cfg: EncoderConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with the JAX ``init_encoder_params`` distribution:
    dense weights N(0, 0.02^2), zero biases, LayerNorms at identity. Each
    weight is drawn in f32 on ``device`` from ``generator`` and cast to
    ``dtype``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ln(*shape):
        return {"w": torch.ones(shape, dtype=dtype, device=device), "b": zeros(*shape)}

    return {
        "tok_embed": dense(cfg.vocab_size, d),
        "pos_embed": dense(cfg.max_positions, d),
        "type_embed": dense(cfg.n_token_types, d),
        "embed_ln": ln(d),
        "layers": {
            "wq": dense(L, d, d), "bq": zeros(L, d),
            "wk": dense(L, d, d), "bk": zeros(L, d),
            "wv": dense(L, d, d), "bv": zeros(L, d),
            "wo": dense(L, d, d), "bo": zeros(L, d),
            "attn_ln": ln(L, d),
            "w1": dense(L, d, f), "b1": zeros(L, f),
            "w2": dense(L, f, d), "b2": zeros(L, d),
            "mlp_ln": ln(L, d),
        },
    }


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)  # jnp.var: population variance
    return (x - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def encoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,  # [B, T] bool
    cfg: EncoderConfig,
) -> torch.Tensor:
    """Returns mean-pooled sentence embeddings [B, D] (f32)."""
    b, t = tokens.shape
    dt = cfg.compute_dtype
    x = (
        params["tok_embed"][tokens].float()
        + params["pos_embed"][:t].float()[None]
        + params["type_embed"][0].float()[None, None]
    )
    x = _ln(x, params["embed_ln"]["w"], params["embed_ln"]["b"], cfg.norm_eps)

    attn_mask = mask[:, None, None, :].float()  # [B, 1, 1, T]
    lp = params["layers"]
    hd = cfg.d_model // cfg.n_heads

    def proj(h, w, bias, l):
        return h @ lp[w][l].to(dt) + lp[bias][l].to(dt)

    for l in range(cfg.n_layers):
        xin = x.to(dt)
        q = proj(xin, "wq", "bq", l).reshape(b, t, cfg.n_heads, hd)
        k = proj(xin, "wk", "bk", l).reshape(b, t, cfg.n_heads, hd)
        v = proj(xin, "wv", "bv", l).reshape(b, t, cfg.n_heads, hd)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        scores = scores / math.sqrt(hd) + (1.0 - attn_mask) * -1e30
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
        attn = proj(attn.reshape(b, t, cfg.d_model).to(dt), "wo", "bo", l)
        x = _ln(x + attn.float(), lp["attn_ln"]["w"][l], lp["attn_ln"]["b"][l], cfg.norm_eps)
        xin = x.to(dt)
        h = F.gelu(proj(xin, "w1", "b1", l), approximate="none")
        h = proj(h, "w2", "b2", l)
        x = _ln(x + h.float(), lp["mlp_ln"]["w"][l], lp["mlp_ln"]["b"][l], cfg.norm_eps)

    m = mask.float()[:, :, None]
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def text_encoder(
    params: Params, cfg: EncoderConfig, tokenizer, device="cuda"
) -> Callable[[Sequence[str]], np.ndarray]:
    """``texts -> [B, D] f32`` numpy embeddings, as the JAX CLI's
    ``_dense_encoder`` closure: token ids cut to ``max_positions`` and
    clamped to ``vocab_size - 1``, right-padded to the batch's longest."""

    def encode(texts: Sequence[str]) -> np.ndarray:
        ids = [tokenizer.encode(t)[: cfg.max_positions] for t in texts]
        ml = max(max((len(i) for i in ids), default=1), 1)
        arr = np.zeros((len(ids), ml), np.int64)
        msk = np.zeros((len(ids), ml), bool)
        for i, row in enumerate(ids):
            arr[i, : len(row)] = np.minimum(row, cfg.vocab_size - 1)
            msk[i, : len(row)] = True
        with torch.no_grad():
            out = encoder_forward(
                params, torch.from_numpy(arr).to(device), torch.from_numpy(msk).to(device), cfg
            )
        return out.cpu().numpy()

    return encode
