"""Contriever (``facebook/contriever-msmarco``, BERT-base) in plain float32
PyTorch, from BERT's published equations: the sum of token, position and
token-type-0 embeddings, LayerNorm; per layer multi-head self-attention over
the sequence's own tokens (padding masked out), the output projection, the
residual add and LayerNorm (post-LN), the MLP with the exact (erf) GELU, the
residual add and LayerNorm; Contriever's mean over the tokens. LayerNorm uses
the population variance."""

from __future__ import annotations

import math
from typing import Dict

import torch


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.float() + b.float()


def forward(w: Dict, c: Dict, ids: torch.Tensor, mask: torch.Tensor, linear=None) -> torch.Tensor:
    """``ids``, ``mask`` [B, T]. Returns the mean-pooled embeddings [B, D].
    ``linear(x, w)`` computes each product (``x @ w`` in float32 unless
    given: the control passes a lower-precision one)."""
    linear = linear or (lambda x, m: x @ m.float())
    d, h, eps = c["hidden_size"], c["num_attention_heads"], c["layer_norm_eps"]
    hd = d // h
    b, t = ids.shape
    x = (w["tok_embed"][ids].float() + w["pos_embed"][:t].float()[None]
         + w["type_embed"][0].float()[None, None])
    x = _ln(x, w["embed_ln"]["w"], w["embed_ln"]["b"], eps)
    keymask = mask[:, None, None, :]
    lw = w["layers"]
    for l in range(c["num_hidden_layers"]):
        q = (linear(x, lw["wq"][l]) + lw["bq"][l].float()).view(b, t, h, hd).transpose(1, 2)
        k = (linear(x, lw["wk"][l]) + lw["bk"][l].float()).view(b, t, h, hd).transpose(1, 2)
        v = (linear(x, lw["wv"][l]) + lw["bv"][l].float()).view(b, t, h, hd).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~keymask, float("-inf")), dim=-1)
        o = (p @ v).transpose(1, 2).reshape(b, t, d)
        x = _ln(x + linear(o, lw["wo"][l]) + lw["bo"][l].float(),
                lw["attn_ln"]["w"][l], lw["attn_ln"]["b"][l], eps)
        f = torch.nn.functional.gelu(linear(x, lw["w1"][l]) + lw["b1"][l].float())
        x = _ln(x + linear(f, lw["w2"][l]) + lw["b2"][l].float(),
                lw["mlp_ln"]["w"][l], lw["mlp_ln"]["b"][l], eps)
    m = mask.float()[:, :, None]
    return (x * m).sum(1) / m.sum(1).clamp(min=1.0)
