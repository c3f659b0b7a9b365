"""A Mistral-architecture decoder in plain float32 PyTorch, one sequence and
one layer at a time, from the published equations (Mistral-7B's
``config.json`` and the Llama/Mistral modelling code): token embedding
without scaling; per layer RMSNorm (``x / sqrt(mean(x^2) + eps) * w``),
grouped-query attention with rotary embeddings (``rotate_half``, inverse
frequencies ``theta^(-2i/hd)``) under a causal mask, softmax in float32,
the residual add, RMSNorm, the SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wd`` and
the residual add; a final RMSNorm and an untied head. The sliding window
(4,096) is left out: no sequence here reaches it. Each layer's weights are
widened to float32 as the layer runs, so the peak is one layer's float32
copy beside the bfloat16 tree.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def forward(w: Dict, c: Dict, ids: torch.Tensor, head_at: Sequence[int],
            keep_layers: Sequence[int] = ()) -> tuple:
    """``ids`` [T] of one unpadded sequence. Returns (logits [P, V] at the
    positions ``head_at``, {layer: residual stream after that layer [T, D]}
    for ``keep_layers``), all float32."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    kv, hd = c["num_key_value_heads"], c["hidden_size"] // c["num_attention_heads"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    dev = ids.device
    t = ids.shape[0]
    x = w["embed"][ids].float()
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd)
    ang = torch.arange(t, dtype=torch.float64, device=dev)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    lw = w["layers"]
    kept = {}
    for l in range(c["num_hidden_layers"]):
        a = _rms(x, lw["attn_norm"][l], eps)
        q = (a @ lw["wq"][l].float()).view(t, h, hd)
        k = (a @ lw["wk"][l].float()).view(t, kv, hd)
        v = (a @ lw["wv"][l].float()).view(t, kv, hd)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hts,shd->thd", p, v).reshape(t, h * hd)
        del s, p
        x = x + o @ lw["wo"][l].float()
        m = _rms(x, lw["mlp_norm"][l], eps)
        g = torch.nn.functional.silu(m @ lw["w_gate"][l].float()) * (m @ lw["w_up"][l].float())
        x = x + g @ lw["w_down"][l].float()
        if l in keep_layers:
            kept[l] = x.clone()
    hidden = _rms(x[list(head_at)], w["final_norm"], eps)
    return hidden @ w["lm_head"].float(), kept
