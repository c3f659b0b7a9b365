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
:func:`prepare_params` makes the tree the forward reads: the concatenated
``wq | wk | wv`` and the other products' weights and biases in
``compute_dtype``, the norms' in f32 (:func:`text_encoder` does it once,
when it is made; :func:`encoder_forward` on a tree it has not prepared).

One layer loop, on four functions a layer: one product of the
concatenated weight and ``qkv_heads``, ``prefill_attention`` under the
key-padding mask with its output stored in ``compute_dtype``, and
``add_layer_norm`` and ``bias_gelu`` around the other products
(``ops/encoder.py``). bf16 compute where the kernels take the config
(``ops/encoder.py::kernels_take``: Contriever) calls the wrappers: on CUDA
tensors each launches its kernel or raises, on CPU tensors each takes its
plain version. f32 compute (the checking mode) and configs the kernels do
not take (the tiny test config, head dim 16) call the plain versions, in
``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.ops.attention import prefill_attention, prefill_attention_plain
from probing_rag_tpu_torch.ops.encoder import (add_layer_norm, add_layer_norm_plain, bias_gelu,
                                               bias_gelu_plain, kernels_take, qkv_heads,
                                               qkv_heads_plain)
from probing_rag_tpu_torch.utils.profiling import RECORDER

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


_PRODUCTS = ("wqkv", "wo", "w1", "w2", "bq", "bk", "bv", "bo", "b1", "b2")


def prepare_params(params: Params, cfg: EncoderConfig) -> Params:
    """The tree :func:`encoder_forward` reads: ``layers["wqkv"]`` ``[L, D,
    3 D]``, the concatenated ``wq | wk | wv`` (in place of the three), the
    products' weights and biases in ``cfg.compute_dtype``, the norms' ``w``
    and ``b`` in f32, the embeddings as they are. A prepared tree comes back
    with its own tensors (no copy)."""
    dt = cfg.compute_dtype
    lp = dict(params["layers"])
    if "wqkv" not in lp:
        lp["wqkv"] = torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=-1)
    lp.update({n: lp[n].to(dt) for n in _PRODUCTS})
    lp.update({n: {k: v.float() for k, v in lp[n].items()} for n in ("attn_ln", "mlp_ln")})
    embed_ln = {k: v.float() for k, v in params["embed_ln"].items()}
    return {**params, "embed_ln": embed_ln, "layers": lp}


def encoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,  # [B, T] bool
    cfg: EncoderConfig,
) -> torch.Tensor:
    """Returns mean-pooled sentence embeddings [B, D] (f32)."""
    p = prepare_params(params, cfg)
    b, t = tokens.shape
    dt, eps, h = cfg.compute_dtype, cfg.norm_eps, cfg.n_heads
    if dt == torch.bfloat16 and kernels_take(cfg.d_model, h, cfg.d_ff):
        norm, gelu, heads, attend = add_layer_norm, bias_gelu, qkv_heads, prefill_attention
    else:
        norm, gelu = partial(add_layer_norm_plain, dt=dt), bias_gelu_plain
        heads, attend = qkv_heads_plain, prefill_attention_plain
    x = (
        p["tok_embed"][tokens].float()
        + p["pos_embed"][:t].float()[None]
        + p["type_embed"][0].float()[None, None]
    )
    lp = p["layers"]
    x, xin = norm(x, None, None, p["embed_ln"]["w"], p["embed_ln"]["b"], eps)
    # every key at position 0 and every query too: the mask is the padding alone
    pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    for l in range(cfg.n_layers):
        q, k, v = heads(xin @ lp["wqkv"][l], lp["bq"][l], lp["bk"][l], lp["bv"][l], h)
        a = attend(q, k, v, pos, pos, mask, dt=dt, out_dtype=dt)
        x, xin = norm(x, a @ lp["wo"][l], lp["bo"][l], lp["attn_ln"]["w"][l],
                      lp["attn_ln"]["b"][l], eps)
        hid = gelu(xin @ lp["w1"][l], lp["b1"][l])
        x, xin = norm(x, hid @ lp["w2"][l], lp["b2"][l], lp["mlp_ln"]["w"][l],
                      lp["mlp_ln"]["b"][l], eps)
    m = mask.float()[:, :, None]
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def text_encoder(
    params: Params, cfg: EncoderConfig, tokenizer, device="cuda"
) -> Callable[..., np.ndarray]:
    """``encode(texts, batch_size=None) -> [len(texts), D] f32`` numpy
    embeddings in the order of ``texts``, as the JAX CLI's ``_dense_encoder``
    closure: token ids cut to ``max_positions`` and clamped to
    ``vocab_size - 1``, each batch right-padded to its longest. The tree the
    forward reads is made here, once (:func:`prepare_params`): the caller may
    drop ``params``.

    ``encode`` tokenizes its texts once, orders them by token count, longest
    first (a window too large for the card fails at its first batch) and
    equal counts in their order, runs a forward on each slice of
    ``batch_size`` (all of them with ``batch_size`` None: one forward for a
    query batch) in that order, and writes each embedding back at its
    text's place: few padded slots, and the reference's own behaviour
    (``SentenceTransformer.encode`` sorts its input by length and restores
    the order). A row's embedding does not depend on the other rows of its
    batch, but for the order in which the products sum.

    A call is an ``encoder.batch`` span (its ``rows``) over one
    ``encoder.tokenize`` and, a forward each, ``encoder.pad``,
    ``encoder.copy_in``, ``encoder.forward`` (timed on the card too, with
    the batch's ``slots``, rows x longest, and its ``valid`` tokens) and
    ``encoder.readback``; the ordering and the write back are the
    ``encoder.batch`` span's own time."""
    params = prepare_params(params, cfg)
    device = torch.device(device)

    def forward(ids) -> np.ndarray:
        with RECORDER.span("encoder.pad"):
            ml = max(max((len(i) for i in ids), default=1), 1)
            arr = np.zeros((len(ids), ml), np.int64)
            msk = np.zeros((len(ids), ml), bool)
            for i, row in enumerate(ids):
                arr[i, : len(row)] = np.minimum(row, cfg.vocab_size - 1)
                msk[i, : len(row)] = True
        with RECORDER.span("encoder.copy_in"):
            tokens, mask = torch.from_numpy(arr).to(device), torch.from_numpy(msk).to(device)
        with RECORDER.span("encoder.forward", device=device, slots=arr.size,
                           valid=sum(len(i) for i in ids)), torch.no_grad():
            out = encoder_forward(params, tokens, mask, cfg)
        with RECORDER.span("encoder.readback"):
            return out.cpu().numpy()

    def encode(texts: Sequence[str], batch_size: Optional[int] = None) -> np.ndarray:
        with RECORDER.span("encoder.batch", rows=len(texts)):
            with RECORDER.span("encoder.tokenize"):
                ids = [tokenizer.encode(t)[: cfg.max_positions] for t in texts]
            bs = batch_size or max(len(ids), 1)
            order = np.argsort([-len(i) for i in ids], kind="stable")
            ids = [ids[r] for r in order.tolist()]
            out = np.empty((len(ids), cfg.d_model), np.float32)
            for start in range(0, len(ids), bs):
                out[order[start : start + bs]] = forward(ids[start : start + bs])
            return out

    return encode
