"""Conversion of the JAX package's parameters into the port's.

The port keeps the JAX layouts (linear weights ``[in, out]``, layer leaves
stacked ``[L, ...]``), so conversion is a copy: each numpy (or CPU torch)
leaf becomes a tensor on ``device``. Shapes are checked against the config.
Quantized LM trees (``quantize_lm_params``) keep their int8 and uint8
leaves and f32 scales as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from probing_rag_tpu_torch.models.encoder import EncoderConfig
from probing_rag_tpu_torch.models.gemma import GemmaConfig


def _tensor(x, device, dtype) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


# the leaves of each quantized form (gemma.quantize_lm_params), with their dtypes
_QUANT_FORMS = (
    {"q": torch.int8, "s": torch.float32},  # per-channel int8
    {"qp": torch.uint8, "s": torch.float32},  # per-row int4 (embed_bits=4)
    {"qp": torch.uint8, "gs": torch.float32},  # grouped int4
    {"qp": torch.uint8, "rs": torch.float32, "s": torch.float32},  # rank-1 int4
)


def _quantized(leaf: Dict[str, Any], shape, name: str, device) -> Dict[str, torch.Tensor]:
    """A quantized leaf of the dense weight ``shape`` ([.., D, F]; the
    embedding [V, D] is quantized per row): dtypes and shapes checked,
    tensors moved to ``device`` unchanged."""
    form = next((f for f in _QUANT_FORMS if set(f) == set(leaf)), None)
    if form is None:
        raise ValueError(f"{name}: quantized leaves {sorted(leaf)} are not a quantize_lm_params form")
    out = {}
    for key, want in form.items():
        t = leaf[key] if isinstance(leaf[key], torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf[key]))
        if t.dtype != want:
            raise ValueError(f"{name}/{key}: dtype {t.dtype} != {want}")
        out[key] = t.to(device)
    *lead, d, f = shape
    groups = out.get("gs", out.get("rs"))
    k = groups.shape[-2] if groups is not None else 1
    if d % k:
        raise ValueError(f"{name}: {k} groups do not divide the reduction dim {d}")
    want_shapes = {
        "q": tuple(shape), "qp": (*lead, d, f // 2), "gs": (*lead, k, f), "rs": (*lead, k, 1),
        "s": (d, 1) if name == "embed" else (*lead, 1, f),
    }
    for key, t in out.items():
        if tuple(t.shape) != want_shapes[key]:
            raise ValueError(f"{name}/{key}: shape {tuple(t.shape)} != {want_shapes[key]}")
    return out


def lm_params_from_jax(tree: Dict[str, Any], cfg: GemmaConfig, device="cuda",
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """LM params (``models/gemma.py::init_params`` / ``hf_loader`` tree, or
    a ``quantize_lm_params`` tree, as numpy arrays) -> the port's dict of
    tensors on ``device``: float leaves in ``dtype``, quantized leaves
    (dicts) as they are."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers
    want = {
        "attn_norm": (L, d), "wq": (L, d, h * hd), "wk": (L, d, kv * hd),
        "wv": (L, d, kv * hd), "wo": (L, h * hd, d), "mlp_norm": (L, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
    }
    layers = tree["layers"]
    if set(layers) != set(want):
        raise ValueError(f"layer leaves {sorted(layers)} != {sorted(want)}")
    def convert(leaf, shape, name):
        if isinstance(leaf, dict):
            return _quantized(leaf, shape, name, device)
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(leaf.shape)} != {shape}")
        return _tensor(leaf, device, dtype)

    out: Dict[str, Any] = {"layers": {n: convert(layers[n], s, f"layers/{n}")
                                          for n, s in want.items()}}
    top = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tied_head:
        top["lm_head"] = (d, cfg.vocab_size)
    for name, shape in top.items():
        out[name] = convert(tree[name], shape, name)
    return out


def encoder_params_from_jax(tree: Dict[str, Any], cfg: EncoderConfig, device="cuda",
                            dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Encoder params (``models/encoder.py::init_encoder_params`` tree, as
    numpy arrays) -> the port's dict of tensors on ``device`` in ``dtype``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    ln, ln_l = {"w": (d,), "b": (d,)}, {"w": (L, d), "b": (L, d)}
    want = {
        "tok_embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_positions, d),
        "type_embed": (cfg.n_token_types, d), "embed_ln": ln,
        "layers": {
            "wq": (L, d, d), "bq": (L, d), "wk": (L, d, d), "bk": (L, d),
            "wv": (L, d, d), "bv": (L, d), "wo": (L, d, d), "bo": (L, d),
            "attn_ln": ln_l, "w1": (L, d, f), "b1": (L, f), "w2": (L, f, d),
            "b2": (L, d), "mlp_ln": ln_l,
        },
    }

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: leaves {got} != {sorted(spec)}")
            return {k: convert(node[k], s, f"{path}/{k}" if path else k) for k, s in spec.items()}
        if tuple(node.shape) != spec:
            raise ValueError(f"{path}: shape {tuple(node.shape)} != {spec}")
        return _tensor(node, device, dtype)

    return convert(tree, want, "")


def probers_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Stacked prober params (``prober/train.py::init_prober_stack`` tree or
    a ``load_pytree`` result) -> f32 tensors on ``device``."""
    return {
        mod: {leaf: _tensor(v, device, torch.float32) for leaf, v in sub.items()}
        for mod, sub in tree.items()
    }
