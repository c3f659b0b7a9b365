"""Conversion of the JAX package's parameters into the port's.

The port keeps the JAX layouts (linear weights ``[in, out]``, layer leaves
stacked ``[L, ...]``), so conversion is a copy: each numpy (or CPU torch)
leaf becomes a tensor on ``device``. Shapes are checked against the config.
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


def lm_params_from_jax(tree: Dict[str, Any], cfg: GemmaConfig, device="cpu",
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """LM params (``models/gemma.py::init_params`` / ``hf_loader`` tree, as
    numpy arrays) -> the port's dict of tensors on ``device`` in ``dtype``."""
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
    out: Dict[str, Any] = {"layers": {}}
    for name, shape in want.items():
        if tuple(layers[name].shape) != shape:
            raise ValueError(f"layers/{name}: shape {tuple(layers[name].shape)} != {shape}")
        out["layers"][name] = _tensor(layers[name], device, dtype)
    top = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tied_head:
        top["lm_head"] = (d, cfg.vocab_size)
    for name, shape in top.items():
        if tuple(tree[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(tree[name].shape)} != {shape}")
        out[name] = _tensor(tree[name], device, dtype)
    return out


def encoder_params_from_jax(tree: Dict[str, Any], cfg: EncoderConfig, device="cpu",
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


def probers_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Stacked prober params (``prober/train.py::init_prober_stack`` tree or
    a ``load_pytree`` result) -> f32 tensors on ``device``."""
    return {
        mod: {leaf: _tensor(v, device, torch.float32) for leaf, v in sub.items()}
        for mod, sub in tree.items()
    }
