"""HF safetensors checkpoint -> the port's parameter dicts.

Port of ``probing_rag_tpu/models/hf_loader.py``: maps the HF layouts of
the Gemma/Mistral decoders and of BERT/Contriever onto the layer-stacked
layouts of ``models/gemma.py`` and ``models/encoder.py`` (torch linear
weights ``[out, in]`` are transposed to ``[in, out]``; Gemma's RMSNorm
weights pass through, the forward applies ``1 + w``). The shards are read
by ``read_safetensors``, a small reader of the format (the ``safetensors``
package is not needed): an u64 little-endian header length, a JSON header
giving each tensor's ``dtype``, ``shape`` and ``data_offsets`` (and an
optional ``__metadata__``), then the raw bytes. It reads the dtypes that
the JAX loader reads through ``safetensors.safe_open(framework="numpy")``
with ``ml_dtypes`` loaded: numpy's own and bf16; fp8 raises there and here.
The tensors stay in their own dtype over a memory map of each shard until
the loaders cast them to f32, as the JAX loaders do, one layer at a time
into each stacked leaf.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from probing_rag_tpu_torch.models.encoder import EncoderConfig
from probing_rag_tpu_torch.models.gemma import GemmaConfig, Params
from probing_rag_tpu_torch.weights import encoder_params_from_jax, lm_params_from_jax

# safetensors dtype tag -> numpy dtype (the numpy framework's table); bf16,
# which numpy lacks, is read as its uint16 bits and viewed as torch's bf16
_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64, "BF16": np.uint16,
}


def read_safetensors_file(path: Path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, in its own dtype, as a
    CPU tensor over a copy-on-write memory map of the file: nothing is read
    until a tensor is used, and nothing is widened here."""
    path = Path(path)
    size = path.stat().st_size
    if size < 8:
        raise ValueError(f"{path}: shorter than a safetensors header")
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    (n,) = struct.unpack("<Q", mm[:8].tobytes())
    if 8 + n > size:
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(mm[8 : 8 + n].tobytes())
    body = mm[8 + n :]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        tag = info["dtype"]
        if tag not in _DTYPES:
            raise TypeError(f"{path}: tensor {name} has dtype {tag}, which is not read")
        dt = np.dtype(_DTYPES[tag])
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - start != dt.itemsize * int(np.prod(shape)) or end > len(body):
            raise ValueError(f"{path}: tensor {name} has offsets {start}:{end} for {tag} {shape}")
        arr = body[start:end].view(dt).reshape(shape)
        if arr.ctypes.data % dt.itemsize:  # an unaligned tensor is copied
            arr = arr.copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if tag == "BF16" else t
    return out


def read_safetensors(ckpt_dir: Path) -> Dict[str, torch.Tensor]:
    """The tensors of every ``*.safetensors`` shard under ``ckpt_dir``."""
    tensors: Dict[str, torch.Tensor] = {}
    for shard in sorted(Path(ckpt_dir).glob("*.safetensors")):
        tensors.update(read_safetensors_file(shard))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors files under {ckpt_dir}")
    return tensors


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 copy (bf16 widens exactly)."""
    return t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)


def _getter(t: Dict[str, torch.Tensor], prefixes):
    def get(name: str) -> torch.Tensor:
        for prefix in prefixes:
            if prefix + name in t:
                return t[prefix + name]
        raise KeyError(f"missing tensor {name}; have e.g. {list(t)[:5]}")

    return get


def _stacker(get, n_layers: int):
    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        """The layers' tensors stacked in f32, each widened (and
        transposed) as it is copied in."""
        mats = [get(fmt.format(i)) for i in range(n_layers)]
        mats = [m.T for m in mats] if transpose else mats
        out = torch.empty((n_layers, *mats[0].shape), dtype=torch.float32)
        for i, m in enumerate(mats):
            out[i].copy_(m)
        return out

    return stack


def load_gemma_params(ckpt_dir: Path, cfg: GemmaConfig, dtype: torch.dtype = torch.float32,
                      device="cuda") -> Params:
    """Load a HF Gemma/Mistral-style decoder checkpoint into the stacked
    layout of ``models/gemma.py``, as tensors on ``device`` in ``dtype``.
    Raises AssertionError when the embedding's geometry is not ``cfg``'s."""
    t = read_safetensors(ckpt_dir)
    get = _getter(t, ("model.", ""))
    stack = _stacker(get, cfg.n_layers)
    params = {
        "embed": _f32(get("embed_tokens.weight")),
        "final_norm": _f32(get("norm.weight")),
        "layers": {
            "attn_norm": stack("layers.{}.input_layernorm.weight", False),
            "wq": stack("layers.{}.self_attn.q_proj.weight", True),
            "wk": stack("layers.{}.self_attn.k_proj.weight", True),
            "wv": stack("layers.{}.self_attn.v_proj.weight", True),
            "wo": stack("layers.{}.self_attn.o_proj.weight", True),
            "mlp_norm": stack("layers.{}.post_attention_layernorm.weight", False),
            "w_gate": stack("layers.{}.mlp.gate_proj.weight", True),
            "w_up": stack("layers.{}.mlp.up_proj.weight", True),
            "w_down": stack("layers.{}.mlp.down_proj.weight", True),
        },
    }
    if not cfg.tied_head:
        # Mistral-family: a separate output head, stored [V, D] at the top
        # level (no "model." prefix)
        params["lm_head"] = _f32(get("lm_head.weight").T)
    v, d = params["embed"].shape
    assert v == cfg.vocab_size and d == cfg.d_model, (
        f"checkpoint geometry ({v},{d}) != config ({cfg.vocab_size},{cfg.d_model})"
    )
    return lm_params_from_jax(params, cfg, device=device, dtype=dtype)


def load_encoder_params(ckpt_dir: Path, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                        device="cuda") -> Params:
    """Load a HF BERT/Contriever checkpoint into the layout of
    ``models/encoder.py``, as tensors on ``device`` in ``dtype``."""
    t = read_safetensors(ckpt_dir)
    get = _getter(t, ("bert.", ""))
    stack = _stacker(get, cfg.n_layers)

    def top(name):
        return _f32(get(name))

    pre = "encoder.layer.{}."
    params = {
        "tok_embed": top("embeddings.word_embeddings.weight"),
        "pos_embed": top("embeddings.position_embeddings.weight"),
        "type_embed": top("embeddings.token_type_embeddings.weight"),
        "embed_ln": {"w": top("embeddings.LayerNorm.weight"), "b": top("embeddings.LayerNorm.bias")},
        "layers": {
            "wq": stack(pre + "attention.self.query.weight", True),
            "bq": stack(pre + "attention.self.query.bias", False),
            "wk": stack(pre + "attention.self.key.weight", True),
            "bk": stack(pre + "attention.self.key.bias", False),
            "wv": stack(pre + "attention.self.value.weight", True),
            "bv": stack(pre + "attention.self.value.bias", False),
            "wo": stack(pre + "attention.output.dense.weight", True),
            "bo": stack(pre + "attention.output.dense.bias", False),
            "attn_ln": {
                "w": stack(pre + "attention.output.LayerNorm.weight", False),
                "b": stack(pre + "attention.output.LayerNorm.bias", False),
            },
            "w1": stack(pre + "intermediate.dense.weight", True),
            "b1": stack(pre + "intermediate.dense.bias", False),
            "w2": stack(pre + "output.dense.weight", True),
            "b2": stack(pre + "output.dense.bias", False),
            "mlp_ln": {
                "w": stack(pre + "output.LayerNorm.weight", False),
                "b": stack(pre + "output.LayerNorm.bias", False),
            },
        },
    }
    return encoder_params_from_jax(params, cfg, device=device, dtype=dtype)
