"""Prober models: small MLPs over one residual-stream vector.

Port of ``probing_rag_tpu/prober/model.py``. ``ImprovedProbe`` (the paper's
prober): LN -> Linear(d,512) -> SiLU -> LN -> Dropout(0.1) ->
Linear(512,512) -> SiLU -> LN -> Dropout -> Linear(512,2); 1,318,914 params
at d=2048. Parameters are plain dicts of tensors in the JAX layout (linear
weights ``[in, out]``); a stack of probers is the same dict with a leading
prober axis. Only inference of a stack is ported: dropout is off.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

ProbeParams = Dict[str, Any]

HIDDEN_SIZE = 512
NUM_CLASSES = 2
LN_EPS = 1e-5  # torch.nn.LayerNorm default


def _linear_init(generator: torch.Generator, fan_in: int, fan_out: int, device):
    # torch.nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both
    # weight and bias
    bound = 1.0 / math.sqrt(fan_in)

    def u(*shape):
        x = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return x.mul_(2 * bound).sub_(bound)

    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def _ln_init(dim: int, device):
    return {
        "w": torch.ones((dim,), dtype=torch.float32, device=device),
        "b": torch.zeros((dim,), dtype=torch.float32, device=device),
    }


def _layer_norm(x: torch.Tensor, p: ProbeParams) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * p["w"] + p["b"]


def init_improved_probe(
    generator: torch.Generator,
    input_size: int,
    output_size: int = NUM_CLASSES,
    hidden_size: int = HIDDEN_SIZE,
    device="cuda",
) -> ProbeParams:
    return {
        "ln_in": _ln_init(input_size, device),
        "fc1": _linear_init(generator, input_size, hidden_size, device),
        "ln1": _ln_init(hidden_size, device),
        "fc2": _linear_init(generator, hidden_size, hidden_size, device),
        "ln2": _ln_init(hidden_size, device),
        "fc3": _linear_init(generator, hidden_size, output_size, device),
    }


def improved_probe_forward(params: ProbeParams, x: torch.Tensor) -> torch.Tensor:
    """Inference forward of a prober stack: params with a leading prober
    axis N (``init_prober_stack``) and x [N, B, input_size]; every prober
    scores its own row of x. Returns logits [N, B, 2]."""

    def linear(p, h):
        return torch.bmm(h, p["w"]) + p["b"][:, None, :]

    def norm(p, h):
        return _layer_norm(h, {"w": p["w"][:, None, :], "b": p["b"][:, None, :]})

    x = norm(params["ln_in"], x)
    x = norm(params["ln1"], F.silu(linear(params["fc1"], x)))
    x = norm(params["ln2"], F.silu(linear(params["fc2"], x)))
    return linear(params["fc3"], x)
