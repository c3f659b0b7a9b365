"""Prober models: small MLPs over one residual-stream vector.

Port of ``probing_rag_tpu/prober/model.py``. ``ImprovedProbe`` (the paper's
prober): LN -> Linear(d,512) -> SiLU -> LN -> Dropout(0.1) ->
Linear(512,512) -> SiLU -> LN -> Dropout -> Linear(512,2); 1,318,914 params
at d=2048. ``Probe`` is the linear-probe ablation. Parameters are plain
dicts of tensors in the JAX layout (linear weights ``[in, out]``); a stack
of probers is the same dict with a leading prober axis, and the stacked
forward scores every prober's own rows in one batched product. Dropout
draws from a ``torch.Generator`` passed only in training (JAX's
``dropout_rng``); without one the forward is the eval forward.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

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


def _dropout(x: torch.Tensor, generator: Optional[torch.Generator], rate: float) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the identity without a
    generator."""
    if generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def improved_probe_forward(
    params: ProbeParams,
    x: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.1,
) -> torch.Tensor:
    """Forward of a prober stack: params with a leading prober axis N
    (``init_prober_stack``) and x [N, B, input_size]; every prober scores
    its own rows of x. Pass ``generator`` only during training. Returns
    logits [N, B, output_size]."""

    def linear(p, h):
        return torch.bmm(h, p["w"]) + p["b"][:, None, :]

    def norm(p, h):
        return _layer_norm(h, {"w": p["w"][:, None, :], "b": p["b"][:, None, :]})

    x = norm(params["ln_in"], x)
    x = norm(params["ln1"], F.silu(linear(params["fc1"], x)))
    x = _dropout(x, generator, dropout_rate)
    x = norm(params["ln2"], F.silu(linear(params["fc2"], x)))
    x = _dropout(x, generator, dropout_rate)
    return linear(params["fc3"], x)


def init_linear_probe(
    generator: torch.Generator, input_size: int, output_size: int = NUM_CLASSES, device="cuda"
) -> ProbeParams:
    return {"ln": _ln_init(input_size, device),
            "fc": _linear_init(generator, input_size, output_size, device)}


def linear_probe_forward(params: ProbeParams, x: torch.Tensor) -> torch.Tensor:
    """One linear probe: x [..., input_size] -> logits [..., output_size]."""
    return _layer_norm(x, params["ln"]) @ params["fc"]["w"] + params["fc"]["b"]


def probe_param_count(params: ProbeParams) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else probe_param_count(v)
               for v in params.values())
