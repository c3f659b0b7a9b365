"""The prober ensemble gate of Probing-RAG in plain float32 PyTorch: each
prober is LayerNorm -> Linear(d, 512) -> SiLU -> LayerNorm -> Linear(512,
512) -> SiLU -> LayerNorm -> Linear(512, 2) (the paper's ImprovedProbe,
dropout off), LayerNorm with eps 1e-5 and the population variance; the
ensemble's score is the sum of the probers' softmaxes."""

from __future__ import annotations

from typing import Dict

import torch

LN_EPS = 1e-5


def _ln(x: torch.Tensor, p: Dict, i: int) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["w"][i].to(x.dtype) + p["b"][i].to(x.dtype)


def scores(probers: Dict, pooled: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``pooled`` [n_probers, D], prober i reading row i. Returns [2] in
    float32, computed in ``dtype`` (a lower one for the control)."""
    out = torch.zeros(2, dtype=torch.float32, device=pooled.device)
    for i in range(pooled.shape[0]):
        def lin(name, x):
            return x @ probers[name]["w"][i].to(dtype) + probers[name]["b"][i].to(dtype)

        x = _ln(pooled[i].to(dtype), probers["ln_in"], i)
        x = _ln(torch.nn.functional.silu(lin("fc1", x)), probers["ln1"], i)
        x = _ln(torch.nn.functional.silu(lin("fc2", x)), probers["ln2"], i)
        out += torch.softmax(lin("fc3", x).float(), dim=-1)
    return out
