"""The prober ensemble retrieval gate.

Port of ``probing_rag_tpu/prober/gate.py``. Per probed layer, the decode
loop's sum-pooled generated-token activations are scored by that layer's
prober; the ensemble sums class probabilities over probers ``ablation:``
and retrieval fires unless ``S[0] + threshold < S[1]``:

    S = sum_i softmax(logits_i)
    stop generating iff S[0] + theta < S[1]

Class 1 = the no-retrieval generation was correct, class 0 = needs
retrieval.
"""

from __future__ import annotations

from typing import Tuple

import torch

from probing_rag_tpu_torch.prober.model import improved_probe_forward


def prober_ensemble_logits(stacked_probe_params, pooled: torch.Tensor) -> torch.Tensor:
    """pooled: [n_probers, B, D]; params stacked along a leading prober
    axis. Returns logits [n_probers, B, 2]."""
    return improved_probe_forward(stacked_probe_params, pooled)


def gate_decision(
    stacked_probe_params,
    pooled: torch.Tensor,  # [n_probers, B, D]
    threshold: float = 0.0,
    ablation: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (retrieve [B] bool, scores [B, 2]). ``retrieve[b]`` is True
    when the ensemble says another retrieval round is needed; ``ablation``
    drops the first N probers from the sum."""
    logits = prober_ensemble_logits(stacked_probe_params, pooled)
    probs = torch.softmax(logits, dim=-1)
    scores = probs[ablation:].sum(dim=0)
    stop = scores[:, 0] + threshold < scores[:, 1]
    return ~stop, scores
