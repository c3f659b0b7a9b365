"""Token selection for the decode loop.

Port of ``probing_rag_tpu/models/sampling.py``: the config surface is the
same, and greedy selection (the reference's main path, ``do_sample=False``)
is implemented. Temperature / top-k / top-p / frequency-penalty sampling
raises ``NotImplementedError`` until it is ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingConfig:
    do_sample: bool = False  # greedy when False (the reference's main path)
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    freq_penalty: float = 0.0


def select_token(logits: torch.Tensor, config: SamplingConfig) -> torch.Tensor:
    """[B, V] logits -> [B] int64 token ids. Greedy picks the first maximum,
    as ``jnp.argmax`` does."""
    if config.do_sample:
        raise NotImplementedError("sampled decoding is not ported yet; use greedy")
    return torch.argmax(logits, dim=-1)
