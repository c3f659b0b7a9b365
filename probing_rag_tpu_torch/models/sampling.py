"""Token selection for the decode loop: greedy / temperature / top-k /
top-p / frequency penalty.

Port of ``probing_rag_tpu/models/sampling.py``, with the same config
surface and the same order of operations. Every selector keeps static
shapes and never reads the host, so it runs inside a captured CUDA graph
of the decode step: the categorical draw is Gumbel-max over uniforms from
``torch.rand`` (how ``jax.random.categorical`` draws), never
``torch.multinomial``, which can synchronise with the host. The
frequency-penalty token counts live in the decode state and are a 1-wide
dummy when the penalty is off (``SamplingConfig.needs_counts``).
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
    # transformer_lens sample_logits order: the penalty applies BEFORE
    # temperature/top-k/top-p (logits -= p * count(token) over the whole
    # sequence so far, prompt included)
    freq_penalty: float = 0.0

    @property
    def needs_counts(self) -> bool:
        return self.do_sample and self.freq_penalty != 0.0


def filter_logits(
    logits: torch.Tensor,  # [B, V] f32
    config: SamplingConfig,
    token_counts: Optional[torch.Tensor] = None,  # [B, V] int32
) -> torch.Tensor:
    """The sampled path's logits before the draw: the frequency penalty,
    then temperature (clamped at 1e-6), then top-k by its k-th value, then
    top-p (the smallest sorted prefix whose mass reaches ``top_p``, the
    argmax always kept). Dropped tokens hold ``-inf``."""
    if config.needs_counts:
        if token_counts is None:
            raise ValueError("freq_penalty needs token counts")
        logits = logits - config.freq_penalty * token_counts.to(logits.dtype)
    logits = logits / max(config.temperature, 1e-6)
    if config.top_k is not None:
        kth = torch.topk(logits, config.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if config.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < config.top_p  # first always kept
        thresh = sorted_logits.masked_fill(~keep, torch.inf).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, -torch.inf)
    return logits


def select_token(
    logits: torch.Tensor,  # [B, V]
    config: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    token_counts: Optional[torch.Tensor] = None,  # [B, V] int32
) -> torch.Tensor:
    """[B, V] logits -> [B] int64 token ids. Greedy picks the first maximum,
    as ``jnp.argmax`` does; sampling draws from the softmax of
    :func:`filter_logits` by Gumbel-max, ``argmax(logits - log(-log(u)))``
    with ``u`` uniform from ``generator`` (the device's default generator
    when None)."""
    if not config.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, config, token_counts)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)  # rand's 0 would give -inf noise
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
