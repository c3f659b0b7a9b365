"""Prober stack configuration and initialisation.

Port of ``ProberTrainConfig.sites`` and ``init_prober_stack`` from
``probing_rag_tpu/prober/train.py``. Training itself (its config fields,
the vmapped AdamW step, pooling variants, losses) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from probing_rag_tpu_torch.prober.model import init_improved_probe


@dataclass(frozen=True)
class ProberTrainConfig:
    layers: Tuple[int, ...] = (6, 8, 10, 12, 14, 16)
    positions: Tuple[str, ...] = ("resid_mid", "resid_post")

    @property
    def sites(self) -> Tuple[Tuple[int, str], ...]:
        return tuple((l, p) for l in self.layers for p in self.positions)


def init_prober_stack(
    tc: ProberTrainConfig, d_model: int, generator: torch.Generator, device="cuda"
):
    """Stacked params for all (layer, position) sites: leaves [n_sites, ...]."""
    per_site = [init_improved_probe(generator, d_model, device=device) for _ in tc.sites]
    return {
        mod: {leaf: torch.stack([p[mod][leaf] for p in per_site]) for leaf in per_site[0][mod]}
        for mod in per_site[0]
    }
