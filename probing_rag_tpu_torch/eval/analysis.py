"""Offline analysis: prober classification eval, retrieval-step
distributions, confusion matrices, correlation.

Port of ``probing_rag_tpu/eval/analysis.py``. The published reference
numbers (the comparison targets of the reference's exp_clf_performance)
live in ``PUBLISHED`` for report generation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.models.gemma import GemmaConfig
from probing_rag_tpu_torch.prober.gate import prober_ensemble_logits
from probing_rag_tpu_torch.prober.train import (
    ProberExample,
    ProberTrainConfig,
    capture_activations,
    pool_sum_answer_tokens,
    tensorize_examples,
)

DATASETS = ("hotpotqa", "nq", "trivia", "musique", "2wikimultihopqa", "iirc")

# Published QA tables (the reference's exp_clf_performance.py:575-593).
PUBLISHED: Dict[str, Dict[str, List[float]]] = {
    "em": {
        "no_retrieval": [16.8, 15.0, 37.5, 3.2, 22.6, 11.6],
        "single_step": [14.6, 11.4, 19.6, 1.8, 22.8, 14.2],
        "flare": [13.2, 9.0, 13.8, 1.2, 21.6, 21.6],
        "dragin": [19.8, 18.8, 42.7, 4.2, 26.5, 14.4],
        "adaptive_rag": [13.3, 11.4, 22.8, 1.6, 21.6, 14.6],
        "probing_rag": [22.2, 21.2, 40.7, 5.0, 24.2, 13.8],
    },
    "accuracy": {
        "no_retrieval": [27.94, 24.55, 45.51, 4.79, 43.11, 23.15],
        "single_step": [28.34, 25.95, 38.72, 5.79, 38.32, 25.54],
        "flare": [20.96, 21.76, 30.94, 1.50, 27.74, 23.15],
        "dragin": [22.55, 22.16, 47.11, 4.40, 27.84, 19.16],
        "adaptive_rag": [23.55, 25.95, 40.72, 2.80, 27.84, 23.15],
        "probing_rag": [39.12, 35.53, 50.50, 9.98, 43.71, 24.95],
    },
}

# Total retrieval calls over 2,500 queries (the paper's poster table).
PUBLISHED_RETRIEVAL_CALLS = {
    "probing_rag": 1988,
    "adaptive_rag": 3068,
    "llm_based": 2345,
    "flare": 5317,
    "dragin": 13570,
}


@dataclass
class ProberOfflineResult:
    site_accuracy: np.ndarray  # [n_sites]
    logits: Optional[np.ndarray]  # [n_examples, n_sites, 2] for KDE dumps
    n_examples: int


@torch.no_grad()
def prober_offline_eval(
    lm_params,
    cfg: GemmaConfig,
    tokenizer,
    examples: Sequence[ProberExample],
    prober_stack,
    tc: ProberTrainConfig,
    collect_logits: bool = False,
    batch_size: int = 8,
) -> ProberOfflineResult:
    """Layer-wise prober classification accuracy over held-out generations
    (the reference's exp_evaluation_probing). Inference-side pooling: SUM
    over the answer-token suffix, not the training mean; the last batch may
    be short."""
    n_sites = len(tc.sites)
    correct = np.zeros(n_sites, np.int64)
    total = 0
    all_logits: List[np.ndarray] = []
    dev = prober_stack["fc1"]["w"].device
    for start in range(0, len(examples), batch_size):
        batch = list(examples[start : start + batch_size])
        tokens, labels, pred_lens = tensorize_examples(batch, tokenizer, tc.max_len)
        caps = capture_activations(lm_params, cfg, tokens, tc.sites, tokenizer.pad_id)
        pooled = pool_sum_answer_tokens(caps, torch.as_tensor(pred_lens, device=caps.device))
        logits = prober_ensemble_logits(prober_stack, pooled.to(dev)).cpu().numpy()
        preds = logits.argmax(-1)  # [n_sites, B]
        correct += (preds == labels[None, :]).sum(axis=1)
        total += len(batch)
        if collect_logits:
            all_logits.append(np.transpose(logits, (1, 0, 2)))
    return ProberOfflineResult(
        site_accuracy=correct / max(total, 1),
        logits=np.concatenate(all_logits) if all_logits else None,
        n_examples=total,
    )


def confusion_matrix(y_true: Sequence[int], y_pred: Sequence[int], n_classes: int = 2) -> np.ndarray:
    """[true, pred] counts."""
    m = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(y_true, y_pred):
        m[int(t), int(p)] += 1
    return m


def retrieval_step_distribution(retr_counts: Sequence[int]) -> Dict[str, float]:
    """no/single/multi retrieval percentages (published 57.46/20.19/22.35
    for Probing-RAG)."""
    counts = np.asarray(list(retr_counts))
    n = len(counts) or 1
    return {
        "no_retrieval_pct": 100.0 * float((counts == 0).sum()) / n,
        "single_pct": 100.0 * float((counts == 1).sum()) / n,
        "multi_pct": 100.0 * float((counts >= 2).sum()) / n,
        "total_calls": int(counts.sum()),
    }


def pearson_correlation(x: Sequence[float], y: Sequence[float]) -> float:
    """clf-accuracy <-> QA-accuracy correlation (published 0.93)."""
    x = np.asarray(list(x), np.float64)
    y = np.asarray(list(y), np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt((xc**2).sum() * (yc**2).sum())
    return float((xc * yc).sum() / denom) if denom else 0.0


def inverse_weighted_average(rows: Dict[str, Sequence[float]]) -> Dict[str, float]:
    """Cross-dataset average weighting each dataset by the inverse of the
    column mean: the reference's normalization for tables mixing easy and
    hard datasets."""
    names = list(rows)
    mat = np.asarray([rows[n] for n in names], np.float64)  # [methods, datasets]
    col_mean = mat.mean(axis=0)
    weights = 1.0 / np.maximum(col_mean, 1e-9)
    weights = weights / weights.sum()
    return {n: float((mat[i] * weights).sum()) for i, n in enumerate(names)}


def consistency_with_direct_qa(
    direct_correct: Sequence[int], method_correct: Sequence[int]
) -> float:
    """Of the queries DirectQA answers correctly, the % the method also
    answers correctly."""
    pairs = [(d, m) for d, m in zip(direct_correct, method_correct) if d == 1]
    if not pairs:
        return 0.0
    return 100.0 * sum(m for _, m in pairs) / len(pairs)
