"""Prober training-data construction (the ``--extracting_cot_qa`` mode).

Port of ``probing_rag_tpu/pipeline/dataset_builder.py``: run the ``none``
and ``simple`` pipelines over a train split, label each generation with the
substring-accuracy flag, and persist (pred_with_prompt, pred, answer, acc)
rows; then merge runs and rebalance them to a target share of correct rows
as prober examples.
"""

from __future__ import annotations

import ast
import csv
import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

from probing_rag_tpu_torch.eval.evaluator import MULTIHOP_DATASETS, evaluate_predictions
from probing_rag_tpu_torch.eval.metrics import EmF1Metric, SupportEmF1Metric
from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline
from probing_rag_tpu_torch.prober.train import ProberExample


@dataclass
class ExtractedRow:
    pred_with_prompt: str
    pred: str
    answer: List[str]
    acc: int


def extract_cot_dataset(
    pipeline: AdaptiveRAGPipeline,
    questions: Sequence[str],
    answers: Sequence[List[str]],
    dataset_name: str,
) -> List[ExtractedRow]:
    """Generate + label rows with the configured method (none/simple)."""
    if pipeline.rag.retr_method not in ("none", "simple"):
        raise ValueError(f"dataset rows come from 'none' or 'simple', not {pipeline.rag.retr_method!r}")
    result = pipeline.run(list(questions))
    metric = SupportEmF1Metric() if dataset_name in MULTIHOP_DATASETS else EmF1Metric()
    acc, _, pred_to_train = evaluate_predictions(
        result.pred_list,
        answers,
        metric,
        dataset_name=dataset_name,
        is_cot=True,
        retr_method=pipeline.rag.retr_method,
    )
    # the returned lists are index-aligned with pred_list (None acc marks a
    # failed metric update); drop unlabeled rows AFTER zipping so one skip
    # cannot shift every later (pred, answer, label) pairing
    return [
        ExtractedRow(pred_full, pred_train, list(ans), a)
        for pred_full, pred_train, ans, a in zip(result.pred_list, pred_to_train, answers, acc)
        if a is not None
    ]


def save_rows(rows: Sequence[ExtractedRow], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pred_with_prompt", "pred", "answer", "acc"])
        for r in rows:
            w.writerow([r.pred_with_prompt, r.pred, repr(r.answer), r.acc])


def load_rows(path: Path) -> List[ExtractedRow]:
    with Path(path).open(newline="") as f:
        # answers are written with repr(list); literal_eval parses them
        # without executing code from dataset files
        return [
            ExtractedRow(row["pred_with_prompt"], row["pred"], ast.literal_eval(row["answer"]),
                         int(row["acc"]))
            for row in csv.DictReader(f)
        ]


def balance_and_merge(
    row_sets: Sequence[Sequence[ExtractedRow]],
    pos_ratio: float = 0.5,
    seed: int = 0,
) -> List[ProberExample]:
    """Merge extraction runs and rebalance to the target correct/incorrect
    ratio, emitting prober training examples. The prober's text input is
    the question prompt (pred_with_prompt minus the generated block) and
    its ``pred`` the generation."""
    rows = [r for rs in row_sets for r in rs if r.pred.strip()]
    pos = [r for r in rows if r.acc == 1]
    neg = [r for r in rows if r.acc == 0]
    rng = random.Random(seed)
    if pos and neg:
        # downsample the larger class to hit pos_ratio
        want_pos = int(pos_ratio * min(len(pos) / pos_ratio, len(neg) / (1 - pos_ratio)))
        want_neg = int(want_pos * (1 - pos_ratio) / pos_ratio)
        pos = rng.sample(pos, min(want_pos, len(pos)))
        neg = rng.sample(neg, min(want_neg, len(neg)))
    merged = pos + neg
    rng.shuffle(merged)
    out = []
    for r in merged:
        prompt_part = r.pred_with_prompt
        if r.pred and r.pred in prompt_part:
            prompt_part = prompt_part[: prompt_part.rindex(r.pred)].rstrip("\n")
        out.append(ProberExample(text=prompt_part, pred=r.pred, label=r.acc))
    return out
