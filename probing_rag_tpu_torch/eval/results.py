"""Run-result persistence.

Copy of ``probing_rag_tpu/eval/results.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: exp_rag.py:533-560 — a one-row CSV per run with columns
(retr_method, time, acc, em, f1[, clf_pred, acc.1]) under an encoded
filename, where em/f1 come from ``title_em``/``title_f1`` for the multihop
datasets. A structured JSONL record is written alongside (SURVEY.md §5.5).
"""

from __future__ import annotations

import csv
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from probing_rag_tpu_torch.eval.evaluator import MULTIHOP_DATASETS


@dataclass
class RunRecord:
    retr_method: str
    dataset_name: str
    elapsed_s: float
    acc: List[Optional[int]]  # index-aligned with queries; None = metric-skipped
    metric_out: Dict[str, Any]
    retr_count_list: Optional[List[int]] = None
    config: Optional[Dict[str, Any]] = None

    @property
    def accuracy(self) -> float:
        scored = [a for a in self.acc if a is not None]
        return sum(scored) / len(scored) if scored else 0.0

    def em_f1(self):
        m = self.metric_out
        if self.dataset_name in MULTIHOP_DATASETS:
            return m["title_em"], m["title_f1"]
        return m["em"], m["f1"]


def result_filename(
    ablation: int,
    ds_code: str,
    retr_type: str,
    dataset_name: str,
    threshold: float,
    retr_method: str,
    cot: str,
    split: str,
    steps: int,
) -> str:
    """The reference's encoded result filename (exp_rag.py:560)."""
    return f"{ablation}_{ds_code}_{retr_type}_{dataset_name}_{threshold}_{retr_method}_{cot}_{split}_{steps}.csv"


def save_run(record: RunRecord, out_dir: Path, filename: str) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    em, f1 = record.em_f1()
    path = out_dir / filename
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        header = ["retr_method", "time", "acc", "em", "f1"]
        row = [record.retr_method, record.elapsed_s, record.accuracy, em, f1]
        if record.retr_count_list is not None:
            header += ["clf_pred", "acc.1"]
            row += [str(record.retr_count_list), str(record.acc)]
        else:
            header += ["acc.1"]
            row += [str(record.acc)]
        w.writerow(header)
        w.writerow(row)

    jsonl = out_dir / "runs.jsonl"
    with jsonl.open("a") as f:
        f.write(
            json.dumps(
                {
                    "ts": time.time(),
                    "retr_method": record.retr_method,
                    "dataset": record.dataset_name,
                    "elapsed_s": record.elapsed_s,
                    "accuracy": record.accuracy,
                    "em": em,
                    "f1": f1,
                    "metric": record.metric_out,
                    "retr_counts": record.retr_count_list,
                    "config": record.config,
                    "csv": str(path),
                },
                default=str,
            )
            + "\n"
        )
    return path
