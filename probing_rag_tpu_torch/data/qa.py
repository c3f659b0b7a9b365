"""QA dataset loaders for the five eval sets (+ IIRC).

Copy of ``probing_rag_tpu/data/qa.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: the reference's exp_rag.py:251-299 (path map, per-format
parsing, IIRC flattening, answer-field selection) and utils.py:337-351
(multihop answer-string cleanup). Datasets are host-side JSON/JSONL; loading
is not on the hot path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

MULTIHOP_DATASETS = ("hotpotqa", "2wikimultihopqa", "musique", "iirc")


@dataclass
class QAExample:
    question: str
    answers: List[str]
    qid: str = ""


def dataset_path(root: Path, dataset_name: str, split: str) -> Path:
    """The reference's raw-data layout (exp_rag.py:251-257)."""
    root = Path(root)
    if dataset_name == "hotpotqa":
        fname = (
            f"hotpot_{split}_distractor_v1.json" if split == "dev" else f"hotpot_{split}_v1.1.json"
        )
        return root / "hotpotqa" / fname
    if dataset_name == "nq":
        return root / "nq" / f"biencoder-nq-{split}.json"
    if dataset_name == "trivia":
        return root / "trivia" / f"biencoder-trivia-{split}.json"
    if dataset_name == "2wikimultihopqa":
        return root / "2wikimultihopqa" / f"{split}.json"
    if dataset_name == "musique":
        return root / "musique" / f"musique_full_v1.0_{split}.jsonl"
    if dataset_name == "iirc":
        return root / "iirc" / f"{split}.json"
    raise ValueError(f"unknown dataset {dataset_name!r}")


def answer_field(dataset_name: str) -> str:
    """Multihop sets store a scalar 'answer', the DPR sets a list 'answers'
    (exp_rag.py:259-264)."""
    return "answer" if dataset_name in MULTIHOP_DATASETS else "answers"


def _clean_multihop_answer(raw) -> List[str]:
    """The reference round-trips multihop answers through a pandas string
    column, then unpacks "['a' 'b']"-style reprs (utils.py:337-351). Native
    JSON answers are str; normalize both to a list of strings."""
    if isinstance(raw, list):
        return [str(a) for a in raw]
    s = str(raw).replace("[", "").replace("]", "")
    return [part.replace("'", "") for part in s.split("' '")]


def preprocess_multihop_answers(examples: Sequence[QAExample], dataset_name: str) -> List[QAExample]:
    if dataset_name not in ("hotpotqa", "2wikimultihopqa", "musique"):
        return list(examples)
    return [
        QAExample(e.question, sum((_clean_multihop_answer(a) for a in e.answers), []), e.qid)
        for e in examples
    ]


def _flatten_iirc(raw) -> List[QAExample]:
    """IIRC nests questions under passages and types its answers
    (exp_rag.py:274-295)."""
    out: List[QAExample] = []
    for tmp in raw:
        for example in tmp["questions"]:
            ans = example["answer"]
            if ans["type"] == "none":
                continue
            if ans["type"] in ("value", "binary"):
                answer = [ans["answer_value"]]
            elif ans["type"] == "span":
                answer = [v["text"].strip() for v in ans["answer_spans"]]
            else:
                continue
            out.append(QAExample(example["question"], answer, example["qid"]))
    return out


def load_qa_dataset(root: Path, dataset_name: str, split: str) -> List[QAExample]:
    path = dataset_path(root, dataset_name, split)
    if dataset_name == "musique":
        raw = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    else:
        raw = json.loads(path.read_text())

    if dataset_name == "iirc":
        return _flatten_iirc(raw)

    field = answer_field(dataset_name)
    examples = []
    for value in raw:
        answers = value[field]
        if not isinstance(answers, list):
            answers = [answers]
        examples.append(QAExample(value["question"], [str(a) for a in answers], str(value.get("qid", value.get("_id", "")))))
    return preprocess_multihop_answers(examples, dataset_name)
