"""Answer extraction + accuracy scoring over generated text.

Copy of ``probing_rag_tpu/eval/evaluator.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: the reference's utils.py:392-452 (``evaluator``). The
generation comes back with the full few-shot prompt attached; the answer lives
in a fixed paragraph of the ``\\n\\n``-split text:

- CoT prompts have exactly 4 exemplar paragraphs, so paragraph index 4 is the
  live ``Question/Rationale/Answer`` block; its first line is dropped (the
  question) and the ``Answer:`` marker stripped (utils.py:403-412).
- DRAGIN/FLARE/fix-* baselines generate free text; everything before the
  first blank line / before ``answer`` is used (utils.py:397-402).
- Non-CoT prompts use paragraph index 2 (utils.py:415-418).

Accuracy is a normalized-substring match of any gold answer in the extracted
block (utils.py:437-449); EM/F1 are computed on the answer *line* only.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

from probing_rag_tpu_torch.eval.metrics import normalize_answer

logger = logging.getLogger(__name__)

_STRIP_MARKERS = ("</s>", "<eos>")

MULTIHOP_DATASETS = ("hotpotqa", "2wikimultihopqa", "musique", "iirc")
FREEFORM_METHODS = ("dragin", "fix-length-retrieval", "fix-sentence")


def _clean(text: str) -> str:
    for marker in _STRIP_MARKERS:
        text = text.replace(marker, "")
    return text


def extract_answer(
    pred: str, *, is_cot: bool = True, retr_method: str = "probing"
) -> Tuple[str, str]:
    """Extract the answer block from a generation-with-prompt.

    Returns ``(block, train_block)`` where ``block`` is the cleaned text used
    for substring accuracy and ``train_block`` is the raw rationale+answer
    text persisted as prober training data (utils.py:405-412).
    """
    if is_cot and retr_method in FREEFORM_METHODS:
        if "answer" in pred.lower():
            block = "".join("".join(pred.lower().split("answer")[:1]).split("\n\n")[:1])
            block = block.replace(":", "")
        else:
            block = "".join(pred.split("\n\n")[:1])
        return _clean(block).strip(), ""

    if is_cot:
        para = pred.split("\n\n")[4]
        lines = para.split("\n")
        # Over-long paragraphs (model echoed extra lines) drop the first 8
        # lines, normal ones drop just the question line (utils.py:405-410).
        train_block = "\n".join(lines[8:] if len(lines) > 7 else lines[1:])
        block = _clean(train_block).replace("Answer:", "").strip()
        return block, train_block

    para = pred.split("\n\n")[2]
    block = _clean(para).replace("Answer:", "").strip()
    return block, ""


def answer_line(block: str) -> str:
    """The line fed to EM/F1: line 1 of the extracted block when present,
    else the whole block (utils.py:426-429)."""
    lines = block.split("\n")
    return lines[1] if len(lines) > 1 else block


def evaluate_predictions(
    pred_list: Sequence[str],
    answers: Sequence[Sequence[str]],
    metric,
    *,
    dataset_name: str,
    is_cot: bool = True,
    retr_method: str = "probing",
) -> Tuple[List[Optional[int]], object, List[str]]:
    """Score generations against gold answers.

    Returns ``(acc, metric, pred_to_train)``: per-example substring-accuracy
    flags, the updated EM/F1 metric accumulator, and the extracted blocks used
    as prober training text. Both lists are index-aligned with ``pred_list``:
    an example whose metric update fails gets ``acc[i] = None`` (the reference
    skips it, utils.py:431-436 — a compact list here would silently shift
    every downstream (pred, answer, label) pairing), and an example with no
    train block gets ``pred_to_train[i] = ""``.
    """
    blocks: List[str] = []
    pred_to_train: List[str] = []
    for pred in pred_list:
        block, train_block = extract_answer(pred, is_cot=is_cot, retr_method=retr_method)
        blocks.append(block)
        pred_to_train.append(train_block)

    acc: List[Optional[int]] = []
    for golds, block in zip(answers, blocks):
        gold_norm = [normalize_answer(a) for a in golds]
        block_norm = normalize_answer(block)
        line_norm = normalize_answer(answer_line(block))

        try:
            if dataset_name in MULTIHOP_DATASETS:
                metric([line_norm], gold_norm)
            else:
                metric(line_norm, gold_norm)
        except Exception as exc:  # parity: reference skips the example's metric
            logger.warning("metric update failed, skipping example: %s", exc)
            acc.append(None)
            continue

        acc.append(int(any(g in block_norm for g in gold_norm)))

    return acc, metric, pred_to_train
