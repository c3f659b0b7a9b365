"""QA metrics — the parity contract with the reference implementation.

Copy of ``probing_rag_tpu/eval/metrics.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: the reference's metrics/metrcis.py (EmF1Metric at :84-122,
SupportEmF1Metric at :153-296, normalize_answer at :30-47, compute_f1 at
:60-73). These definitions are SQuAD/HotpotQA-standard; the reference's
published tables (BASELINE.md) were produced with exactly these reductions,
including the 3-decimal rounding in ``get_metric`` and the support-metric
whitespace-stripped lowercase comparison.

Pure host-side Python: metrics run over decoded strings after generation, so
they are deliberately not jitted. ftfy text fixing (used by the reference) is
applied when the library is present; otherwise a Unicode-NFC fallback is used.
"""

from __future__ import annotations

import collections
import re
import string
import unicodedata
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Sequence

try:  # the reference runs every string through ftfy.fix_text (metrcis.py:99)
    import ftfy

    def _fix_text(s: str) -> str:
        return ftfy.fix_text(s)

except ImportError:  # pragma: no cover - environment-dependent

    def _fix_text(s: str) -> str:
        # NFC normalization covers the common case (composed accents); full
        # mojibake repair needs ftfy, which is optional here.
        return unicodedata.normalize("NFC", s)


_ARTICLE_RE = re.compile(r"\b(a|an|the)\b", re.UNICODE)
_PUNCT = set(string.punctuation)


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLE_RE.sub(" ", s)
    return " ".join(s.split())


def get_tokens(s: str) -> List[str]:
    if not s:
        return []
    return normalize_answer(s).split()


def compute_exact(a_gold: str, a_pred: str) -> int:
    return int(normalize_answer(a_gold) == normalize_answer(a_pred))


def compute_f1(a_gold: str, a_pred: str) -> float:
    gold_toks = get_tokens(a_gold)
    pred_toks = get_tokens(a_pred)
    common = collections.Counter(gold_toks) & collections.Counter(pred_toks)
    num_same = sum(common.values())
    if len(gold_toks) == 0 or len(pred_toks) == 0:
        # If either is no-answer, F1 is 1 iff they agree.
        return float(gold_toks == pred_toks)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return (2 * precision * recall) / (precision + recall)


def metric_max_over_ground_truths(metric_fn, prediction: str, ground_truths: Sequence[str]):
    return max(metric_fn(gt, prediction) for gt in ground_truths)


@dataclass
class EmF1Metric:
    """SQuAD-style EM + token-F1, max over gold answers, mean over examples."""

    _total_em: float = 0.0
    _total_f1: float = 0.0
    _count: int = 0

    def __call__(self, predicted_answer, ground_truth_answers: Sequence[str]) -> None:
        # The reference tolerates a single-element list prediction and a
        # tuple-wrapped gold list (metrcis.py:96-97).
        if isinstance(predicted_answer, list):
            predicted_answer = predicted_answer[0]
        if ground_truth_answers and isinstance(ground_truth_answers[0], tuple):
            ground_truth_answers = list(ground_truth_answers[0])

        predicted_answer = _fix_text(predicted_answer)
        ground_truth_answers = [_fix_text(e) for e in ground_truth_answers]

        self._total_em += metric_max_over_ground_truths(
            compute_exact, predicted_answer, ground_truth_answers
        )
        self._total_f1 += metric_max_over_ground_truths(
            compute_f1, predicted_answer, ground_truth_answers
        )
        self._count += 1

    def get_metric(self, reset: bool = False) -> Dict[str, Any]:
        em = self._total_em / self._count if self._count else 0
        f1 = self._total_f1 / self._count if self._count else 0
        out = {"em": round(em, 3), "f1": round(f1, 3), "count": self._count}
        if reset:
            self.reset()
        return out

    def reset(self) -> None:
        self._total_em = 0.0
        self._total_f1 = 0.0
        self._count = 0


def _support_set_metrics(predicted: Iterable[str], gold: Iterable[str]) -> Dict[str, float]:
    """HotpotQA supporting-fact set metrics over whitespace-stripped lowercase
    strings (metrcis.py:124-150)."""
    predicted = {re.sub(r" +", "", _fix_text(str(e)).lower()) for e in predicted}
    gold = {re.sub(r" +", "", _fix_text(str(e)).lower()) for e in gold}

    tp = len(predicted & gold)
    fp = len(predicted - gold)
    fn = len(gold - predicted)
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * prec * recall / (prec + recall) if prec + recall > 0 else 0.0
    em = 1.0 if fp + fn == 0 else 0.0
    if not predicted and not gold:
        f1, em = 1.0, 1.0
    return {"prec": prec, "recall": recall, "f1": f1, "em": em}


@dataclass
class SupportEmF1Metric:
    """HotpotQA-style supporting-fact EM/F1/precision/recall over titles and
    paragraph ids. The reference (mis)uses this for answer EM on the multihop
    datasets — predictions and golds are answer strings, so the title and
    para views coincide (exp_rag.py:259-264; reported as title_em/title_f1 at
    exp_rag.py:535). Preserved here because the BASELINE.md multihop numbers
    depend on it.
    """

    do_normalize_answer: bool = False
    _acc: Dict[str, float] = field(default_factory=dict)
    _count: int = 0

    def __post_init__(self) -> None:
        self.reset()

    def __call__(self, predicted_support: Sequence[str], gold_support: Sequence[str]) -> None:
        predicted_support = list(predicted_support or [])
        gold_support = list(gold_support)

        if self.do_normalize_answer:
            predicted_support = [normalize_answer(e) for e in predicted_support]
            gold_support = [normalize_answer(e) for e in gold_support]

        if not gold_support:
            pred_titles = pred_paras = predicted_support
            gold_titles: List[str] = []
            gold_paras: List[str] = []
        elif gold_support[0].startswith("pid"):
            # "pid{i}___{title}___{para}" encoded support ids.
            for e in gold_support + predicted_support:
                assert e.startswith("pid"), e
            pred_titles = [e.split("___")[1] for e in predicted_support]
            pred_paras = predicted_support
            gold_titles = [e.split("___")[1] for e in gold_support]
            gold_paras = gold_support
        else:
            for e in gold_support + predicted_support:
                assert not e.startswith("pid"), e
            pred_titles = pred_paras = predicted_support
            gold_titles = gold_paras = gold_support

        titles = _support_set_metrics(map(str, pred_titles), map(str, gold_titles))
        paras = _support_set_metrics(map(str, pred_paras), map(str, gold_paras))

        a = self._acc
        n_titles = len(set(map(str, pred_titles)))
        n_paras = len(set(map(str, pred_paras)))
        a["total_predicted_titles"] += n_titles
        a["max_predicted_titles"] = max(a["max_predicted_titles"], n_titles)
        a["min_predicted_titles"] = min(a["min_predicted_titles"], n_titles)
        a["total_predicted_paras"] += n_paras
        a["max_predicted_paras"] = max(a["max_predicted_paras"], n_paras)
        a["min_predicted_paras"] = min(a["min_predicted_paras"], n_paras)
        for key in ("em", "f1", "prec", "recall"):
            a[f"titles_{key}"] += titles[key]
            a[f"paras_{key}"] += paras[key]
        self._count += 1

    def get_metric(self, reset: bool = False) -> Dict[str, Any]:
        c = self._count
        a = self._acc

        def avg(x: float) -> float:
            return x / c if c else 0

        out = {
            "title_em": round(avg(a["titles_em"]), 3),
            "title_f1": round(avg(a["titles_f1"]), 3),
            "title_precision": round(avg(a["titles_prec"]), 3),
            "title_recall": round(avg(a["titles_recall"]), 3),
            "para_em": round(avg(a["paras_em"]), 3),
            "para_f1": round(avg(a["paras_f1"]), 3),
            "para_precision": round(avg(a["paras_prec"]), 3),
            "para_recall": round(avg(a["paras_recall"]), 3),
            "avg_predicted_titles": avg(a["total_predicted_titles"]),
            "max_predicted_titles": a["max_predicted_titles"],
            "min_predicted_titles": a["min_predicted_titles"],
            "avg_predicted_paras": avg(a["total_predicted_paras"]),
            "max_predicted_paras": a["max_predicted_paras"],
            "min_predicted_paras": a["min_predicted_paras"],
            "count": c,
        }
        if reset:
            self.reset()
        return out

    def reset(self) -> None:
        self._acc = {
            "titles_em": 0.0,
            "titles_f1": 0.0,
            "titles_prec": 0.0,
            "titles_recall": 0.0,
            "paras_em": 0.0,
            "paras_f1": 0.0,
            "paras_prec": 0.0,
            "paras_recall": 0.0,
            "total_predicted_titles": 0,
            "max_predicted_titles": -float("inf"),
            "min_predicted_titles": float("inf"),
            "total_predicted_paras": 0,
            "max_predicted_paras": -float("inf"),
            "min_predicted_paras": float("inf"),
        }
        self._count = 0
