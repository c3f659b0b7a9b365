"""BM25 over the benchmark's corpus, straight from the formula: rank_bm25's
Okapi scoring (the engine behind the reference's llama-index retriever) with
the program's documented cap on long queries.

Terms are the corpus's content words (``lib/words.py``): analysis is
lowercasing and ``\\w+`` tokens, of which those that are content words
count; stopwords and every other token drop out. Porter stemming leaves
content words as they are (they end in ``a`` or ``o``), so it is not
repeated here. Per term, ``idf = ln((N - n + 0.5) / (n + 0.5))``, negative
values floored at ``epsilon`` times the mean idf over the corpus's terms;
a term counted ``c`` times in the query adds ``c * idf * tf * (k1 + 1) /
(tf + k1 * (1 - b + b * dl / avgdl))`` to a document, ``dl`` its count of
content words. A content word that no document holds is no term.

The cap: a query whose terms' postings (document frequencies) total more
than ``cap`` keeps its most selective terms, shortest postings first, as
many as fit, ties in the order the search saw them: the order of first
appearance in the corpus when any query of the same call repeats a term,
else the query's own order.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np
import torch

_TOKEN = re.compile(r"\w+")


class ReferenceBM25:
    def __init__(self, ranks: np.ndarray, words: Sequence[str], n_stop: int, *, k1: float,
                 b: float, epsilon: float, cap: int, device):
        """``ranks`` [N, L] word ranks of the corpus; ranks below ``n_stop``
        are stopwords."""
        n_docs = ranks.shape[0]
        content = ranks >= n_stop
        flat = ranks[content]
        self.df = np.zeros(len(words), np.int64)
        # df: documents holding each term; first: its first position in the corpus
        doc_of = np.repeat(np.arange(n_docs), content.sum(1))
        pairs = np.unique(flat.astype(np.int64) * n_docs + doc_of)
        np.add.at(self.df, pairs // n_docs, 1)
        _, first = np.unique(flat, return_index=True)
        self.first = np.full(len(words), np.iinfo(np.int64).max, np.int64)
        self.first[np.unique(flat)] = first
        present = self.df > 0
        # a content word that no document holds is no term of the index
        self.term_of = {words[i]: i for i in np.nonzero(present)[0].tolist()}
        idf = np.log((n_docs - self.df + 0.5) / (self.df + 0.5))
        floor = epsilon * idf[present].mean()
        self.idf = np.where(idf < 0, floor, idf)
        self.cap = cap
        dl = content.sum(1).astype(np.float64)
        norm = k1 * (1.0 - b + b * dl / dl.mean())
        # per occurrence: its term's impact in the document divided by the
        # term's count there, so the occurrences of a term sum to its impact
        t = torch.as_tensor(np.where(content, ranks, len(words)).astype(np.int64), device=device)
        srt, order = torch.sort(t, dim=1)
        run = torch.ones_like(srt, dtype=torch.bool)
        run[:, 1:] = srt[:, 1:] != srt[:, :-1]
        run_id = torch.cumsum(run.long(), dim=1) - 1
        counts = torch.zeros_like(srt).scatter_add_(1, run_id, torch.ones_like(srt))
        tf_sorted = torch.gather(counts, 1, run_id).double()
        tf = torch.empty_like(tf_sorted).scatter_(1, order, tf_sorted)
        idf_t = torch.as_tensor(np.append(self.idf, 0.0), device=device)[t]
        norm_t = torch.as_tensor(norm, device=device)[:, None]
        self.impact = idf_t * tf * (k1 + 1.0) / (tf + norm_t)  # the term's impact in the doc
        self.tf = tf
        self.terms = t
        self.n_terms = len(words)
        self.device = device

    def analyze(self, text: str) -> List[int]:
        look = self.term_of
        return [look[w] for w in _TOKEN.findall(text.lower()) if w in look]

    def kept_terms(self, queries: Sequence[str]) -> List[Dict[int, int]]:
        """Each query's kept terms with their counts, after the cap."""
        analyzed = [self.analyze(q) for q in queries]
        repeats = any(len(set(a)) < len(a) for a in analyzed)
        out = []
        for a in analyzed:
            counts: Dict[int, int] = {}
            for t in a:
                counts[t] = counts.get(t, 0) + 1
            terms = sorted(counts, key=lambda t: self.first[t]) if repeats else list(counts)
            lens = self.df[terms]
            if lens.sum() > self.cap:
                order = np.argsort(lens, kind="stable")
                keep = int(np.searchsorted(np.cumsum(lens[order]), self.cap, side="right"))
                terms = [terms[i] for i in sorted(order[:keep])]
            out.append({t: counts[t] for t in terms})
        return out

    def scores(self, kept: Dict[int, int], impact_dtype=None) -> torch.Tensor:
        """[N] float64 scores of one query's kept terms; ``impact_dtype``
        rounds each impact first (the control)."""
        w = torch.zeros(self.n_terms + 1, dtype=torch.float64, device=self.device)
        if kept:
            w[torch.tensor(list(kept), device=self.device)] = torch.tensor(
                list(kept.values()), dtype=torch.float64, device=self.device)
        impact = self.impact
        if impact_dtype is not None:
            impact = impact.to(impact_dtype).double()
        return (w[self.terms] * impact / self.tf).sum(1)
