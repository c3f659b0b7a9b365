"""Text analysis for the sparse index: tokenize -> lowercase -> stopword
filter -> (optional) Porter stem.

Port of ``probing_rag_tpu/retrieval/text.py`` (stdlib only; stemming uses
the port's own Porter stemmer, ``retrieval/porter.py``, which gives NLTK's
stems without NLTK). It replaces the
analyzer chain the reference gets implicitly from llama-index's
BM25Retriever (exp_rag.py:236-242), which lowercases, splits, removes
English stopwords, and Porter-stems. Analysis runs on the host at index
build / query encode time — it is not on the device hot path.

The stopword list below is the standard English list (NLTK's), embedded as
data because the corpus download is unavailable in a zero-egress environment.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

from probing_rag_tpu_torch.retrieval.porter import PorterStemmer

# Standard NLTK English stopword list (public domain word list).
ENGLISH_STOPWORDS = frozenset(
    """a about above after again against ain all am an and any are aren aren't as at be
because been before being below between both but by can couldn couldn't d did didn
didn't do does doesn doesn't doing don don't down during each few for from further
had hadn hadn't has hasn hasn't have haven haven't having he her here hers herself
him himself his how i if in into is isn isn't it it's its itself just ll m ma me
mightn mightn't more most mustn mustn't my myself needn needn't no nor not now o of
off on once only or other our ours ourselves out over own re s same shan shan't she
she's should should've shouldn shouldn't so some such t than that that'll the their
theirs them themselves then there these they this those through to too under until
up ve very was wasn wasn't we were weren weren't what when where which while who
whom why will with won won't wouldn wouldn't y you you'd you'll you're you've your
yours yourself yourselves""".split()
)

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


def _porter_stemmer(mode: str) -> PorterStemmer:
    # "nltk": NLTK's default extensions; "original": Porter's published
    # algorithm, the variant the JAX package's C++ native builder implements
    return PorterStemmer(mode)


@dataclass
class Analyzer:
    """Configurable analysis chain. Defaults match the reference's implicit
    llama-index analyzer (lowercase + stopword removal + Porter stemming)."""

    lowercase: bool = True
    remove_stopwords: bool = True
    stem: bool = True
    stemmer_mode: str = "nltk"
    _stemmer: Optional[object] = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.stem and self._stemmer is None:
            self._stemmer = _porter_stemmer(self.stemmer_mode)

    def __call__(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        tokens = _TOKEN_RE.findall(text)
        if self.remove_stopwords:
            tokens = [t for t in tokens if t not in ENGLISH_STOPWORDS]
        if self.stem:
            stem = self._stemmer.stem
            tokens = [stem(t) for t in tokens]
        return tokens
