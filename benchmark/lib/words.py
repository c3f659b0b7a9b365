"""The synthetic English the benchmark's texts are written in.

A vocabulary of ``n_terms`` words ranked by frequency: the English stopwords
first (the most frequent words of real text), then content words made of
consonant-vowel syllables. Every syllable ends in ``a`` or ``o``, so every
content word, every piece of one and every run of such pieces ends in a
letter that no suffix rule of Porter's stemmer removes: the BM25 analysis
leaves each content word as it is, and a plain reference can match terms
without a stemmer of its own (``tests/test_bench_words.py`` holds this
against the program's stemmer). Word frequencies are Zipf(``zipf_s``) over
the ranks. Texts are drawn as rank matrices with numpy and rendered by one
join and string slices, so 20M words take about two seconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

# NLTK's English stopwords without apostrophes (153), the most frequent in English
# text first, the rest alphabetically
STOPWORDS = tuple((
    "the of and to a in is was for on as with by he it that at from his an be are which "
    "or this were had have not but its they has their been who she her all more after "
    "into other than there when can up about above again against ain am any aren because "
    "before being below between both couldn d did didn do does doesn doing don down "
    "during each few further hadn hasn haven having here hers herself him himself how i "
    "if isn itself just ll m ma me mightn most mustn my myself needn no nor now o off "
    "once only our ours ourselves out over own re s same shan should shouldn so some "
    "such t theirs them themselves then these those through too under until ve very wasn "
    "we weren what where while whom why will won wouldn y you your yours yourself "
    "yourselves "
).split())

ONSETS = ("b d f g h j k l m n p r s t v w z bl br dr fl fr gl gr kl kr pl pr sk sl "
          "sp st tr").split()
VOWELS = ("a", "o")
SYLLABLES = tuple(o + v for o in ONSETS for v in VOWELS)


@dataclass(frozen=True)
class Vocabulary:
    """``words[r]`` is the word of frequency rank ``r``; ``syllables[r]`` its
    syllables (a stopword is one). ``n_stop`` ranks are stopwords."""

    words: tuple
    syllables: tuple
    n_stop: int
    zipf_s: float

    @classmethod
    def make(cls, n_terms: int, zipf_s: float, seed: int, two_syllable: int) -> "Vocabulary":
        """``two_syllable`` content words of two syllables take the ranks
        right after the stopwords, the rest have three; all are distinct and
        drawn from a generator seeded ``seed``."""
        rng = np.random.default_rng(seed)
        n_content = n_terms - len(STOPWORDS)
        out, seen = [], set(STOPWORDS)
        k = len(SYLLABLES)
        while len(out) < n_content:
            n_syl = 2 if len(out) < two_syllable else 3
            syl = tuple(SYLLABLES[i] for i in rng.integers(0, k, n_syl))
            w = "".join(syl)
            if w not in seen:
                seen.add(w)
                out.append(syl)
        syllables = tuple((w,) for w in STOPWORDS) + tuple(out)
        return cls(tuple("".join(s) for s in syllables), syllables, len(STOPWORDS), zipf_s)

    @classmethod
    def of_mix(cls, traffic: dict) -> "Vocabulary":
        """The vocabulary a traffic mix's ``words`` entry describes."""
        w = traffic["words"]
        return cls.make(w["n_terms"], w["zipf_s"], w["seed"], w["two_syllable"])

    def cdf(self, content_only: bool = False) -> np.ndarray:
        p = np.arange(1, len(self.words) + 1, dtype=np.float64) ** -self.zipf_s
        if content_only:
            p[: self.n_stop] = 0.0
        c = np.cumsum(p)
        return c / c[-1]

    def draw(self, rng: np.random.Generator, shape, content_only: bool = False) -> np.ndarray:
        """Ranks of ``shape`` words drawn by frequency (int32)."""
        u = rng.random(shape)
        return np.searchsorted(self.cdf(content_only), u, side="right").astype(np.int32)

    def render(self, ranks: np.ndarray, lengths: Sequence[int]) -> List[str]:
        """The texts of consecutive runs of ``ranks`` (flat), ``lengths``
        words each, words joined by one space."""
        words = np.asarray(self.words, dtype=object)
        flat = np.asarray(ranks).ravel()
        big = " ".join(words[flat].tolist())
        wlen = np.fromiter((len(w) for w in self.words), np.int64, len(self.words))[flat] + 1
        ends_word = np.cumsum(wlen)  # one past each word's trailing space
        lengths = np.asarray(lengths, np.int64)
        last = np.cumsum(lengths) - 1
        first = last - lengths + 1
        starts = np.where(lengths > 0, ends_word[first] - wlen[first], 0)
        stops = np.where(lengths > 0, ends_word[last] - 1, 0)
        return [big[s:e] for s, e in zip(starts.tolist(), stops.tolist())]
