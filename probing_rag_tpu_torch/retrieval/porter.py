"""Porter stemmer in plain Python, for the port's text analyzer.

Written from two sources:

- M. F. Porter, "An algorithm for suffix stripping", Program 14(3),
  130-137 (1980): the published algorithm, steps 1a to 5b, which is the
  ``"original"`` mode here (and what ``probing_rag_tpu/native/indexer.cpp``
  implements).
- NLTK's documented rules for its default ``PorterStemmer`` mode,
  ``NLTK_EXTENSIONS`` (``nltk/stem/porter.py``, Apache License 2.0): the
  ``"nltk"`` mode here. On top of the paper it keeps a pool of irregular
  forms, leaves words of one or two letters alone, maps ``-ies``/``-ied``
  of four letters to ``-ie``, turns ``y`` into ``i`` only after a consonant
  that is not the whole stem, applies ``alli -> al`` first and runs step 2
  again, uses ``bli -> ble`` for the paper's ``abli -> able``, adds
  ``fulli -> ful`` and ``logi -> log``, and counts a two-letter ``vc`` stem
  as ending consonant-vowel-consonant.

Both modes lowercase the word first, as NLTK's ``stem()`` does. The tests
hold both modes equal to NLTK's stemmer word for word
(``tests/test_torch_porter.py``); this module imports nothing but the
standard library, so stemming works where NLTK is not installed.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

MODES = ("nltk", "original")
_VOWELS = frozenset("aeiou")

# NLTK_EXTENSIONS' irregular forms: word -> stem
IRREGULAR = {
    "sky": "sky", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "news": "news", "innings": "inning", "inning": "inning", "outings": "outing",
    "outing": "outing", "cannings": "canning", "canning": "canning", "howe": "howe",
    "proceed": "proceed", "exceed": "exceed", "succeed": "succeed",
}


def consonants(word: str) -> List[bool]:
    """Per letter, whether it is a consonant in Porter's sense: not a, e,
    i, o or u, and not a ``y`` that follows a consonant. A letter's class
    depends only on the letters before it, so a prefix's classes are a
    prefix of the word's."""
    out: List[bool] = []
    for i, ch in enumerate(word):
        if ch in _VOWELS:
            out.append(False)
        elif ch == "y":
            out.append(i == 0 or not out[-1])
        else:
            out.append(True)
    return out


def measure(stem: str) -> int:
    """Porter's m: the number of vowel-consonant boundaries of
    ``[C](VC){m}[V]``."""
    cs = consonants(stem)
    return sum(1 for a, b in zip(cs, cs[1:]) if not a and b)


def has_vowel(stem: str) -> bool:
    return not all(consonants(stem))


def ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and consonants(word)[-1]


Rule = Tuple[str, str, Callable[[str], bool]]


def _first_rule(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix ends ``word`` decides: its replacement
    if its condition holds on the stem, else ``word`` unchanged."""
    for suffix, repl, cond in rules:
        if word.endswith(suffix):
            stem = word[: len(word) - len(suffix)]
            return stem + repl if cond(stem) else word
    return word


def _m_gt0(stem: str) -> bool:
    return measure(stem) > 0


def _m_gt1(stem: str) -> bool:
    return measure(stem) > 1


_STEP2_HEAD = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
               ("izer", "ize"))
_STEP2_TAIL = (("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
               ("ization", "ize"), ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
               ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
               ("iviti", "ive"), ("biliti", "ble"))
_STEP3 = tuple((s, r, _m_gt0) for s, r in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", "")))
_STEP4 = tuple((s, "", _m_gt1) for s in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")) + (
    ("ion", "", lambda stem: measure(stem) > 1 and stem[-1:] in ("s", "t")),) + tuple(
    (s, "", _m_gt1) for s in ("ou", "ism", "ate", "iti", "ous", "ive", "ize"))


class PorterStemmer:
    """``PorterStemmer(mode).stem(word)``; ``mode`` is ``"nltk"`` (NLTK's
    default extensions) or ``"original"`` (the published algorithm)."""

    def __init__(self, mode: str = "nltk"):
        if mode not in MODES:
            raise ValueError(f"stemmer mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.nltk = mode == "nltk"
        head = [(s, r, _m_gt0) for s, r in _STEP2_HEAD]
        head.append(("bli", "ble", _m_gt0) if self.nltk else ("abli", "able", _m_gt0))
        self._step2_rules = head + [(s, r, _m_gt0) for s, r in _STEP2_TAIL]
        if self.nltk:
            self._step2_rules.append(("fulli", "ful", _m_gt0))
        # one cache per stemmer: an index build stems each distinct term once
        self.stem = functools.lru_cache(maxsize=1 << 18)(self._stem)

    def _ends_cvc(self, word: str) -> bool:
        """Porter's *o: the word ends consonant-vowel-consonant, the last
        not w, x or y; in NLTK's mode also a two-letter vowel-consonant."""
        cs = consonants(word)
        if len(word) >= 3 and cs[-3] and not cs[-2] and cs[-1] and word[-1] not in "wxy":
            return True
        return self.nltk and len(word) == 2 and not cs[0] and cs[1]

    def _step1a(self, word: str) -> str:
        if self.nltk and len(word) == 4 and word.endswith("ies"):
            return word[:-3] + "ie"
        for suffix, repl in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
            if word.endswith(suffix):
                return word[: len(word) - len(suffix)] + repl
        return word

    def _step1b(self, word: str) -> str:
        if self.nltk and word.endswith("ied"):
            return word[:-3] + ("ie" if len(word) == 4 else "i")
        if word.endswith("eed"):
            return word[:-1] if measure(word[:-3]) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix) and has_vowel(word[: -len(suffix)]):
                stem = word[: -len(suffix)]
                break
        else:
            return word
        for suffix, repl in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
            if stem.endswith(suffix):
                return stem[: -len(suffix)] + repl
        if ends_double_consonant(stem):
            return stem[:-1] if stem[-1] not in "lsz" else stem
        if measure(stem) == 1 and self._ends_cvc(stem):
            return stem + "e"
        return stem

    def _step1c(self, word: str) -> str:
        if not word.endswith("y"):
            return word
        stem = word[:-1]
        if self.nltk:
            ok = len(stem) > 1 and consonants(stem)[-1]
        else:
            ok = has_vowel(stem)
        return stem + "i" if ok else word

    def _step2(self, word: str) -> str:
        if self.nltk and word.endswith("alli") and measure(word[:-4]) > 0:
            return self._step2(word[:-4] + "al")
        rules = self._step2_rules
        if self.nltk:
            # the 'l' of 'logi' stays with the stem in the measure
            rules = rules + [("logi", "log", lambda stem: measure(word[:-3]) > 0)]
        return _first_rule(word, rules)

    def _step5a(self, word: str) -> str:
        if word.endswith("e"):
            m = measure(word[:-1])
            if m > 1 or (m == 1 and not self._ends_cvc(word[:-1])):
                return word[:-1]
        return word

    @staticmethod
    def _step5b(word: str) -> str:
        if word.endswith("ll") and measure(word[:-1]) > 1:
            return word[:-1]
        return word

    def _stem(self, word: str) -> str:
        w = word.lower()
        if self.nltk:
            if w in IRREGULAR:
                return IRREGULAR[w]
            if len(word) <= 2:
                return w
        w = self._step1a(w)
        w = self._step1b(w)
        w = self._step1c(w)
        w = self._step2(w)
        w = _first_rule(w, _STEP3)
        w = _first_rule(w, _STEP4)
        w = self._step5a(w)
        return self._step5b(w)
