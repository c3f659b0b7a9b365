"""The stand-in tokenizer: SentencePiece-like pieces over the benchmark's
synthetic English (``words.py``), handed to the program wherever it takes a
tokenizer.

Neither a tokenizer file nor ``sentencepiece`` is on the card's machine, so
each configuration gets one of these at its own vocabulary size. Ids 0-2 are
``<unk> <s> </s>`` (Mistral's), then 256 byte pieces for what nothing else
covers (rendered as their character, a letter as nothing), then every chunk of the prompt templates it is given (a word with or
without its leading space, a digit, a mark), then the content words' pieces:
a word of rank below ``one_piece`` is one piece with its leading space, any
other is two (its first syllables with the space, then the rest); further
syllable pieces fill the vocabulary, so that every id a model may emit
renders as a piece. Texts are
split into chunks by one regular expression and each chunk's ids are looked
up, not re-split; a chunk never seen falls back to its bytes. A text of
vocabulary words between single spaces (a passage) takes a faster path to
the same ids. Decoding joins
the pieces' strings, so ``decode(encode(t)) == t`` for the benchmark's texts.

``record`` keeps, from the moment it is set, what the program asked of it:
each prompt it encoded with ``add_bos`` (text -> ids), each string it
decoded (string -> ids), and the order of those calls; ``seconds`` sums the
time spent in ``encode`` (two reads of the clock a call: ~1 ms of a build
call of 8,192 passages).
"""

from __future__ import annotations

import itertools
import re
import time
from typing import Dict, List, Sequence

import numpy as np

from benchmark.lib.words import SYLLABLES, Vocabulary

# a word with its apostrophe suffix ("Nixon's" is one chunk: a piece such as
# "s" alone could turn a content word into a form the stemmer cuts back), a
# digit, a mark, a whitespace character
_CHUNK = re.compile(r" ?[A-Za-z]+(?:'[A-Za-z]+)?| ?[0-9]| ?[^\sA-Za-z0-9]|\s")
N_SPECIAL = 3
BYTE_BASE = N_SPECIAL


class StandInTokenizer:
    def __init__(self, vocab: Vocabulary, vocab_size: int, one_piece: int,
                 templates: Sequence[str] = ()):
        self.vocab_size = vocab_size
        self.unk_id, self.bos_id, self.eos_id = 0, 1, 2
        self.pad_id = self.eos_id  # as the program's SentencePiece tokenizer sets it
        pieces: List[str] = ["<unk>", "<s>", "</s>"]
        # byte pieces render marks, digits and the newline as themselves and
        # any other byte by its name: a letter piece after a content word
        # could make a form the stemmer cuts back
        pieces += [chr(b) if (32 <= b < 127 and not chr(b).isalpha()) or b == 10 else f"<0x{b:02X}>"
                   for b in range(256)]
        ids: Dict[str, int] = {}
        lookup: Dict[str, tuple] = {}

        def piece(s: str) -> int:
            if s not in ids:
                ids[s] = len(pieces)
                pieces.append(s)
            return ids[s]

        for text in templates:
            for chunk in _CHUNK.findall(text):
                lookup.setdefault(chunk, (piece(chunk),))
        for rank in range(vocab.n_stop, len(vocab.words)):
            syl = vocab.syllables[rank]
            w = vocab.words[rank]
            if rank < one_piece:
                parts = (" " + w,)
            else:
                cut = 1 if len(syl) == 2 else 2
                parts = (" " + "".join(syl[:cut]), "".join(syl[cut:]))
            lookup[" " + w] = tuple(piece(p) for p in parts)
            lookup.setdefault(w, lookup[" " + w])  # a word that starts a line
        for rank in range(vocab.n_stop):
            w = vocab.words[rank]
            lookup.setdefault(" " + w, (piece(" " + w),))
            lookup.setdefault(w, lookup[" " + w])
        if len(pieces) > vocab_size:
            raise ValueError(f"{len(pieces)} pieces do not fit a vocabulary of {vocab_size}")
        self.n_pieces = len(pieces)  # the pieces the texts use
        # the rest of the vocabulary: further syllable pieces, which the
        # texts never use but a model may emit
        for n_syl in (1, 2, 3):
            for combo in itertools.product(SYLLABLES, repeat=n_syl):
                for lead in (" ", ""):
                    if len(pieces) < vocab_size:
                        piece(lead + "".join(combo))
        self._pieces = pieces
        self._lookup = lookup
        # a word of the vocabulary after a space: the fast path of a text
        # of such words separated by single spaces (a passage)
        self._spaced = {w: lookup[" " + w] for w in vocab.words}
        self.record = False
        self.seconds = 0.0
        self.prompts: Dict[str, np.ndarray] = {}
        self.decoded: Dict[str, np.ndarray] = {}
        self.log: List[tuple] = []

    def clear(self) -> None:
        """Forget what was recorded and timed."""
        self.prompts, self.decoded, self.log = {}, {}, []
        self.seconds = 0.0

    def _fallback(self, chunk: str) -> tuple:
        return tuple(BYTE_BASE + b for b in chunk.encode("utf-8"))

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        t0 = time.perf_counter()
        look = self._lookup
        ids = [self.bos_id] if add_bos else []
        words = text.split(" ")
        try:  # the same ids as the chunks give, for a text of vocabulary words
            spaced = self._spaced
            ids.extend(look[words[0]])
            ids.extend([i for w in words[1:] for i in spaced[w]])
        except KeyError:
            del ids[1 if add_bos else 0:]
            for chunk in _CHUNK.findall(text):
                got = look.get(chunk)
                ids.extend(got if got is not None else self._fallback(chunk))
        self.seconds += time.perf_counter() - t0
        if self.record and add_bos:
            self.prompts[text] = np.asarray(ids, np.int32)
            self.log.append(("encode", text))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        pieces = self._pieces
        out = "".join(pieces[i] for i in ids)
        if self.record:
            self.decoded[out] = np.asarray(ids, np.int32)
            self.log.append(("decode", out))
        return out

    def token_strings(self) -> List[str]:
        return list(self._pieces)
