"""Tokenizers for the port.

Port of ``probing_rag_tpu/models/tokenizer.py``. ``ByteTokenizer`` is the
self-contained byte-level tokenizer (UTF-8 bytes + BOS/EOS/PAD, exact round
trip) the CLI uses without a checkpoint. ``SentencePieceTokenizer`` is a
checkpoint's tokenizer: a sentencepiece ``.model`` file (through the
``sentencepiece`` package, imported when one is opened) or a ready HF
tokenizer object; pad = eos, as the reference sets it.
"""

from __future__ import annotations

import re
from typing import List, Sequence

# sentencepiece byte-fallback piece, e.g. "<0x0A>" for "\n"
_BYTE_PIECE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _piece_to_string(piece: str) -> str:
    """Surface form of one vocab piece: byte-fallback pieces decode to their
    byte's character (StopTables must see '\\n' to flag newline tokens) and
    the sentencepiece word-boundary marker becomes a space."""
    m = _BYTE_PIECE.match(piece)
    if m:
        try:
            return bytes([int(m.group(1), 16)]).decode("utf-8")
        except UnicodeDecodeError:
            return ""
    return piece.replace("▁", " ")


class ByteTokenizer:
    """UTF-8 byte vocab + {PAD, BOS, EOS}; pad == eos, as the reference sets
    it. Ids 256 and up are special or unused and render as empty strings."""

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 259:
            raise ValueError(f"vocab_size must be >= 259, got {vocab_size}")
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 257

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="ignore")

    def token_strings(self) -> List[str]:
        out = []
        for i in range(self.vocab_size):
            if i < 256:
                try:
                    out.append(bytes([i]).decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("")
            else:
                out.append("")
        return out


class SentencePieceTokenizer:
    """Checkpoint tokenizer. Accepts either a sentencepiece model path or a
    ready HF tokenizer object (``transformers.AutoTokenizer``)."""

    def __init__(self, source):
        if isinstance(source, str):
            try:
                import sentencepiece as spm
            except ImportError as e:
                raise ImportError(
                    f"reading the sentencepiece model {source!r} needs the sentencepiece "
                    "package; pass a HF tokenizer object instead") from e
            sp = spm.SentencePieceProcessor()
            sp.Load(source)
            self._sp = sp
            self._hf = None
            self.vocab_size = sp.GetPieceSize()
            self.bos_id = sp.bos_id()
            self.eos_id = sp.eos_id()
        else:
            self._sp = None
            self._hf = source
            self.vocab_size = len(source)
            self.bos_id = source.bos_token_id
            self.eos_id = source.eos_token_id
        self.pad_id = self.eos_id

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        if self._sp is not None:
            ids = self._sp.EncodeAsIds(text)
        else:
            ids = self._hf.encode(text, add_special_tokens=False)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        if self._sp is not None:
            return self._sp.DecodeIds(list(ids))
        return self._hf.decode(ids, skip_special_tokens=False)

    def token_strings(self) -> List[str]:
        if self._sp is not None:
            return [_piece_to_string(self._sp.IdToPiece(i)) for i in range(self.vocab_size)]
        toks = self._hf.convert_ids_to_tokens(list(range(self.vocab_size)))
        return [_piece_to_string(t) if isinstance(t, str) else "" for t in toks]
