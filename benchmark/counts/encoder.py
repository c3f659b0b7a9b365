"""Operations and bytes of a BERT-base encoder (Contriever) over the valid
tokens of each passage: the padding a batch adds to its longest passage is
waste, not work. 2 FLOPs per multiply-add; the four attention projections
and the two MLP products per token, attention's two products over the
passage's own keys. Bytes of attention: its queries, keys, values and
output, bf16, each read or written once."""

from __future__ import annotations

from typing import Dict, Sequence


def _dims(c: Dict):
    d, h = c["hidden_size"], c["num_attention_heads"]
    return d, h, d // h, c["intermediate_size"], c["num_hidden_layers"]


def flops(c: Dict, lengths: Sequence[int]) -> float:
    d, _, _, f, layers = _dims(c)
    per_token = 2 * (4 * d * d + 2 * d * f)
    return layers * sum(n * per_token + 4 * d * n * n for n in lengths)


def attention_flops(c: Dict, lengths: Sequence[int]) -> float:
    d, _, _, _, layers = _dims(c)
    return layers * sum(4 * d * n * n for n in lengths)


def attention_bytes(c: Dict, lengths: Sequence[int], elem_bytes: int = 2) -> float:
    d, _, _, _, layers = _dims(c)
    return layers * sum(4 * n * d * elem_bytes for n in lengths)
