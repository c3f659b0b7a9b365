"""Operations and bytes of a decoder LM (Mistral's shapes) from the tokens
it serves.

Model FLOPs count 2 per multiply-add of each product the tokens need:
every layer's projections (q, k, v, o) and MLP (gate, up, down) for every
token fed; attention's two products (scores and values) over the keys each
query may see (causal; the padding a batch adds is no key); the head once
per prompt (prefill needs only the last position's logits) and once per
decoded token. Embedding lookups, norms and softmax are left out: they are
not products, and peaks count products.
"""

from __future__ import annotations

from typing import Dict, Sequence


def _dims(c: Dict):
    d, h = c["hidden_size"], c["num_attention_heads"]
    return d, h, c["num_key_value_heads"], d // h, c["intermediate_size"], c["num_hidden_layers"]


def layer_flops_per_token(c: Dict) -> int:
    d, h, kv, hd, f, _ = _dims(c)
    return 2 * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f)


def head_flops(c: Dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: Dict, n: int) -> float:
    """A prompt of ``n`` tokens: the layers, causal attention (query i sees
    i + 1 keys), the head at the last position."""
    d, h, _, hd, _, layers = _dims(c)
    attention = 4 * h * hd * n * (n + 1) / 2
    return layers * (n * layer_flops_per_token(c) + attention) + head_flops(c)


def decode_flops(c: Dict, prompt: int, fed: int) -> float:
    """``fed`` tokens decoded after a prompt of ``prompt`` tokens: token j
    sees ``prompt + j + 1`` keys; each gets the layers and the head."""
    d, h, _, hd, _, layers = _dims(c)
    keys = fed * (prompt + 1) + fed * (fed - 1) / 2
    return fed * (layers * layer_flops_per_token(c) + head_flops(c)) + layers * 4 * h * hd * keys


def decode_attention_bytes(c: Dict, prompts: Sequence[int], steps: int, cache_bytes: int = 2
                           ) -> float:
    """Bytes the decode steps' attention needs: at step s a row reads the
    keys and values of its ``prompt + s + 1`` valid slots, once (padded
    slots and the static cache's unused tail are not needed), and reads its
    queries and writes its output."""
    d, h, kv, hd, _, layers = _dims(c)
    keys = sum(steps * (p + 1) + steps * (steps - 1) / 2 for p in prompts)
    per_row_step = 2 * h * hd * 2  # queries in, output out, bf16
    return layers * (keys * 2 * kv * hd * cache_bytes + len(prompts) * steps * per_row_step)


def decode_attention_flops(c: Dict, prompts: Sequence[int], steps: int) -> float:
    d, h, kv, hd, _, layers = _dims(c)
    keys = sum(steps * (p + 1) + steps * (steps - 1) / 2 for p in prompts)
    return layers * 4 * h * hd * keys
