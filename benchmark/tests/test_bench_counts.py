"""The yardstick's operation and byte counts against shapes worked by hand."""

import json
from pathlib import Path

import pytest

from benchmark.counts import encoder, lm

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_mistral_layer_and_head_flops():
    c = json.loads((CONFIGS / "mistral-7b.json").read_text())
    # q 4096x4096, k and v 4096x1024, o 4096x4096, gate/up/down 4096x14336
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    assert lm.layer_flops_per_token(c) == 2 * per_layer
    assert lm.head_flops(c) == 2 * 4096 * 32000
    # 7.24B parameters: 32 layers of products + embedding + head
    assert 32 * per_layer + 2 * 4096 * 32000 == pytest.approx(7.24e9, rel=0.01)


def test_prefill_and_decode_attention_flops():
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "intermediate_size": 16, "num_hidden_layers": 1, "vocab_size": 10}
    dense = 2 * (8 * 4 * 4 + 8 * 8 + 3 * 8 * 16)  # q 8x8, k,v 8x4, o 8x8, mlp 3x8x16
    # 3 tokens, causal: 1 + 2 + 3 keys, 4 * heads * hd per key
    assert lm.prefill_flops(c, 3) == 3 * dense + 4 * 2 * 4 * 6 + 2 * 8 * 10
    # 2 tokens after a prompt of 3: 4 and 5 keys
    assert lm.decode_flops(c, 3, 2) == 2 * (dense + 2 * 8 * 10) + 4 * 2 * 4 * 9


def test_decode_attention_bytes():
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "intermediate_size": 16, "num_hidden_layers": 3, "vocab_size": 10}
    # prompts 3 and 5, 2 steps: keys (4 + 5) + (6 + 7) = 22, K and V of 1 head x 4 lanes
    # in bf16, q and out 2 heads x 4 lanes bf16 per row-step
    assert lm.decode_attention_bytes(c, [3, 5], 2) == 3 * (22 * 2 * 4 * 2 + 4 * 2 * 8 * 2)


def test_encoder_counts():
    c = json.loads((CONFIGS / "contriever-msmarco.json").read_text())
    per_token = 2 * (4 * 768 * 768 + 2 * 768 * 3072)
    assert encoder.flops(c, [10]) == 12 * (10 * per_token + 4 * 768 * 100)
    assert encoder.attention_flops(c, [10, 20]) == 12 * 4 * 768 * 500
    assert encoder.attention_bytes(c, [10]) == 12 * 4 * 10 * 768 * 2
