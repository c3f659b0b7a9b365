"""The port's greedy decode (probing_rag_tpu_torch.models.decode.generate)
against the JAX generate on the tiny config in float32.

Same numpy-drawn parameters on both sides. Tokens, n_pooled and
n_generated must be exactly equal; pooled captures allclose at rtol 1e-4 /
atol 1e-3 — sums of up to max_new_tokens f32 activation vectors whose
per-step values differ in the last bits (matmul summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import decode as jd
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu_torch.models import decode as td
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

PROMPTS = [
    "Question: where is the eiffel tower?\nAnswer:",
    "Q: 2+2?",
    "A longer prompt about rivers, mountains and the capital of France.\n",
]


def _both(tree, jcfg, tcfg, strings, **kv):
    j_texts, j_res = jd.generate(
        to_jax(tree), jcfg, JaxByteTokenizer(300), PROMPTS, max_new_tokens=40,
        stop_tables=jd.StopTables.from_token_strings(strings), **kv,
    )
    t_texts, t_res = td.generate(
        lm_params_from_jax(tree, tcfg, device="cpu"), tcfg, ByteTokenizer(300), PROMPTS,
        max_new_tokens=40, stop_tables=td.StopTables.from_token_strings(strings), **kv,
    )
    assert t_texts == j_texts
    np.testing.assert_array_equal(t_res.tokens, np.asarray(j_res.tokens))
    np.testing.assert_array_equal(t_res.token_valid, np.asarray(j_res.token_valid))
    np.testing.assert_array_equal(t_res.n_pooled, np.asarray(j_res.n_pooled))
    np.testing.assert_array_equal(t_res.n_generated, np.asarray(j_res.n_generated))
    np.testing.assert_allclose(
        t_res.pooled_captures, np.asarray(j_res.pooled_captures), rtol=1e-4, atol=1e-3
    )
    return t_res


def test_generate_matches_jax():
    """Without stops every row runs to max_new_tokens; then one of row 0's
    generated tokens is made a paragraph stop, which ends rows early (the
    cap_ok pooling and EOS padding after the trigger are compared too)."""
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=300), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=300), compute_dtype=torch.float32)
    tree = numpy_params(jcfg, seed=4)
    strings = ByteTokenizer(300).token_strings()
    res = _both(tree, jcfg, tcfg, [""] * 300)
    assert (res.n_generated == 40).all()
    strings[int(res.tokens[0, 5])] = "x\n\n"
    res = _both(tree, jcfg, tcfg, strings)
    assert (res.n_generated < 40).any()


@pytest.mark.parametrize("quant,kv", [
    (dict(bits=8), dict(kv_int8=True)),
    (None, dict(kv_int8=True)),
    (dict(bits=4, int4_scheme="rank1"), dict(kv_int4=True)),
])
def test_quantized_generate_matches_jax(quant, kv):
    """Greedy decode over int8 (or rank-1 int4) weights and an int8 (int4)
    KV cache, f32 compute: the same tokens as the JAX decode."""
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=300), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=300), compute_dtype=torch.float32)
    tree = numpy_params(jcfg, seed=4)
    if quant is not None:
        tree = jax.tree_util.tree_map(np.asarray, jg.quantize_lm_params(to_jax(tree), **quant))
    res = _both(tree, jcfg, tcfg, [""] * 300, **kv)
    assert (res.n_generated == 40).all()
    with pytest.raises(ValueError, match="exclusive"):
        td._kv_dtype(tcfg, True, True)


def test_stop_tables_and_pad_batch_match_jax():
    strings = ByteTokenizer(256000).token_strings()
    assert all(s == "" for s in strings[256:])
    j = jd.StopTables.from_token_strings(strings)
    t = td.StopTables.from_token_strings(strings)
    for name in ("contains_dbl_nl", "ends_nl", "starts_nl"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    ids = [[1, 2, 3], list(range(200)), [7]]
    for a, b in zip(td._pad_batch(ids, 257), jd._pad_batch(ids, 257)):
        np.testing.assert_array_equal(a, b)


def test_tokenizer_matches_jax():
    from probing_rag_tpu.models.tokenizer import _piece_to_string as j_piece
    from probing_rag_tpu_torch.models.tokenizer import _piece_to_string as t_piece

    t, j = ByteTokenizer(300), JaxByteTokenizer(300)
    text = "Paris, café\n\nnaïve 東京"
    assert t.encode(text, add_bos=True) == j.encode(text, add_bos=True)
    assert t.decode(t.encode(text) + [257, 299]) == j.decode(j.encode(text) + [257, 299]) == text
    assert t.token_strings() == j.token_strings()
    assert (t.bos_id, t.eos_id, t.pad_id) == (j.bos_id, j.eos_id, j.pad_id)
    for piece in ("a", "<0x0A>", "<0xFF>", "▁hello", "<0x41>x"):
        assert t_piece(piece) == j_piece(piece), piece


def test_sampling_is_not_ported():
    """Greedy selection (``do_sample=False``) is the first maximum, as
    ``jnp.argmax``: sampling's own checks are in test_torch_generation.py."""
    from probing_rag_tpu_torch.models.sampling import SamplingConfig, select_token

    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, -1.0, 3.0, 3.0]])
    assert select_token(logits, SamplingConfig()).tolist() == [1, 0]  # first max
    assert select_token(logits, SamplingConfig(temperature=0.1, top_k=2)).tolist() == [1, 0]
