"""The port's Contriever/BERT encoder against the JAX one on
``EncoderConfig.tiny()``, with the same weights (JAX init, converted by
``encoder_params_from_jax``) and the same numpy-drawn tokens and ragged
masks.

Tolerances: f32 rtol/atol 1e-5 (the same f32 arithmetic, summed in
another order). bf16: the projections round to bf16 at the same points,
but GELU and the matmul sums round in another order, so a rounding
difference of one bf16 ulp (2^-8 relative) can pass through the two
layers; the bound is a max abs error of 3% of the output's max abs value,
and the f32 residual stream keeps it there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import encoder as je
from probing_rag_tpu_torch.models import encoder as te
from probing_rag_tpu_torch.weights import encoder_params_from_jax

torch.set_num_threads(1)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs(cfg, lengths=(12, 7, 1), t=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(len(lengths), t)).astype(np.int32)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return tokens, mask


@pytest.fixture(scope="module")
def params():
    return tree_np(je.init_encoder_params(je.EncoderConfig.tiny(), jax.random.PRNGKey(3)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_matches_jax(params, dtype):
    jcfg = je.EncoderConfig.tiny()
    tcfg = te.EncoderConfig.tiny()
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    tokens, mask = inputs(jcfg)
    ref = np.asarray(je.encoder_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                        jnp.asarray(tokens), jnp.asarray(mask), jcfg))
    got = te.encoder_forward(encoder_params_from_jax(params, tcfg, device="cpu"), torch.from_numpy(tokens).long(),
                             torch.from_numpy(mask), tcfg).numpy()
    assert got.shape == ref.shape == (3, jcfg.d_model) and np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max()


def test_padding_does_not_change_pooled_vector(params):
    """Extra padded positions holding other tokens leave every row's
    pooled vector unchanged (the keys are masked, the mean skips them)."""
    cfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    p = encoder_params_from_jax(params, cfg, device="cpu")
    tokens, mask = inputs(cfg, lengths=(9, 4, 1), t=9)
    padded = np.concatenate([tokens, np.full((3, 7), 5, np.int32)], axis=1)
    pmask = np.concatenate([mask, np.zeros((3, 7), bool)], axis=1)
    a = te.encoder_forward(p, torch.from_numpy(tokens).long(), torch.from_numpy(mask), cfg)
    b = te.encoder_forward(p, torch.from_numpy(padded).long(), torch.from_numpy(pmask), cfg)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


def test_contriever_config_and_shape_checks(params):
    c = te.EncoderConfig.contriever()
    assert (c.d_model, c.n_layers, c.n_heads, c.d_ff, c.vocab_size, c.max_positions) == (
        768, 12, 12, 3072, 30522, 512)
    assert c.norm_eps == 1e-12
    bad = dict(params, pos_embed=params["pos_embed"][:-1])
    with pytest.raises(ValueError, match="pos_embed"):
        encoder_params_from_jax(bad, te.EncoderConfig.tiny(), device="cpu")
    layers = {k: v for k, v in params["layers"].items() if k != "b2"}
    with pytest.raises(ValueError, match="layers"):
        encoder_params_from_jax(dict(params, layers=layers), te.EncoderConfig.tiny(),
                                device="cpu")


def test_text_encoder_truncates(params):
    """Texts longer than max_positions are cut there and right-padded
    batches pool each text alone, as in the JAX CLI's encoder."""
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    p = encoder_params_from_jax(params, cfg, device="cpu")
    encode = te.text_encoder(p, cfg, ByteTokenizer(259), device="cpu")
    long_text = "é" * 50  # 100 bytes, each >= 128, cut to 64 positions
    got = encode([long_text, "ab"])
    ids = np.minimum(list(long_text.encode())[: cfg.max_positions], cfg.vocab_size - 1)
    ref = te.encoder_forward(p, torch.from_numpy(ids[None]).long(), torch.ones((1, len(ids)), dtype=torch.bool), cfg)
    np.testing.assert_allclose(got[:1], ref.numpy(), rtol=1e-6, atol=1e-6)
    assert got.shape == (2, cfg.d_model)


def tiny_f32_encoder(params):
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    return te.text_encoder(encoder_params_from_jax(params, cfg, device="cpu"), cfg,
                           ByteTokenizer(259), device="cpu"), ByteTokenizer(259)


def recorded_forwards(monkeypatch):
    """Each forward's token rows, as ``text_encoder`` hands them over."""
    seen = []
    forward = te.encoder_forward

    def record(p, tokens, mask, cfg):
        seen.append([row[m].tolist() for row, m in zip(tokens, mask)])
        return forward(p, tokens, mask, cfg)

    monkeypatch.setattr(te, "encoder_forward", record)
    return seen


def test_index_build_stores_sorted_batches_in_passage_order(params):
    """A build over four batches of passages in shuffled lengths: each row
    of the index is its passage encoded alone, and the JAX package's index
    of the same passages (its batches cut in passage order), at f32."""
    from probing_rag_tpu.retrieval import dense as jdense
    from probing_rag_tpu_torch.retrieval.dense import DenseIndex
    from test_torch_pipeline import jax_encoder

    encode, _ = tiny_f32_encoder(params)
    lengths = np.random.default_rng(1).permutation(np.arange(2, 46, 4))
    texts = [chr(97 + i) * int(n) for i, n in enumerate(lengths)]
    ix = DenseIndex.build(texts, encode, batch_size=3)
    alone = np.concatenate([encode([t]) for t in texts])
    assert ix.embeddings.shape == (len(texts), 32)
    np.testing.assert_allclose(ix.embeddings, alone, rtol=1e-6, atol=1e-6)
    jcfg = dataclasses.replace(je.EncoderConfig.tiny(), compute_dtype=jnp.float32)
    jix = jdense.DenseIndex.build(texts, jax_encoder(params, jcfg), batch_size=3)
    np.testing.assert_allclose(ix.embeddings, jix.embeddings, rtol=1e-5, atol=1e-5)


def test_text_encoder_sort_is_stable(params, monkeypatch):
    """Longest first, and passages of equal length in the caller's order."""
    encode, tok = tiny_f32_encoder(params)
    seen = recorded_forwards(monkeypatch)
    texts = ["ab", "wxyz", "cd", "q", "ef", "mnop", "gh", "r", "ij"]
    encode(texts, batch_size=4)
    want = [tok.encode(t) for t in ["wxyz", "mnop", "ab", "cd", "ef", "gh", "ij", "q", "r"]]
    assert seen == [want[:4], want[4:8], want[8:]]


@pytest.mark.parametrize("batch_size", [None, 3, 8])
def test_text_encoder_query_batch_is_one_forward_in_caller_order(params, monkeypatch,
                                                                 batch_size):
    """At most ``batch_size`` texts (or none given), as query encoding runs
    them: one forward over all of them, and each embedding at its text's
    place, equal to that text encoded alone."""
    encode, tok = tiny_f32_encoder(params)
    texts = ["a", "a longer query", "mid"]
    alone = np.concatenate([encode([t]) for t in texts])
    seen = recorded_forwards(monkeypatch)
    got = encode(texts, batch_size=batch_size)
    assert len(seen) == 1 and sorted(seen[0]) == sorted(tok.encode(t) for t in texts)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, alone, rtol=1e-6, atol=1e-6)
