"""The port's Gemma forward (probing_rag_tpu_torch.models.gemma) against the
JAX forward, on the tiny Gemma and Mistral configs in float32.

Inputs and parameters are made with numpy from a seed and go through both.
Tolerance: rtol 1e-4 / atol 1e-4 on logits and captures — the same f32
math, with matmul and softmax sums taken in another order by XLA:CPU and
PyTorch's CPU kernels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.weights import lm_params_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("tiny", "tiny_mistral")


def configs(family):
    jcfg = dataclasses.replace(getattr(jg.GemmaConfig, family)(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(getattr(tg.GemmaConfig, family)(), compute_dtype=torch.float32)
    return jcfg, tcfg


def numpy_params(cfg, seed=0):
    """A parameter tree in the JAX layout, drawn with numpy (norm weights
    random too, so the (1 + w) vs w scaling is exercised)."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.n_layers)

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def norm(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    tree = {
        "embed": dense(cfg.vocab_size, d),
        "final_norm": norm(d),
        "layers": {
            "attn_norm": norm(L, d), "wq": dense(L, d, h * hd), "wk": dense(L, d, kv * hd),
            "wv": dense(L, d, kv * hd), "wo": dense(L, h * hd, d), "mlp_norm": norm(L, d),
            "w_gate": dense(L, d, f), "w_up": dense(L, d, f), "w_down": dense(L, f, d),
        },
    }
    if not cfg.tied_head:
        tree["lm_head"] = dense(d, cfg.vocab_size)
    return tree


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def left_padded(cfg, seed=1, b=2, t=10):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, :3] = False  # row 1 is left-padded
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return tokens, valid, positions


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_and_captures_match_jax(family):
    jcfg, tcfg = configs(family)
    tree = numpy_params(jcfg)
    tokens, valid, positions = left_padded(jcfg)
    sites = ((1, "resid_mid"), (2, "resid_post"), (3, "resid_post"))
    j_logits, _, j_caps = jg.forward(
        to_jax(tree), jnp.asarray(tokens), jcfg, capture=jg.CaptureSpec(sites),
        positions=jnp.asarray(positions), attn_valid=jnp.asarray(valid),
    )
    t_logits, _, t_caps = tg.forward(
        lm_params_from_jax(tree, tcfg, device="cpu"), torch.from_numpy(tokens).long(), tcfg,
        capture=tg.CaptureSpec(sites), positions=torch.from_numpy(positions).long(),
        attn_valid=torch.from_numpy(valid),
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_caps.numpy(), np.asarray(j_caps), **TOL)
    # logits_last_only is the last row of the full logits
    last, _, _ = tg.forward(
        lm_params_from_jax(tree, tcfg, device="cpu"), torch.from_numpy(tokens).long(), tcfg,
        positions=torch.from_numpy(positions).long(), attn_valid=torch.from_numpy(valid),
        logits_last_only=True,
    )
    np.testing.assert_allclose(last[:, 0].numpy(), t_logits[:, -1].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_then_cache_append_matches_jax(family):
    """Prefill into a cache, then append one token: logits of both calls and
    the written cache slots agree with the JAX cache path."""
    jcfg, tcfg = configs(family)
    tree = numpy_params(jcfg, seed=2)
    tokens, valid, positions = left_padded(jcfg, seed=3)
    b, t = tokens.shape
    s = t + 4
    slot_valid = np.concatenate([valid, np.ones((b, 4), bool)], axis=1)
    nxt = np.asarray([[5], [7]], np.int32)
    nxt_pos = (valid.sum(1, keepdims=True)).astype(np.int32)

    jp = to_jax(tree)
    jkv = jg.init_kv_cache(jcfg, b, s, dtype=jnp.float32)
    j1, jkv, _ = jg.forward(jp, jnp.asarray(tokens), jcfg, kv_cache=jkv,
                            positions=jnp.asarray(positions), attn_valid=jnp.asarray(slot_valid),
                            logits_last_only=True)
    j2, jkv, j_caps = jg.forward(jp, jnp.asarray(nxt), jcfg, kv_cache=jkv,
                                 positions=jnp.asarray(nxt_pos), attn_valid=jnp.asarray(slot_valid),
                                 capture=jg.CaptureSpec(((1, "resid_post"),)))

    tp = lm_params_from_jax(tree, tcfg, device="cpu")
    tkv = tg.init_kv_cache(tcfg, b, s, dtype=torch.float32, device="cpu")
    t1, tkv, _ = tg.forward(tp, torch.from_numpy(tokens).long(), tcfg, kv_cache=tkv,
                            positions=torch.from_numpy(positions).long(),
                            attn_valid=torch.from_numpy(slot_valid), logits_last_only=True)
    t2, tkv, t_caps = tg.forward(tp, torch.from_numpy(nxt).long(), tcfg, kv_cache=tkv,
                                 positions=torch.from_numpy(nxt_pos).long(),
                                 attn_valid=torch.from_numpy(slot_valid),
                                 capture=tg.CaptureSpec(((1, "resid_post"),)))
    assert tkv["pos"] == int(jkv["pos"]) == t + 1
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), **TOL)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **TOL)
    np.testing.assert_allclose(t_caps.numpy(), np.asarray(j_caps), **TOL)
    # pad slots hold K/V of fully-masked query rows, which nothing reads
    # (their uniform average spans a different key count on each side)
    written = slot_valid.copy()
    written[:, t + 1:] = False
    for name in ("k", "v"):
        got = tkv[name].numpy().transpose(1, 3, 0, 2, 4)[written]
        want = np.asarray(jkv[name]).transpose(1, 3, 0, 2, 4)[written]
        np.testing.assert_allclose(got, want, **TOL)


def test_config_factories_match_jax():
    for family in ("gemma_2b", "mistral_7b", "tiny", "tiny_mistral"):
        j = getattr(jg.GemmaConfig, family)()
        t = getattr(tg.GemmaConfig, family)()
        for f in dataclasses.fields(t):
            if f.name in ("compute_dtype", "resid_dtype"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (family, f.name)
    assert tg.GemmaConfig.gemma_2b().compute_dtype == torch.bfloat16
