"""Quantized LM serving in the port (probing_rag_tpu_torch.models.gemma)
against the JAX package on the CPU, at tiny width.

- ``quantize_lm_params`` (int8, grouped int4, rank-1 int4, int4 embedding)
  on a converted JAX tree: the int8 values and packed nibbles equal byte for
  byte, the f32 scales within 1e-6 relative (the same f32 divisions and
  maxima; the tolerance only covers a differently fused division).
- The int4 KV quantizer (``ops/attention.py``) at head_dim 32, 128 and
  256 (1, 4 and 8 groups) against JAX's ``_quant_kv4`` / ``_dequant_kv4``
  and a numpy oracle of the group rule, and the int8 KV quantizer against
  ``_quant_kv``.
- The quantized forward (int8; int8 + ``act_int8_rows``; grouped int4 in
  both of its forms; rank-1 int4 with and without w4a8) on the same
  quantized tree, f32 compute: logits within 1e-4 (sums in another order).
- Incremental decode over an int8 and an int4 KV cache: logits within 1e-4
  of JAX, and JAX's own drift bounds against the full forward
  (``tests/test_gemma.py``: int8 within 5% of the logit scale with argmax
  equal, int4 within 35%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import configs, left_padded, numpy_params, to_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SCHEMES = {
    "int8": dict(bits=8),
    "int4_grouped": dict(bits=4),
    "int4_rank1": dict(bits=4, int4_scheme="rank1"),
    "int4_rank1_embed4": dict(bits=4, int4_scheme="rank1", embed_bits=4),
}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_same_quantized(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) else got[name]
        assert g.shape == w.shape, name
        if w.dtype in (np.int8, np.uint8):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("family", ["tiny", "tiny_mistral"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_quantize_lm_params_matches_jax(family, scheme):
    jcfg, tcfg = configs(family)
    tree = numpy_params(jcfg, seed=11)
    want = to_numpy(jg.quantize_lm_params(to_jax(tree), **SCHEMES[scheme]))
    got = tg.quantize_lm_params(lm_params_from_jax(tree, tcfg, device="cpu"), **SCHEMES[scheme])
    assert_same_quantized(got, want)
    # and the JAX tree converts into the port by copy
    assert_same_quantized(lm_params_from_jax(want, tcfg, device="cpu"), want)


def test_quantize_rejects_what_jax_rejects():
    _, tcfg = configs("tiny")
    params = lm_params_from_jax(numpy_params(configs("tiny")[0]), tcfg, device="cpu")
    for kw in (dict(bits=3), dict(bits=8, embed_bits=4), dict(bits=4, int4_scheme="x"),
               dict(bits=4, group_size=48)):
        with pytest.raises(ValueError):
            tg.quantize_lm_params(params, **kw)


def test_lm_params_from_jax_checks_quantized_shapes():
    jcfg, tcfg = configs("tiny")
    q = to_numpy(jg.quantize_lm_params(to_jax(numpy_params(jcfg)), bits=4))
    wq = dict(q["layers"]["wq"], gs=q["layers"]["wq"]["gs"][..., :-1])  # one column short
    bad = dict(q, layers=dict(q["layers"], wq=wq))
    with pytest.raises(ValueError, match="layers/wq/gs"):
        lm_params_from_jax(bad, tcfg, device="cpu")
    bad = dict(q, embed={"q": q["embed"]["q"].astype(np.int16), "s": q["embed"]["s"]})
    with pytest.raises(ValueError, match="embed/q"):
        lm_params_from_jax(bad, tcfg, device="cpu")


def test_int4_pack_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(3, 5, 8)).astype(np.int8)
    packed = at.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jg._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(at.unpack_int4(packed).numpy(), q)


def kv4_oracle(x, group):
    """numpy group rule: one max-abs / 7 scale per ``group`` lanes (1 where
    the group is all zero), values rounded half to even into [-7, 7]."""
    xg = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
    s = np.abs(xg).max(-1) / np.float32(7.0)
    s = np.where(s == 0, np.float32(1.0), s).astype(np.float32)
    q = np.clip(np.round(xg / s[..., None]), -7, 7)
    return q.reshape(x.shape).astype(np.int8), s


@pytest.mark.parametrize("head_dim", [32, 128, 256])
def test_kv4_quantizer_matches_jax_and_oracle(head_dim):
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 3, 5, head_dim)).astype(np.float32)
    x[0, 0, 0, :32] = 0.0  # an all-zero group takes scale 1
    q, s = at.quant_kv4(torch.from_numpy(x))
    groups = head_dim // 32
    assert s.shape == (2, 3, 5, groups)
    oq, os_ = kv4_oracle(x, 32)
    np.testing.assert_array_equal(q.numpy(), oq)
    np.testing.assert_array_equal(s.numpy(), os_)
    jq, js = jg._quant_kv4(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the merged [.., KV*G, S] scale store, dequantized
    s_m = s.transpose(-1, -2).reshape(2, 3 * groups, 5)
    back = at.dequant_kv4(q, s_m, torch.float32).numpy()
    want = np.asarray(jg._dequant_kv4(jq, jnp.asarray(s_m.numpy()), jnp.float32))
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(back, (oq.reshape(2, 3, 5, groups, 32) * os_[..., None])
                                  .reshape(x.shape))
    assert np.all(np.abs(back - x) <= np.repeat(os_, 32, axis=-1) * 0.5 + 1e-6)


def test_kv8_quantizer_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 1, 7, 32)).astype(np.float32)
    q, s = at.quant_kv(torch.from_numpy(x))
    jq, js = jg._quant_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


FORWARDS = [
    ("int8", dict(bits=8), 0),
    ("int8_act8", dict(bits=8), 16),
    ("int4_grouped", dict(bits=4), 0),
    ("int4_rank1", dict(bits=4, int4_scheme="rank1"), 0),
    ("int4_rank1_act8", dict(bits=4, int4_scheme="rank1"), 16),
    ("int4_rank1_embed4", dict(bits=4, int4_scheme="rank1", embed_bits=4), 0),
]


@pytest.mark.parametrize("family", ["tiny", "tiny_mistral"])
@pytest.mark.parametrize("name,scheme,act8", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_quantized_forward_matches_jax(family, name, scheme, act8):
    """The same quantized tree through both forwards; 20 activation rows,
    so ``act_int8_rows`` 16 takes w8a8 / w4a8 on every product."""
    jcfg, tcfg = configs(family)
    jcfg = dataclasses.replace(jcfg, act_int8_rows=act8)
    tcfg = dataclasses.replace(tcfg, act_int8_rows=act8)
    qtree = to_numpy(jg.quantize_lm_params(to_jax(numpy_params(jcfg, seed=12)), **scheme))
    tokens, valid, positions = left_padded(jcfg, seed=13)
    sites = jg.CaptureSpec(((1, "resid_post"),))
    j_logits, _, j_caps = jg.forward(to_jax(qtree), jnp.asarray(tokens), jcfg, capture=sites,
                                     positions=jnp.asarray(positions),
                                     attn_valid=jnp.asarray(valid))
    t_logits, _, t_caps = tg.forward(lm_params_from_jax(qtree, tcfg, device="cpu"),
                                     torch.from_numpy(tokens).long(), tcfg,
                                     capture=tg.CaptureSpec(((1, "resid_post"),)),
                                     positions=torch.from_numpy(positions).long(),
                                     attn_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_caps.numpy(), np.asarray(j_caps), **TOL)


def test_grouped_int4_dequant_form_matches_jax():
    """Past ``_INT4_DEQUANT_ROWS`` (1024) activation rows grouped int4
    multiplies by a transient dequantized weight."""
    jcfg, tcfg = configs("tiny")
    qtree = to_numpy(jg.quantize_lm_params(to_jax(numpy_params(jcfg, seed=14)), bits=4))
    tokens = np.random.default_rng(15).integers(0, jcfg.vocab_size, size=(2, 520)).astype(np.int32)
    assert tokens.size > tg._INT4_DEQUANT_ROWS == jg._INT4_DEQUANT_ROWS
    j_logits, _, _ = jg.forward(to_jax(qtree), jnp.asarray(tokens), jcfg)
    t_logits, _, _ = tg.forward(lm_params_from_jax(qtree, tcfg, device="cpu"),
                                torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


def incremental(forward_fn, init_cache, params, tokens, cfg, dtype, to_tokens):
    """Prefill 6 tokens into a cache, then 4 single-token steps; the
    concatenated logits."""
    kv = init_cache(cfg, tokens.shape[0], tokens.shape[1], dtype)
    logits, kv, _ = forward_fn(params, to_tokens(tokens[:, :6]), cfg, kv_cache=kv)
    outs = [np.asarray(logits)]
    for i in range(6, tokens.shape[1]):
        step, kv, _ = forward_fn(params, to_tokens(tokens[:, i : i + 1]), cfg, kv_cache=kv)
        outs.append(np.asarray(step))
    return np.concatenate(outs, axis=1), kv


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quantized_kv_cache_matches_jax(kv):
    """JAX's drift fixture (tests/test_gemma.py: init_params(PRNGKey(0)),
    tokens from PRNGKey(3)) through both caches."""
    jcfg, tcfg = configs("tiny")
    params = jg.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 10), 0, jcfg.vocab_size))
    ref = np.asarray(jg.forward(params, jnp.asarray(tokens), jcfg)[0])
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.int4, "int4")
    j_inc, j_kv = incremental(jg.forward, jg.init_kv_cache, params, tokens, jcfg, jdt, jnp.asarray)
    t_inc, t_kv = incremental(
        tg.forward, lambda c, b, s, d: tg.init_kv_cache(c, b, s, d, device="cpu"),
        lm_params_from_jax(to_numpy(params), tcfg, device="cpu"), tokens, tcfg, tdt,
        lambda a: torch.from_numpy(a).long())
    np.testing.assert_allclose(t_inc, j_inc, **TOL)
    for name in ("k_scale", "v_scale"):
        assert tuple(t_kv[name].shape) == tuple(j_kv[name].shape), name
        np.testing.assert_allclose(t_kv[name].numpy(), np.asarray(j_kv[name]), **TOL)
    if kv == "int4":  # a quarter of a bf16 cache: uint8 [L, B, KV, S, hd/2]
        assert t_kv["k"].dtype == torch.uint8
        assert tuple(t_kv["k"].shape) == (*j_kv["k"].shape[:-1], jcfg.head_dim // 2)
    drift = np.max(np.abs(t_inc - ref)) / np.max(np.abs(ref))
    if kv == "int8":
        assert drift < 0.05
        np.testing.assert_array_equal(np.argmax(ref, -1), np.argmax(t_inc, -1))
    else:
        assert drift < 0.35


def test_kv4_cache_layout_at_head_dim_256():
    """Gemma-2B's head_dim 256 stores 8 scale groups per kv head, merged
    into [L, B, KV*G, S] as in JAX."""
    cfg = tg.GemmaConfig.gemma_2b()
    kv = tg.init_kv_cache(dataclasses.replace(cfg, n_layers=2), 3, 7, "int4", device="cpu")
    jkv = jg.init_kv_cache(dataclasses.replace(jg.GemmaConfig.gemma_2b(), n_layers=2), 3, 7,
                           jnp.int4)
    assert tuple(kv["k_scale"].shape) == tuple(jkv["k_scale"].shape) == (2, 3, 8, 7)
    assert tuple(kv["k"].shape) == (2, 3, 1, 7, 128) and kv["k"].dtype == torch.uint8
