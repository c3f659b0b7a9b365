"""The block's elementwise kernels' plain versions (``probing_rag_tpu_torch/
ops/block.py``) on the CPU, where each wrapper takes its plain version (the
kernels, ``kernels/csrc/rms_norm.cu``, ``rope_kv.cu`` and ``gated_act.cu``,
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions), against the JAX functions XLA fuses:

- ``add_rms_norm`` against JAX's ``rms_norm`` (``probing_rag_tpu/models/
  gemma.py:338``) of ``x + delta``, with and without ``plus_one``, with a
  bf16 or f32 delta and without one; the add equal bit for bit.
- ``rope`` against JAX's ``rope`` (``:743``) at head dims 16, 32, 128 and 256
  with left-padded positions, f32 and bf16.
- the cache write of ``rope_qk_cache`` into bf16, f32, int8 and int4 caches
  at T 1 and 5 and a nonzero cursor, against JAX's ``_quant_kv`` /
  ``_quant_kv4`` (``:1156``, ``:1174``) and ``dynamic_update_slice``
  (``:869-906``), element for element; the slots outside the write untouched.
- ``gated_act`` for gelu and silu in bf16 and f32 against ``jax.nn.gelu``
  (tanh form) / ``jax.nn.silu``, evaluated in f32 on the compute-type gate
  and rounded where the port rounds (JAX's CPU backend evaluates a bf16
  gelu op by op in bf16; the port's plain ops, like a fused XLA kernel,
  round once).
- one ``_block`` and one ``forward`` at ``tiny()`` and ``tiny_mistral()``,
  with a cache and without, against JAX's.
- the wrappers' routing: CPU tensors take the plain version without
  touching the kernel library; a bad dtype, shape or stride raises before
  any launch; and the per-element tolerances the card holds the kernels to
  admit the plain version and see a fault.

Tolerances: the norm at ``NORM_REL`` of the value (f32 sums of squares in
another order), through the rounding to the compute type; RoPE at
``ROPE_REL`` (``ops/block.py::rope_tolerance``: XLA's and torch's cos, sin
and pow may differ by ulps); the cache write exact where its input is
(positions 0: the rotation is the identity), the activation at
``gated_tolerance``; the block and the forward at rtol / atol 1e-4 as in
``tests/test_torch_gemma.py`` (f32 products summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.ops import block as bk
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import configs, left_padded, numpy_params, to_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
DTS = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
THETA = 10_000.0


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def within(got: torch.Tensor, ref: torch.Tensor, tol: torch.Tensor) -> None:
    diff = (got.float() - ref.float()).abs()
    bad = diff > tol
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} elements over the bound; "
                                 f"worst {float((diff - tol).max()):.3g} past it")


# ------------------------------------------------------------------- norm


@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("delta", ["none", "bf16", "f32"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_add_rms_norm_matches_jax(plus_one, delta, dt):
    """``(resid, normed)`` against JAX's ``rms_norm(x + delta)`` cast to the
    compute type: resid bit for bit, normed within ``norm_tolerance``."""
    tdt, jdt = DTS[dt]
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    d = None
    if delta != "none":
        d = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32)).to(DTS[delta][0])
    tw = torch.from_numpy(w).to(tdt)
    resid, normed = bk.add_rms_norm(torch.from_numpy(x), tw, 1e-6, plus_one, delta=d, dt=tdt)
    jx = jnp.asarray(x) + (0 if d is None else jnp.asarray(to_np(d)))
    want = jg.rms_norm(jx, jnp.asarray(to_np(tw)), 1e-6, plus_one).astype(jdt)
    np.testing.assert_array_equal(resid.numpy(), np.asarray(jx))
    assert normed.dtype == tdt and normed.shape == (2, 5, 64)
    within(normed, torch.from_numpy(np.asarray(want.astype(jnp.float32))),
           bk.norm_tolerance(resid, tw, 1e-6, plus_one, tdt))


def test_add_rms_norm_without_delta_returns_x():
    x = torch.randn(3, 16)
    resid, _ = bk.add_rms_norm(x, torch.zeros(16), 1e-6, True, dt=torch.float32)
    assert resid is x


# ------------------------------------------------------------------- rope


@pytest.mark.parametrize("hd", [16, 32, 128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_matches_jax(hd, dt):
    """``rope`` (the kernel's plain piece) against JAX's at left-padded
    positions, within ``rope_tolerance``."""
    tdt, jdt = DTS[dt]
    rng = np.random.default_rng(hd)
    b, t, n = 3, 7, 2
    x = torch.from_numpy(rng.standard_normal((b, t, n, hd)).astype(np.float32)).to(tdt)
    valid = np.ones((b, t), bool)
    valid[1, :2] = False
    valid[2, :6] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0) + 40 * np.arange(b)[:, None]
    pos = torch.from_numpy(positions).long()
    got = bk.rope(x, pos, THETA)
    want = jg.rope(jnp.asarray(to_np(x)).astype(jdt), jnp.asarray(positions.astype(np.int32)),
                   THETA)
    assert got.dtype == tdt
    within(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))),
           bk.rope_tolerance(x, pos, THETA))


def test_rope_qk_cache_without_cache():
    """No cache: q rotated, k rotated and v as contiguous [B, KV, T, hd]."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 4, 32), (2, 5, 2, 32), (2, 5, 2, 32)))
    pos = torch.arange(5)[None].expand(2, 5) + 3
    rq, rk, rv, ks, vs = bk.rope_qk_cache(q, k, v, pos, THETA)
    assert ks is None and vs is None
    assert rk.shape == (2, 2, 5, 32) and rk.is_contiguous() and rv.is_contiguous()
    torch.testing.assert_close(rq, bk.rope(q, pos, THETA), rtol=0, atol=0)
    torch.testing.assert_close(rk, bk.rope(k, pos, THETA).transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(rv, v.transpose(1, 2), rtol=0, atol=0)


# ------------------------------------------------------------- cache write

CACHE_KINDS = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32),
               "int8": (torch.int8, jnp.int8), "int4": ("int4", jnp.int4)}


def jax_cache_write(jkv, kind, k_n, v_n, layer, pos):
    """JAX ``_block``'s write of the new tokens' K/V [B, KV, T, hd] into the
    stacked cache at (layer, pos) (``gemma.py:869-906``)."""
    at_kv, at_sc = (layer, 0, 0, pos, 0), (layer, 0, 0, pos)
    out = dict(jkv)
    dus = jax.lax.dynamic_update_slice
    if kind == "int4":
        for name, x in (("k", k_n), ("v", v_n)):
            q, s = jg._quant_kv4(x)
            bm, kvm, tm, gm = s.shape
            out[name] = dus(jkv[name], q[None], at_kv)
            out[f"{name}_scale"] = dus(jkv[f"{name}_scale"],
                                       jnp.swapaxes(s, -1, -2).reshape(bm, kvm * gm, tm)[None],
                                       at_sc)
    elif kind == "int8":
        for name, x in (("k", k_n), ("v", v_n)):
            q, s = jg._quant_kv(x)
            out[name] = dus(jkv[name], q[None], at_kv)
            out[f"{name}_scale"] = dus(jkv[f"{name}_scale"], s[..., 0][None], at_sc)
    else:
        for name, x in (("k", k_n), ("v", v_n)):
            out[name] = dus(jkv[name], x[None].astype(jkv[name].dtype), at_kv)
    return out


@pytest.mark.parametrize("kind", list(CACHE_KINDS))
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 128])
def test_cache_write_matches_jax(kind, t, dt, hd):
    """``rope_qk_cache`` into every cache type at cursor 6 of 16 slots,
    layer 1 of 2, element for element against JAX's quantizers and
    ``dynamic_update_slice`` (at position 0 the rotation is the identity, so
    the values written are the inputs'); the returned views are the layer,
    and no other slot changes."""
    tdt, jdt = DTS[dt]
    tkind, jkind = CACHE_KINDS[kind]
    b, h, kvh, s, pos, layer = 2, 4, 2, 16, 6, 1
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(), n_layers=2, n_heads=h, n_kv_heads=kvh,
                              head_dim=hd)
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), n_layers=2, n_heads=h, n_kv_heads=kvh,
                               head_dim=hd)
    rng = np.random.default_rng(t * 100 + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(tdt)
               for sh in ((b, t, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
    k[0, 0, 0] = 0.0  # an all-zero row: scale 1
    kv = tg.init_kv_cache(cfg, b, s, tkind, device="cpu")
    before = {name: x.clone() for name, x in kv.items()}
    positions = torch.zeros((b, t), dtype=torch.int64)
    rq, rk, rv, ks, vs = bk.rope_qk_cache(q, k, v, positions, THETA,
                                          cache=(kv, layer, torch.tensor(pos)))
    assert rk.data_ptr() == kv["k"][layer].data_ptr() and rv.data_ptr() == kv["v"][layer].data_ptr()
    if kind in ("int8", "int4"):
        assert ks.data_ptr() == kv["k_scale"][layer].data_ptr()
    else:
        assert ks is None and vs is None
    torch.testing.assert_close(rq, q, rtol=0, atol=0)  # position 0: identity

    jkv = jg.init_kv_cache(jcfg, b, s, jkind)
    k_n = jnp.swapaxes(jnp.asarray(to_np(k)).astype(jdt), 1, 2)
    v_n = jnp.swapaxes(jnp.asarray(to_np(v)).astype(jdt), 1, 2)
    want = jax_cache_write(jkv, kind, k_n, v_n, layer, pos)
    for name in kv:
        if name == "pos":
            continue
        got = kv[name]
        if kind == "int4" and name in ("k", "v"):
            got = at.unpack_int4(got)
        want_np = np.asarray(want[name].astype(jnp.float32))
        if kind == "int4" and name in ("k", "v"):  # an empty packed slot unpacks to -8
            got, want_np = got[layer, :, :, pos:pos + t], want_np[layer, :, :, pos:pos + t]
        np.testing.assert_array_equal(got.float().numpy(), want_np, err_msg=name)
        changed = kv[name] != before[name]  # [L, B, rows, S, ..]
        outside = torch.ones(s, dtype=torch.bool)
        outside[pos:pos + t] = False
        assert not bool(changed[:, :, :, outside].any()), f"{name}: a slot outside the write changed"
        assert not bool(changed[0].any()), f"{name}: another layer changed"


def test_cache_write_rotates_k():
    """At nonzero positions the cache holds the rotated k (quantized as
    ``quant_kv`` quantizes it) and the unrotated v."""
    rng = np.random.default_rng(5)
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(), n_layers=1)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((2, 3, 2, 32), (2, 3, 1, 32), (2, 3, 1, 32)))
    kv = tg.init_kv_cache(cfg, 2, 8, torch.int8, device="cpu")
    pos = torch.tensor([[4, 5, 6], [0, 1, 2]])
    bk.rope_qk_cache(q, k, v, pos, THETA, cache=(kv, 0, torch.tensor(2)))
    qk, sk = at.quant_kv(bk.rope(k, pos, THETA).transpose(1, 2))
    qv, sv = at.quant_kv(v.transpose(1, 2))
    torch.testing.assert_close(kv["k"][0, :, :, 2:5], qk, rtol=0, atol=0)
    torch.testing.assert_close(kv["v"][0, :, :, 2:5], qv, rtol=0, atol=0)
    torch.testing.assert_close(kv["k_scale"][0, :, :, 2:5], sk[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(kv["v_scale"][0, :, :, 2:5], sv[..., 0], rtol=0, atol=0)


# ------------------------------------------------------------- activation


@pytest.mark.parametrize("activation", ["gelu", "silu"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gated_act_matches_jax(activation, dt):
    """``act(gate) * up`` against JAX's activation evaluated in f32 on the
    compute-type gate, rounded to the compute type, times up in it: within
    ``gated_tolerance`` (bit-equal at bf16 wherever act does not lie
    within its bound of a rounding midpoint)."""
    tdt, jdt = DTS[dt]
    rng = np.random.default_rng(1)
    g = torch.from_numpy((2.5 * rng.standard_normal((6, 256))).astype(np.float32)).to(tdt)
    u = torch.from_numpy(rng.standard_normal((6, 256)).astype(np.float32)).to(tdt)
    jgate = jnp.asarray(to_np(g))
    fn = (lambda x: jax.nn.gelu(x, approximate=True)) if activation == "gelu" else jax.nn.silu
    want = (fn(jgate).astype(jdt) * jnp.asarray(to_np(u)).astype(jdt)).astype(jnp.float32)
    got = bk.gated_act(g, u, activation)
    assert got.dtype == tdt
    within(got, torch.from_numpy(np.asarray(want)), bk.gated_tolerance(g, u, activation))


# ---------------------------------------------------------- block, forward


def jax_mask(smask):
    return jnp.asarray(at.structured_mask(*smask).numpy())


@pytest.mark.parametrize("family", ["tiny", "tiny_mistral"])
@pytest.mark.parametrize("cache", ["none", "int8"])
def test_block_matches_jax(family, cache):
    """One ``_block`` against JAX's: the residual input given as x + delta
    (the fold of the previous block's add), resid_mid and resid_post =
    resid_mid + mlp_out within 1e-4, and with a cache the written slots
    equal."""
    jcfg, tcfg = configs(family)
    tree = numpy_params(jcfg, seed=8)
    lp_np = {k: v[2] for k, v in tree["layers"].items()}
    tlp = {k: torch.from_numpy(v) for k, v in lp_np.items()}
    jlp = {k: jnp.asarray(v) for k, v in lp_np.items()}
    rng = np.random.default_rng(9)
    b, t, d = 2, 6, tcfg.d_model
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    delta = rng.standard_normal((b, t, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t) + 3, (b, t)).astype(np.int64)
    tpos = torch.from_numpy(pos)
    if cache == "none":
        smask = (tpos, tpos, None)
        tcache = jcache = None
    else:
        s = t + 5
        kv = tg.init_kv_cache(tcfg, b, s, torch.int8, device="cpu")
        jkv = jg.init_kv_cache(jcfg, b, s, jnp.int8)
        slots = torch.arange(t)[None].expand(b, t) + 2
        smask = (slots, torch.arange(s)[None].expand(b, s), None)
        tcache = (kv, 2, torch.tensor(2))
        jcache = (jkv["k"], jkv["v"], jkv["k_scale"], jkv["v_scale"], 2, 2)
    mask = at.structured_mask(*smask)
    resid_in, resid_mid, mlp_out, _ = tg._block(tlp, torch.from_numpy(x), tpos, mask, tcfg, tcache,
                                                smask=smask, delta=torch.from_numpy(delta))
    j_mid, j_post, j_cache, _ = jg._block(jlp, jnp.asarray(x + delta), jnp.asarray(pos),
                                          jnp.asarray(mask.numpy()), jcfg, jcache)
    np.testing.assert_array_equal(resid_in.numpy(), x + delta)
    np.testing.assert_allclose(resid_mid.numpy(), np.asarray(j_mid), **TOL)
    np.testing.assert_allclose((resid_mid + mlp_out).numpy(), np.asarray(j_post), **TOL)
    if cache != "none":
        jk, jv, jks, jvs = j_cache
        for name, want in (("k", jk), ("v", jv), ("k_scale", jks), ("v_scale", jvs)):
            got = kv[name][2].float().numpy()
            want = np.asarray(want[2].astype(jnp.float32))
            if name in ("k", "v"):  # int8 values of rotated keys: an ulp of rope may flip one
                assert np.abs(got - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("family", ["tiny", "tiny_mistral"])
@pytest.mark.parametrize("cache", ["none", "bf16"])
def test_forward_folds_the_last_add_into_the_final_norm(family, cache):
    """``forward`` against JAX's with the last layer's resid_post captured
    and ``logits_last_only`` (the final norm adds the last block's MLP
    output; here over all rows, since the capture needs them), with a
    cache and without: logits and captures within 1e-4."""
    jcfg, tcfg = configs(family)
    tree = numpy_params(jcfg, seed=11)
    tokens, valid, positions = left_padded(jcfg, seed=12)
    sites = ((0, "resid_post"), (1, "resid_mid"), (jcfg.n_layers - 1, "resid_post"))
    b, t = tokens.shape
    kw_j = dict(positions=jnp.asarray(positions), capture=jg.CaptureSpec(sites),
                logits_last_only=True)
    kw_t = dict(positions=torch.from_numpy(positions).long(), capture=tg.CaptureSpec(sites),
                logits_last_only=True)
    if cache == "none":
        kw_j["attn_valid"], kw_t["attn_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    else:
        s = t + 3
        sv = np.concatenate([valid, np.ones((b, 3), bool)], axis=1)
        kw_j.update(attn_valid=jnp.asarray(sv), kv_cache=jg.init_kv_cache(jcfg, b, s))
        kw_t.update(attn_valid=torch.from_numpy(sv),
                    kv_cache=tg.init_kv_cache(tcfg, b, s, torch.bfloat16, device="cpu"))
    j_logits, _, j_caps = jg.forward(to_jax(tree), jnp.asarray(tokens), jcfg, **kw_j)
    t_logits, _, t_caps = tg.forward(lm_params_from_jax(tree, tcfg, device="cpu"),
                                     torch.from_numpy(tokens).long(), tcfg, **kw_t)
    assert t_logits.shape == (b, 1, tcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_caps.numpy(), np.asarray(j_caps), **TOL)


def test_forward_bf16_decode_matches_jax():
    """A bf16 prefill into an int4 cache, then one decode step, at ``tiny()``
    (XLA's CPU backend has no bf16 dot for tiny_mistral's grouped heads):
    the step's logits within 0.1 of JAX's largest (the products and the
    cache in bf16 / int4 on both sides, rounded in other places)."""
    jcfg, tcfg = configs("tiny")
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    tree = numpy_params(jcfg, seed=13)
    tokens, valid, positions = left_padded(jcfg, seed=14)
    b, t = tokens.shape
    s = t + 2
    sv = np.concatenate([valid, np.ones((b, 2), bool)], axis=1)
    jp, tp = to_jax(tree), lm_params_from_jax(tree, tcfg, device="cpu")
    jkv = jg.init_kv_cache(jcfg, b, s, jnp.int4)
    tkv = tg.init_kv_cache(tcfg, b, s, "int4", device="cpu")
    _, jkv, _ = jg.forward(jp, jnp.asarray(tokens), jcfg, kv_cache=jkv,
                           positions=jnp.asarray(positions), attn_valid=jnp.asarray(sv))
    _, tkv, _ = tg.forward(tp, torch.from_numpy(tokens).long(), tcfg, kv_cache=tkv,
                           positions=torch.from_numpy(positions).long(),
                           attn_valid=torch.from_numpy(sv))
    nxt = np.asarray([[3], [9]], np.int32)
    npos = valid.sum(1, keepdims=True).astype(np.int32)
    jl, _, _ = jg.forward(jp, jnp.asarray(nxt), jcfg, kv_cache=jkv, positions=jnp.asarray(npos),
                          attn_valid=jnp.asarray(sv))
    tl, _, _ = tg.forward(tp, torch.from_numpy(nxt).long(), tcfg, kv_cache=tkv,
                          positions=torch.from_numpy(npos).long(),
                          attn_valid=torch.from_numpy(sv))
    jl = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0, atol=0.1 * np.abs(jl).max())


# ---------------------------------------------------------------- routing


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors no wrapper touches the kernel library or counts a
    launch."""

    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    x = torch.randn(4, 64)
    bk.add_rms_norm(x, torch.zeros(64), 1e-6, True, delta=torch.randn(4, 64), dt=torch.bfloat16)
    q, k, v = torch.randn(1, 2, 2, 32), torch.randn(1, 2, 1, 32), torch.randn(1, 2, 1, 32)
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(), n_layers=1)
    kv = tg.init_kv_cache(cfg, 1, 4, torch.int8, device="cpu")
    bk.rope_qk_cache(q, k, v, torch.zeros(1, 2, dtype=torch.int64), THETA,
                     cache=(kv, 0, torch.tensor(0)))
    bk.gated_act(torch.randn(3, 8), torch.randn(3, 8), "silu")
    assert all(kernels.LAUNCHES[n] == 0 for n in ("rms_norm", "rope_kv", "gated_act"))


def _bad_norm_calls():
    x, w = torch.randn(4, 64), torch.zeros(64)
    return {
        "bf16 x": lambda: bk.add_rms_norm(x.bfloat16(), w, 1e-6, dt=torch.bfloat16),
        "weight shape": lambda: bk.add_rms_norm(x, torch.zeros(32), 1e-6, dt=torch.bfloat16),
        "f16 out": lambda: bk.add_rms_norm(x, w, 1e-6, dt=torch.float16),
        "delta shape": lambda: bk.add_rms_norm(x, w, 1e-6, delta=torch.randn(4, 32)),
        "delta stride": lambda: bk.add_rms_norm(x, w, 1e-6, delta=torch.randn(64, 4).T),
        "x stride": lambda: bk.add_rms_norm(torch.randn(64, 4).T, w, 1e-6),
        "device": lambda: bk.add_rms_norm(x.to("meta"), w.to("meta"), 1e-6),
    }


def _bad_rope_calls():
    q, k, v = torch.randn(1, 2, 2, 32), torch.randn(1, 2, 1, 32), torch.randn(1, 2, 1, 32)
    pos = torch.zeros(1, 2, dtype=torch.int64)
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(), n_layers=1)
    kv = tg.init_kv_cache(cfg, 1, 4, torch.int8, device="cpu")
    other = tg.init_kv_cache(dataclasses.replace(cfg, n_kv_heads=2, n_heads=2), 1, 4, torch.int8,
                             device="cpu")
    return {
        "int32 positions": lambda: bk.rope_qk_cache(q, k, v, pos.int(), THETA),
        "positions shape": lambda: bk.rope_qk_cache(q, k, v, pos[:, :1], THETA),
        "k shape": lambda: bk.rope_qk_cache(q, torch.randn(1, 2, 1, 16), v, pos, THETA),
        "dtypes": lambda: bk.rope_qk_cache(q, k.bfloat16(), v, pos, THETA),
        "q stride": lambda: bk.rope_qk_cache(torch.randn(1, 2, 32, 2).transpose(2, 3), k, v,
                                             pos, THETA),
        "cache heads": lambda: bk.rope_qk_cache(q, k, v, pos, THETA,
                                                cache=(other, 0, torch.tensor(0))),
        "cursor": lambda: bk.rope_qk_cache(q, k, v, pos, THETA, cache=(kv, 0, torch.tensor([0]))),
    }


def _bad_gated_calls():
    g = torch.randn(3, 8)
    return {
        "dtypes": lambda: bk.gated_act(g, g.bfloat16(), "gelu"),
        "shapes": lambda: bk.gated_act(g, torch.randn(3, 4), "gelu"),
        "activation": lambda: bk.gated_act(g, g, "relu"),
        "stride": lambda: bk.gated_act(torch.randn(8, 3).T, g, "gelu"),
        "int": lambda: bk.gated_act(g.int(), g.int(), "silu"),
    }


BAD = {**{f"norm {k}": k for k in _bad_norm_calls()}, **{f"rope {k}": k for k in _bad_rope_calls()},
       **{f"gated {k}": k for k in _bad_gated_calls()}}


@pytest.mark.parametrize("case", list(BAD))
def test_wrappers_refuse_what_no_version_takes(case, monkeypatch):
    """A bad dtype, shape, stride or device raises before either version
    runs (the checks come first on every device): no launch is counted
    and the library is not loaded."""

    def no_library():
        raise AssertionError("the kernel library was loaded for a call that must raise")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    family = case.split()[0]
    calls = {"norm": _bad_norm_calls, "rope": _bad_rope_calls, "gated": _bad_gated_calls}[family]()
    with pytest.raises((TypeError, ValueError)):
        calls[BAD[case]]()
    assert all(kernels.LAUNCHES[n] == 0 for n in ("rms_norm", "rope_kv", "gated_act"))


# --------------------------------------------------------- the tolerances


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_norm_tolerance_sees_a_dropped_plus_one(dt):
    """The plain version is within its own bound; the norm with (1 + w)
    taken as w, and the norm of x without the delta's add, exceed it, and
    at bf16 most elements must be bit-equal."""
    tdt = DTS[dt][0]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 2048)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((8, 2048)).astype(np.float32)).to(tdt)
    w = torch.from_numpy((0.1 * rng.standard_normal(2048)).astype(np.float32)).to(tdt)
    resid, normed = bk.add_rms_norm(x, w, 1e-6, True, delta=d, dt=tdt)
    tol = bk.norm_tolerance(resid, w, 1e-6, True, tdt)
    within(normed, normed, tol)
    dropped = bk.rms_norm(resid, w, 1e-6, False).to(tdt)
    no_add = bk.rms_norm(x, w, 1e-6, True).to(tdt)
    for fault in (dropped, no_add):
        assert int(((fault.float() - normed.float()).abs() > tol).sum()) > 1000
    if tdt == torch.bfloat16:
        assert float((tol == 0).float().mean()) > 0.9  # most elements must be bit-equal


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_gated_tolerance_sees_a_skipped_rounding(activation):
    """At bf16 the activation left unrounded before the product exceeds the
    bound, which is 0 for nine elements in ten or more; at f32 gate and up
    swapped do."""
    rng = np.random.default_rng(4)
    g32 = torch.from_numpy((2 * rng.standard_normal((64, 512))).astype(np.float32))
    u32 = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    fn = torch.nn.functional.gelu if activation == "gelu" else torch.nn.functional.silu
    kw = {"approximate": "tanh"} if activation == "gelu" else {}
    for tdt in (torch.bfloat16, torch.float32):
        g, u = g32.to(tdt), u32.to(tdt)
        ref = bk.gated_act(g, u, activation)
        tol = bk.gated_tolerance(g, u, activation)
        if tdt == torch.bfloat16:
            fault = (fn(g.float(), **kw) * u.float()).to(tdt)
            assert float((tol == 0).float().mean()) > 0.9
        else:
            fault = bk.gated_act(u, g, activation)
        assert int(((fault.float() - ref.float()).abs() > tol).sum()) > 100


def test_rope_tolerance_sees_a_wrong_rotation():
    """Interleaved pairs (2i, 2i + 1) in place of split halves, or the
    position off by one, exceed the rope bound."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 128)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9) * 50
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        ref = bk.rope(xd, pos, THETA)
        tol = bk.rope_tolerance(xd, pos, THETA)
        inter = bk.rope(xd.reshape(2, 9, 4, 64, 2).transpose(-1, -2).reshape(2, 9, 4, 128), pos,
                        THETA)
        inter = inter.reshape(2, 9, 4, 2, 64).transpose(-1, -2).reshape(2, 9, 4, 128)
        shifted = bk.rope(xd, pos + 1, THETA)
        for fault in (inter, shifted):
            assert int(((fault.float() - ref.float()).abs() > tol).sum()) > 100
