"""The port's decode attention (``probing_rag_tpu_torch/ops/attention.py``)
against the JAX package on the CPU, where ``decode_attention`` takes its
plain version (the kernel runs only on the card, where ``chip_smoke.py``
phase 9 holds it to this plain version).

- ``decode_attention`` over one cache layer against JAX's ``_attention``
  (``probing_rag_tpu/models/gemma.py:787``, reaching ``_attn_core``
  ``:755``) over the same stored cache dequantized as JAX's ``_block``
  dequantizes it: f32, bf16, int8 and int4 caches, f32 and bf16 compute,
  T 1 (a decode step) and 5 (a verify round), MQA and H = KV, on rows with
  left pads and a row whose every slot is masked (the mean over all slots).
- The forward's routing: decode steps and verify rounds go through it
  (bf16 and f32), ``attn_probs_layer`` does not, bf16 prefill and the
  no-cache forward go through ``prefill_attention``, f32 prefill through
  the plain ops; a tiny f32 model's generations through it equal JAX's for
  each cache type.
- The split plan of the kernel.

Tolerances: f32 compute at 1e-5 (the same f32 math, sums in another
order). bf16 compute element by element at ``rounding_tolerance``: both
round their f32 probabilities to bf16, and only a probability within 1e-5
of itself of a rounding midpoint may land on the neighbouring bf16 value
(one bf16 step times |v| for each such slot, plus 1e-5 of the sum of
|p v|). The tolerance is checked to see what it must: probabilities left
unrounded and a few slots dropped both exceed it.
"""

import dataclasses
import functools

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
from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

KINDS = ["f32", "bf16", "int8", "int4"]
DTS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def cache_case(kind: str, t: int, h: int, kvh: int, seed: int = 0, b: int = 3, s: int = 40,
               hd: int = 64):
    """numpy inputs of one case: q [B, T, H, hd], K/V [B, KV, S, hd] f32
    before storing, and the decode mask of the cursor at the last t slots,
    row 1 left-padded by 11 slots and row 2 all pad."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    kv = rng.standard_normal((2, b, kvh, s, hd)).astype(np.float32)
    slot = np.arange(s)
    valid = np.ones((b, s), bool)
    valid[1, :11] = False
    valid[2] = False
    causal = slot[None, :] <= (s - t + np.arange(t))[:, None]
    mask = (valid[:, None, :] & causal[None])[:, None]
    return q, kv, mask


def stored(kind: str, kv: np.ndarray):
    """The cache as JAX's ``_block`` stores it, from JAX's own quantizers:
    (JAX k, v, k_scale, v_scale) and the port's (int4 nibble-packed)."""
    if kind in ("f32", "bf16"):
        jdt, tdt = DTS[kind]
        j = [jnp.asarray(x, jdt) for x in kv]
        return (*j, None, None), (*(torch.from_numpy(x).to(tdt) for x in kv), None, None)
    if kind == "int8":
        jq, js = jg._quant_kv(jnp.asarray(kv))  # scales [2, B, KV, S, 1]
        js = js[..., 0]
        tq = torch.from_numpy(np.asarray(jq))
        ts = torch.from_numpy(np.asarray(js))
        return (jq[0], jq[1], js[0], js[1]), (tq[0], tq[1], ts[0], ts[1])
    jq, js = jg._quant_kv4(jnp.asarray(kv))  # int4 values, scales [2, B, KV, S, G]
    two, b, kvh, s, g = js.shape
    js = jnp.swapaxes(js, -1, -2).reshape(two, b, kvh * g, s)  # the merged store
    tq = at.pack_int4(torch.from_numpy(np.asarray(jq).astype(np.int8)))
    ts = torch.from_numpy(np.asarray(js)).contiguous()
    return (jq[0], jq[1], js[0], js[1]), (tq[0], tq[1], ts[0], ts[1])


# jitted: the CPU runtime has no eager bf16 x bf16 -> f32 dot
JAX_ATTENTION = jax.jit(functools.partial(jg._attention, kv_major=True))


def jax_reference(kind, jstore, q, mask, jdt):
    """JAX's ``_block`` dequantize, then ``_attention`` over the kv-major
    cache, one kv head (and its query heads) at a time: the heads attend
    independently, and the CPU backend refuses the bf16 products of more
    than one kv head at T > 1."""
    k, v, ks, vs = jstore
    if kind == "int8":
        k = k.astype(jdt) * ks[..., None].astype(jdt)
        v = v.astype(jdt) * vs[..., None].astype(jdt)
    elif kind == "int4":
        k, v = jg._dequant_kv4(k, ks, jdt), jg._dequant_kv4(v, vs, jdt)
    kvh = k.shape[1]
    g = q.shape[2] // kvh
    qj, k, v, mj = jnp.asarray(q, jdt), k.astype(jdt), v.astype(jdt), jnp.asarray(mask)
    out = [JAX_ATTENTION(qj[:, :, i * g:(i + 1) * g], k[:, i:i + 1], v[:, i:i + 1], mj)[0]
           for i in range(kvh)]
    return np.concatenate([np.asarray(o) for o in out], axis=-1), float(jnp.abs(v).max())


CASES = [(kind, dt) for kind in KINDS for dt in ("f32", "bf16")
         if not (kind == "bf16" and dt == "f32") and not (kind == "f32" and dt == "bf16")]


@pytest.mark.parametrize("heads", [(4, 1), (2, 2)], ids=["mqa", "mha"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("kind,dt", CASES)
def test_decode_attention_matches_jax(kind, dt, t, heads):
    h, kvh = heads
    q, kv, mask = cache_case(kind, t, h, kvh, seed=t + 10 * h)
    jdt, tdt = DTS[dt]
    jstore, tstore = stored(kind, kv)
    want, vmax = jax_reference(kind, jstore, q, mask, jdt)
    k, v, ks, vs = tstore
    got = at.decode_attention(torch.from_numpy(q).to(tdt), k, v, torch.from_numpy(mask),
                              k_scale=ks, v_scale=vs, dt=tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        tol = at.rounding_tolerance(torch.from_numpy(q).to(tdt), k, v, torch.from_numpy(mask),
                                    k_scale=ks, v_scale=vs, dt=tdt).numpy()
        assert (np.abs(got.numpy() - want) <= tol).all(), float(np.abs(got.numpy() - want).max())
    # row 2 masks every slot: the softmax over -1e30 is uniform, each slot
    # weighted by 1 / S in the compute type (bf16 rounds it)
    vd = at.dequant_kv(v, vs, tdt).float().numpy()[2]  # [KV, S, hd]
    w = torch.tensor(1.0 / vd.shape[1]).to(tdt).float().item()
    mean = np.repeat(w * vd.sum(axis=1), h // kvh, axis=0).reshape(-1)
    np.testing.assert_allclose(got.numpy()[2], np.broadcast_to(mean, got.shape[1:]),
                               rtol=1e-5, atol=1e-6)


def test_rounding_tolerance_sees_unrounded_probabilities_and_dropped_slots():
    """The bf16 tolerance lets through what only the order of f32 sums
    changes, and neither of two faults: the probabilities left unrounded
    (the plain version without its bf16 rounding) or a row's first eight
    slots dropped from the value sum."""
    q, kv, mask = cache_case("bf16", 5, 4, 1, seed=5, s=200)
    _, (k, v, _, _) = stored("bf16", kv)
    qt, mt, dt = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(mask), torch.bfloat16
    ref = at.decode_attention_plain(qt, k, v, mt, dt=dt)
    tol = at.rounding_tolerance(qt, k, v, mt, dt=dt)
    b, t, h, hd = q.shape
    _, p = at.attn_core(qt.reshape(b, t, 1, h, hd), k, v, mt, return_probs=True)
    p = p.reshape(b, 1, h, t, -1)

    def out(pp):
        return torch.einsum("bkgts,bksh->btkgh", pp, v.float()).reshape(b, t, h * hd)

    assert ((out(p.to(dt).double().float()) - ref).abs() <= tol).all()
    assert ((out(p) - ref).abs() > tol).any()
    dropped = p.to(dt).float().clone()
    dropped[..., 20:28] = 0.0  # slots every row but the all-pad one attends
    assert ((out(dropped) - ref).abs() > tol)[:2].any(dim=-1).all()  # every query row sees it


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_kv_matches_jax_block(kind):
    """``dequant_kv`` (the plain version's dequantize) against JAX's
    ``_block`` dequantize of the same stored cache, bit for bit."""
    _, kv, _ = cache_case(kind, 1, 2, 2)
    jstore, tstore = stored(kind, kv)
    for dt in ("f32", "bf16"):
        jdt, tdt = DTS[dt]
        k, _, ks, _ = jstore
        if kind == "int8":
            want = k.astype(jdt) * ks[..., None].astype(jdt)
        elif kind == "int4":
            want = jg._dequant_kv4(k, ks, jdt)
        else:
            want = k.astype(jdt)
        got = at.dequant_kv(tstore[0], tstore[2], tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_decode_attention_takes_a_kv_head_slice():
    """A rank's kv heads under tensor parallelism: a narrowed (non-contiguous)
    cache and scales give that head's rows of the whole cache's answer."""
    q, kv, mask = cache_case("int4", 1, 4, 2, seed=3)
    _, (k, v, ks, vs) = stored("int4", kv)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    whole = at.decode_attention(qt, k, v, mt, k_scale=ks, v_scale=vs, dt=torch.float32)
    g = ks.shape[1] // 2
    half = at.decode_attention(qt[:, :, 2:], k.narrow(1, 1, 1), v.narrow(1, 1, 1), mt,
                               k_scale=ks.narrow(1, g, g), v_scale=vs.narrow(1, g, g),
                               dt=torch.float32)
    torch.testing.assert_close(half, whole[..., whole.shape[-1] // 2:], rtol=0, atol=0)


def test_decode_attention_rejects_what_the_kernel_does_not_take():
    q, kv, mask = cache_case("int8", 1, 2, 1)
    _, (k, v, ks, vs) = stored("int8", kv)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    with pytest.raises(TypeError):
        at.decode_attention(qt, k, v, mt, k_scale=ks, v_scale=vs, dt=torch.float16)
    with pytest.raises(ValueError):  # an int8 cache without its scales
        at.decode_attention(qt, k, v, mt, dt=torch.float32)
    with pytest.raises(ValueError):  # a mask of another slot count
        at.decode_attention(qt, k, v, mt[..., :-1], k_scale=ks, v_scale=vs, dt=torch.float32)
    with pytest.raises(ValueError):  # neither the CPU nor a card
        at.decode_attention(qt.to("meta"), k.to("meta"), v.to("meta"), mt.to("meta"),
                            k_scale=ks.to("meta"), v_scale=vs.to("meta"), dt=torch.float32)


@pytest.mark.parametrize("t,groups,hd,takes", [
    (1, 8, 256, True),  # Gemma-2B decode step
    (5, 8, 256, True),  # its verify round at k 4
    (8, 8, 256, True),
    (9, 8, 256, False),  # more than 64 query rows
    (128, 8, 256, False),  # a prefill
    (5, 4, 128, True),  # Mistral-7B's verify round
    (1, 1, 512, False),  # head dim over 256
    (1, 2, 32, True),  # the tiny test model
    (1, 1, 96, False),  # not a power of two
    (1, 4, 16, False),  # tiny_mistral: plain ops
    (1, 1, 8, False),
])
def test_kernel_takes(t, groups, hd, takes):
    assert at.kernel_takes(t, groups, hd) is takes


@pytest.mark.parametrize("pairs,s,sms", [(8, 3862, 132), (1, 700, 132), (64, 3862, 132),
                                         (8, 31, 132), (8, 3862, 16), (1024, 40, 132)])
def test_plan_covers_every_slot_once(pairs, s, sms):
    """Every split of the kernel's grid holds at least one tile, the
    splits cover all tiles, and the grid fills the SMs where the tiles
    allow it without passing twice the two blocks an SM it aims at."""
    p = at.plan_decode_attention(pairs, s, sms)
    assert p.tiles == -(-s // at.TILE)
    assert p.tiles_per_split >= 1
    assert (p.nsplit - 1) * p.tiles_per_split < p.tiles <= p.nsplit * p.tiles_per_split
    assert pairs * p.nsplit >= min(pairs * p.tiles, sms)
    assert pairs * p.nsplit <= max(pairs, 2 * 2 * sms)


# ------------------------------------------------------------ the forward's routing

V = 512
JCFG = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=V), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=V), compute_dtype=torch.float32)
PROMPTS = ["the cat sat on the mat. the cat", "ab ab ab ab ab", "hello"]


class Spy:
    """Counts the forward's calls of ``decode_attention`` (or of another
    wrapper of ``gemma``'s) and their T."""

    def __init__(self, monkeypatch, name: str = "decode_attention"):
        self.calls = []
        real = getattr(tg, name)

        def spy(q, *args, **kw):
            self.calls.append(q.shape[1])
            return real(q, *args, **kw)

        monkeypatch.setattr(tg, name, spy)


def test_forward_routes_decode_and_not_prefill_or_probs(monkeypatch):
    """``_block``'s four branches: the probabilities asked for -> plain ops;
    a decode step or verify round over the cache -> ``decode_attention``
    (bf16 and f32); every other bf16 call (prefill over the cache, the
    no-cache forward) -> ``prefill_attention``; f32 prefill -> plain ops."""
    spy = Spy(monkeypatch)
    pre = Spy(monkeypatch, "prefill_attention")
    tree = numpy_params(JCFG, seed=3)
    n = TCFG.n_layers
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, V, (2, 130))).long()
    for cfg in (TCFG, dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)):
        bf16 = cfg.compute_dtype == torch.bfloat16
        spy.calls.clear()
        pre.calls.clear()
        params = lm_params_from_jax(tree, cfg, device="cpu")
        kv = tg.init_kv_cache(cfg, 2, 160, torch.int8, device="cpu")
        _, kv, _ = tg.forward(params, tokens, cfg, kv_cache=kv)  # a prefill: 260 query rows
        assert spy.calls == [] and pre.calls == ([130] * n if bf16 else [])
        _, kv, _ = tg.forward(params, tokens[:, :1], cfg, kv_cache=kv)  # a decode step
        assert spy.calls == [1] * n
        out = tg.forward(params, tokens[:, :5], cfg, kv_cache=kv, attn_probs_layer=-1)
        assert spy.calls[n:] == [5] * (n - 1)  # the probs layer: plain ops
        assert out[3].shape == (2, cfg.n_heads, 5, 160)
        pre.calls.clear()
        tg.forward(params, tokens[:, :40], cfg)  # the no-cache forward (a capture, a trace)
        out = tg.forward(params, tokens[:, :40], cfg, attn_probs_layer=0)
        assert pre.calls == ([40] * n + [40] * (n - 1) if bf16 else [])
        assert out[3].shape == (2, cfg.n_heads, 40, 40)
    assert at.prefill_kernel_takes(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("kv", ["none", "int8", "int4"])
def test_generation_through_decode_attention_matches_jax(kv, monkeypatch):
    """A tiny f32 model's greedy generation, each decode step through
    ``decode_attention`` (one call a layer a step), equal to JAX's in
    tokens, validity and counts."""
    spy = Spy(monkeypatch)
    tree = numpy_params(JCFG, seed=7)
    kw = {"none": {}, "int8": dict(kv_int8=True), "int4": dict(kv_int4=True)}[kv]
    stops = ByteTokenizer(V).token_strings()
    j_texts, j = jd.generate(to_jax(tree), JCFG, JaxByteTokenizer(V), PROMPTS, max_new_tokens=12,
                             stop_tables=jd.StopTables.from_token_strings(stops), **kw)
    t_texts, t = td.generate(lm_params_from_jax(tree, TCFG, device="cpu"), TCFG, ByteTokenizer(V),
                             PROMPTS, max_new_tokens=12,
                             stop_tables=td.StopTables.from_token_strings(stops), **kw)
    assert t_texts == j_texts
    np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    np.testing.assert_array_equal(t.token_valid, np.asarray(j.token_valid))
    np.testing.assert_array_equal(t.n_generated, np.asarray(j.n_generated))
    assert spy.calls and set(spy.calls) == {1} and len(spy.calls) % TCFG.n_layers == 0
