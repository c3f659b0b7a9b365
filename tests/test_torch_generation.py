"""The port's generation (static-shape cache step, decode loop with its
host-check cadence, sampling, speculative decoding) against the JAX
package on the CPU, at ``GemmaConfig.tiny()`` in f32, on parameters and
inputs drawn with numpy from a seed.

Tolerances: prefill logits at 1e-5 (the same f32 math; pad query rows
included, which average over every slot of the cache in both); tokens,
validity, counts and rounds exactly; pooled captures at rtol 1e-4 / atol
1e-3 against JAX's sequential decode (sums of up to max_new f32 vectors
whose summands differ in their last bits) and at 2e-3 where the
speculative sums are taken over blocks (JAX's own tolerance,
``tests/test_speculative.py``). Sampling is held to JAX exactly where
the draw cannot matter (its limits, ``top_k=1``) and by its support and
frequencies elsewhere: the two take their random numbers from different
generators."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import decode as jd
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models import sampling as js
from probing_rag_tpu.models import speculative as jspec
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu_torch.models import decode as td
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models import sampling as ts
from probing_rag_tpu_torch.models import speculative as tspec
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

V = 512
JCFG = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=V), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=V), compute_dtype=torch.float32)
PROMPTS = ["the cat sat on the mat. the cat", "ab ab ab ab ab", "hello"]
POOLED = dict(rtol=1e-4, atol=1e-3)
SPEC_POOLED = dict(rtol=2e-3, atol=2e-3)


@functools.lru_cache(maxsize=None)
def trees(quant: str = "none"):
    """(numpy tree, JAX tree, port tree) from one numpy draw; ``quant``
    "int8" quantizes it with the JAX quantizer first."""
    tree = numpy_params(JCFG, seed=7)
    if quant == "int8":
        tree = jax.tree_util.tree_map(np.asarray, jg.quantize_lm_params(to_jax(tree), bits=8))
    return tree, to_jax(tree), lm_params_from_jax(tree, TCFG, device="cpu")


def stop_strings(stop_tokens=()):
    """The byte tokenizer's strings, with ``stop_tokens`` made paragraph
    stops."""
    strings = ByteTokenizer(V).token_strings()
    for tok in stop_tokens:
        strings[tok] = "x\n\n"
    return strings


@functools.lru_cache(maxsize=None)
def jax_generate(max_new: int, stop_tokens=(), sampling=js.SamplingConfig(), seed: int = 0,
                 kv_int8: bool = False, quant: str = "none"):
    """The JAX generate, once per argument set (each compile takes seconds)."""
    _, jtree, _ = trees(quant)
    return jd.generate(
        jtree, JCFG, JaxByteTokenizer(V), PROMPTS, max_new_tokens=max_new,
        stop_tables=jd.StopTables.from_token_strings(stop_strings(stop_tokens)),
        sampling=sampling, seed=seed, kv_int8=kv_int8,
    )


def port_generate(max_new: int, stop_tokens=(), quant: str = "none", spec=None, **kw):
    _, _, ttree = trees(quant)
    return td.generate(
        ttree, TCFG, ByteTokenizer(V), PROMPTS, max_new_tokens=max_new,
        stop_tables=td.StopTables.from_token_strings(stop_strings(stop_tokens)),
        spec=None if spec is None else tspec.SpecConfig(*spec), **kw,
    )


def assert_same(got, ref, pooled=POOLED):
    (t_texts, t), (j_texts, j) = got, ref
    assert t_texts == j_texts
    np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    np.testing.assert_array_equal(t.token_valid, np.asarray(j.token_valid))
    np.testing.assert_array_equal(t.n_generated, np.asarray(j.n_generated))
    np.testing.assert_array_equal(t.n_pooled, np.asarray(j.n_pooled))
    np.testing.assert_allclose(t.pooled_captures, np.asarray(j.pooled_captures), **pooled)


@functools.lru_cache(maxsize=None)
def mid_stop():
    """A generated token of row 0 (at step 5 of a stop-free run) made a
    paragraph stop, so rows finish at different steps."""
    _, res = jax_generate(16)
    return (int(np.asarray(res.tokens)[0, 5]),)


# ------------------------------------------------------------ the cache step


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
def test_prefill_pad_rows_match_jax(kv):
    """Prefill of left-padded prompts into a cache longer than the prompt,
    logits at every position: pad query rows (no valid key) average over
    every slot in both, as the whole-buffer attention makes them. At 1e-5
    for the compute-dtype (f32) and the int4 cache. A bf16 or int8 cache
    rounds K/V values that differ between the two in their last f32 bits,
    and a value at a rounding boundary then lands one bf16 ulp or one int8
    step apart, which later layers read and carry on: layer 0's cache
    (computed from the embeddings alone) is held equal but for such single
    steps in at most 1% of its entries, and the logits at 1e-3."""
    _, jtree, ttree = trees()
    rng = np.random.default_rng(21)
    b, t, s = 3, 12, 20
    tokens = rng.integers(0, V, size=(b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, :4] = False
    valid[2, :9] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    slot_valid = np.concatenate([valid, np.ones((b, s - t), bool)], axis=1)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8), "int4": (jnp.int4, "int4")}[kv]
    j_logits, j_kv, _ = jg.forward(
        jtree, jnp.asarray(tokens), JCFG, kv_cache=jg.init_kv_cache(JCFG, b, s, jdt),
        positions=jnp.asarray(positions), attn_valid=jnp.asarray(slot_valid))
    t_kv = tg.init_kv_cache(TCFG, b, s, tdt, device="cpu")
    t_logits, t_new, _ = tg.forward(
        ttree, torch.from_numpy(tokens).long(), TCFG, kv_cache=t_kv,
        positions=torch.from_numpy(positions).long(), attn_valid=torch.from_numpy(slot_valid))
    assert int(t_new["pos"]) == int(j_kv["pos"]) == t
    assert t_new["pos"].dim() == 0 and t_new["pos"].dtype == torch.int64
    tol = 1e-5
    if kv in ("bf16", "int8"):
        tol = 1e-3
        for name in ("k", "v"):
            got = t_kv[name][0].float().numpy()
            ref = np.asarray(j_kv[name][0]).astype(np.float32)
            differ = got != ref
            assert differ.mean() <= 0.01, (name, differ.mean())
            if kv == "int8":
                assert (np.abs(got - ref)[differ] == 1).all()
            else:  # one bf16 step: at most 2^-7 of the larger magnitude
                big = np.maximum(np.abs(got), np.abs(ref))[differ]
                assert (np.abs(got - ref)[differ] <= big * 2**-7).all()
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=tol, atol=tol)


# ---------------------------------------------------------- the decode loop


@pytest.mark.parametrize("check_every", [1, 4, 7])
def test_decode_check_cadence_matches_jax(check_every):
    """Greedy decode whose rows stop at different steps: every host-check
    cadence gives JAX's tokens, validity, counts and pooled captures (steps
    run after every row finished change nothing)."""
    stops = mid_stop()
    ref = jax_generate(16, stops)
    assert (np.asarray(ref[1].n_generated) < 16).any()
    got = port_generate(16, stops, check_every=check_every)
    assert_same(got, ref)


def test_sampling_is_greedy_at_its_limits_and_matches_jax():
    """Greedy stays the first maximum; top_k=1, top_p=1e-9 and temperature
    1e-7 all select the argmax, in JAX and in the port."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 64)).astype(np.float32)
    logits[0, 10] = logits[0, 20] = logits[0].max() + 1.0  # a tie: the first wins
    want = np.argmax(logits, axis=-1)
    assert want[0] == 10
    t_logits = torch.from_numpy(logits)
    np.testing.assert_array_equal(ts.select_token(t_logits, ts.SamplingConfig()).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(js.select_token(jnp.asarray(logits), js.SamplingConfig())), want)
    logits[0, 20] -= 1.0
    want = np.argmax(logits, axis=-1)
    for kw in (dict(top_k=1), dict(top_p=1e-9), dict(temperature=1e-7)):
        gen = torch.Generator().manual_seed(0)
        got = ts.select_token(torch.from_numpy(logits), ts.SamplingConfig(do_sample=True, **kw),
                              gen)
        ref = js.select_token(jnp.asarray(logits), js.SamplingConfig(do_sample=True, **kw),
                              jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
        np.testing.assert_array_equal(np.asarray(ref), want, err_msg=str(kw))


@pytest.mark.parametrize("kw", [dict(top_k=6, top_p=0.8, temperature=0.7),
                                dict(top_k=12, top_p=0.95)])
def test_sampling_distribution_matches_jax(kw):
    """V = 16: JAX's draws over 4096 keys lie in the port's kept set and
    cover every kept token above 1%; the port's own draw frequencies are
    within 4 sigma of the softmax of its filtered logits."""
    rng = np.random.default_rng(5)
    logits = (2.0 * rng.standard_normal(16)).astype(np.float32)
    n = 4096
    t_cfg, j_cfg = ts.SamplingConfig(do_sample=True, **kw), js.SamplingConfig(do_sample=True, **kw)
    filtered = ts.filter_logits(torch.from_numpy(logits)[None], t_cfg)[0]
    kept = set(np.flatnonzero(np.isfinite(filtered.numpy())).tolist())
    probs = torch.softmax(filtered, dim=-1).numpy()
    assert 1 < len(kept) < 16
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    j_draws = np.asarray(jax.vmap(
        lambda key: js.select_token(jnp.asarray(logits)[None], j_cfg, key)[0])(keys))
    assert set(j_draws.tolist()) <= kept
    assert {i for i in kept if probs[i] > 0.01} <= set(j_draws.tolist())
    t_draws = ts.select_token(torch.from_numpy(np.tile(logits, (n, 1))), t_cfg,
                              torch.Generator().manual_seed(0)).numpy()
    assert set(t_draws.tolist()) <= kept
    freq = np.bincount(t_draws, minlength=16) / n
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 4 * sigma + 1e-12).all(), (freq, probs)


def test_freq_penalty_decode_matches_jax():
    """top_k=1 sampling with a frequency penalty is deterministic: the port
    gives JAX's tokens step for step (the counts include the prompt), and
    they differ from plain greedy on these repeating prompts."""
    sampling = dict(do_sample=True, top_k=1, freq_penalty=2.0)
    ref = jax_generate(16, sampling=js.SamplingConfig(**sampling))
    got = port_generate(16, sampling=ts.SamplingConfig(**sampling))
    assert_same(got, ref)
    greedy = port_generate(16)
    assert not np.array_equal(got[1].tokens, greedy[1].tokens)


def test_sampled_generate_is_seeded():
    sampling = ts.SamplingConfig(do_sample=True, temperature=1.0, top_k=50, freq_penalty=0.5)
    a = port_generate(12, sampling=sampling, seed=1)
    b = port_generate(12, sampling=sampling, seed=1, check_every=3)
    c = port_generate(12, sampling=sampling, seed=2)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1].tokens, b[1].tokens)
    np.testing.assert_array_equal(a[1].pooled_captures, b[1].pooled_captures)
    assert not np.array_equal(a[1].tokens, c[1].tokens)


# ------------------------------------------------------------- speculation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prompt_lookup_drafts_match_jax(seed):
    """Random prompts over a small vocabulary (so bigram and unigram
    matches both occur), pads, and anchors inside and outside the prompt."""
    rng = np.random.default_rng(seed)
    b, t, k = 16, 24, 1 + seed * 2
    tokens = rng.integers(0, 6, size=(b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    for i in range(b):
        valid[i, : rng.integers(0, t // 2)] = False
    prev = rng.integers(0, 8, size=b).astype(np.int32)
    cur = rng.integers(0, 8, size=b).astype(np.int32)
    ref = jspec._prompt_lookup_drafts(jnp.asarray(tokens), jnp.asarray(valid), jnp.asarray(prev),
                                      jnp.asarray(cur), k, eos_id=99)
    got = tspec._prompt_lookup_drafts(torch.from_numpy(tokens).long(), torch.from_numpy(valid),
                                      torch.from_numpy(prev).long(), torch.from_numpy(cur).long(),
                                      k, eos_id=99)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def spec_stats(max_new, spec, stop_tokens=(), oracle=None, quant="none", kv_int8=False):
    """The port's decode_speculative and JAX's on the padded PROMPTS: the
    port's five outputs and rounds, against JAX's."""
    _, jtree, ttree = trees(quant)
    tok = ByteTokenizer(V)
    tokens, valid = td._pad_batch([tok.encode(p, add_bos=True) for p in PROMPTS], tok.pad_id)
    tables = td.StopTables.from_token_strings(stop_strings(stop_tokens))
    arrays = (tables.contains_dbl_nl, tables.ends_nl, tables.starts_nl)
    k, drafter = spec
    common = dict(capture=tg.CaptureSpec.for_probing(TCFG), max_new_tokens=max_new,
                  eos_id=tok.eos_id, k=k, drafter=drafter, kv_int8=kv_int8)
    got = tspec.decode_speculative(
        ttree, torch.from_numpy(tokens).long(), torch.from_numpy(valid),
        tuple(torch.from_numpy(a) for a in arrays),
        None if oracle is None else torch.as_tensor(np.asarray(oracle)).long(),
        cfg=TCFG, **common)
    ref = jspec.decode_speculative(
        jtree, jnp.asarray(tokens), jnp.asarray(valid), *map(jnp.asarray, arrays),
        None if oracle is None else jnp.asarray(np.asarray(oracle)),
        cfg=JCFG, capture=jg.CaptureSpec.for_probing(JCFG), **{
            n: v for n, v in common.items() if n != "capture"})
    return got, ref


SPEC_CASES = {
    "prompt k4": dict(max_new=12, spec=(4, "prompt")),
    "prompt k1": dict(max_new=12, spec=(1, "prompt")),
    "adversarial oracle k3": dict(max_new=12, spec=(3, "oracle"), oracle="bad"),
    "perfect oracle k4": dict(max_new=12, spec=(4, "oracle"), oracle="greedy"),
    "perfect oracle k1": dict(max_new=12, spec=(1, "oracle"), oracle="greedy"),
    "paragraph stop mid-block k5": dict(max_new=10, spec=(5, "prompt"), stops=True),
    "max_new cap crossing a block k4": dict(max_new=7, spec=(4, "prompt")),
    "int8 KV k4": dict(max_new=12, spec=(4, "prompt"), kv_int8=True),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_decode_speculative_matches_jax_and_greedy(case):
    """Tokens, validity, n_generated, n_pooled and rounds equal to JAX's
    ``decode_speculative``, pooled captures at 2e-3; the committed output
    equals the port's greedy decode (and JAX's)."""
    c = SPEC_CASES[case]
    max_new, spec = c["max_new"], c["spec"]
    stops = mid_stop() if c.get("stops") else ()
    kv_int8 = c.get("kv_int8", False)
    greedy_ref = jax_generate(max_new, stops, kv_int8=kv_int8)
    oracle = None
    if c.get("oracle") == "bad":
        oracle = np.full((len(PROMPTS), 32), 3, np.int64)
    elif c.get("oracle") == "greedy":
        oracle = np.asarray(greedy_ref[1].tokens).astype(np.int64)
    got, ref = spec_stats(max_new, spec, stops, oracle, kv_int8=kv_int8)
    for name, a, r in zip(("tokens", "valid", "n_pooled", "n_generated"),
                          (got[0], got[1], got[3], got[4]), (ref[0], ref[1], ref[3], ref[4])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **SPEC_POOLED)
    assert got[5]["rounds"] == int(ref[5]["rounds"])
    if c.get("oracle") == "greedy":  # full acceptance: about max_new / (k + 1) rounds
        assert got[5]["rounds"] <= -(-(max_new - 1) // (spec[0] + 1)) + 1
    # the same through generate, against the port's greedy and JAX's
    greedy = port_generate(max_new, stops, kv_int8=kv_int8)
    assert_same(greedy, greedy_ref, POOLED if not kv_int8 else SPEC_POOLED)
    spec_out = port_generate(max_new, stops, kv_int8=kv_int8, spec=spec, spec_oracle=oracle,
                             check_every=3)
    assert_same(spec_out, greedy, SPEC_POOLED)


def test_spec_with_sampling_raises():
    with pytest.raises(ValueError, match="greedy-exact"):
        port_generate(4, sampling=ts.SamplingConfig(do_sample=True), spec=(4, "prompt"))
    with pytest.raises(ValueError, match="oracle"):
        spec_stats(4, (2, "oracle"))


# ------------------------------------------------------------ the loop runner


def test_graph_cache_evicts_the_least_recently_used():
    from probing_rag_tpu_torch.models.graphs import GraphCache

    cache, made = GraphCache(2), []
    make = lambda key: lambda: made.append(key) or key  # noqa: E731
    for key in ("a", "b", "a", "c", "a", "b"):
        assert cache.get(key, make(key)) == key
    assert made == ["a", "b", "c", "b"]  # "b" was evicted by "c", then made again


@pytest.mark.parametrize("check_every,finish_at,steps,checks", [
    (4, 10, 12, 4), (1, 10, 10, 11), (7, 0, 0, 1), (3, 99, 20, 7)])
def test_loop_checks_every_n_steps(check_every, finish_at, steps, checks):
    """The host loop checks before the first step and after every
    ``check_every`` steps, stops at the first check that finds the rows
    done, and never runs more than ``max_steps``."""
    from probing_rag_tpu_torch.models.graphs import Loop, StaticState

    count = torch.zeros((), dtype=torch.int64)
    loop = Loop(StaticState(), torch.device("cpu"), graphed=False)

    def step(_gen):
        count.add_(1)

    n = loop.run(step, lambda: (count >= finish_at)[None], 20, check_every)
    assert n == loop.steps == int(count) == steps
    assert loop.checks == checks
    with pytest.raises(ValueError):
        loop.run(step, lambda: count[None] > 0, 20, 0)
