"""Batched decode over a preallocated KV cache, with stop detection and
fused prober-capture pooling: greedy, or sampled (``SamplingConfig``).

Port of ``probing_rag_tpu/models/decode.py`` (``StopTables``,
``_pad_batch``, ``_is_stop``, ``_prefill_impl``, ``_decode_loop_impl``,
``decode_greedy``, ``generate``). The JAX ``lax.while_loop`` becomes one
static-shape step (:func:`_decode_step`) over buffers allocated once: the
step counter, the cursor and the finished flags live on the device, the
forward attends over the whole cache under the mask, and the step reads
nothing on the host. On the card the step is captured once as a CUDA
graph and replayed (``models/graphs.py``); the host asks whether every
row has finished (the JAX loop's ``cond``) every ``check_every`` steps,
through a pinned copy and an event, and never runs more than
``max_new_tokens - 1`` steps. Steps after every row has finished change
no output. ``eager=True`` (and every CPU call) runs the same step without
the graph. ``decode_greedy_split`` (an XLA boundary) is not ported.

Tensor parallelism: ``decode_greedy(tp=group)`` and ``generate(tp=group)``
run every forward with ``gemma.forward(tp=group)`` on this rank's slices;
the KV cache is replicated and every rank selects the same tokens. A
graphed step captures its collectives, which NCCL allows; gloo
collectives cannot be captured, so a graphed step over a gloo group
raises and the caller passes ``eager=True``.

Stop conditions (parity with exp_rag.py:173-200):
- EOS selected (per row; finished rows keep appending EOS),
- the paragraph stop: the decoded text gains a new "\\n\\n" paragraph
  break, detected from three vocab tables (token contains "\\n\\n" / ends
  with "\\n" / starts with "\\n") — ``StopTables``,
- ``max_new_tokens`` appended.

Pooling parity: the gate pools the resid_post activations of every
generated token processed before the first stop trigger; the trigger
token itself and the prompt forward are excluded (``cap_ok`` below).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from probing_rag_tpu_torch.models.gemma import (
    CaptureSpec,
    GemmaConfig,
    Params,
    forward,
    init_kv_cache,
)
from probing_rag_tpu_torch.models.graphs import GRAPHS, Loop, StaticState, tree_key
from probing_rag_tpu_torch.models.sampling import SamplingConfig, select_token
from probing_rag_tpu_torch.utils.profiling import RECORDER

# host checks of "every row finished": one every this many steps
CHECK_EVERY = 4


@dataclass(frozen=True)
class StopTables:
    """Vocab-indexed tables for paragraph-stop detection."""

    contains_dbl_nl: np.ndarray  # [V] bool: token string contains "\n\n"
    ends_nl: np.ndarray  # [V] bool
    starts_nl: np.ndarray  # [V] bool

    @classmethod
    def from_token_strings(cls, token_strings: Sequence[str]) -> "StopTables":
        v = len(token_strings)
        contains = np.zeros(v, bool)
        ends = np.zeros(v, bool)
        starts = np.zeros(v, bool)
        for i, s in enumerate(token_strings):
            if not s:
                continue
            contains[i] = "\n\n" in s
            ends[i] = s.endswith("\n")
            starts[i] = s.startswith("\n")
        return cls(contains, ends, starts)

    @classmethod
    def disabled(cls, vocab_size: int) -> "StopTables":
        z = np.zeros(vocab_size, bool)
        return cls(z, z, z)


@dataclass
class DecodeResult:
    tokens: np.ndarray  # [B, max_new] int32 — generated tokens (EOS-padded)
    token_valid: np.ndarray  # [B, max_new] bool — token was really generated
    pooled_captures: np.ndarray  # [n_sites, B, D] f32 — gate-parity summed acts
    n_pooled: np.ndarray  # [B] int32 — tokens in the pooled sum
    n_generated: np.ndarray  # [B] int32


def _pad_batch(
    prompt_ids: Sequence[Sequence[int]], pad_id: int, bucket: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to a bucketed common length."""
    max_len = max(len(p) for p in prompt_ids)
    padded_len = ((max_len + bucket - 1) // bucket) * bucket
    b = len(prompt_ids)
    tokens = np.full((b, padded_len), pad_id, dtype=np.int32)
    valid = np.zeros((b, padded_len), dtype=bool)
    for i, p in enumerate(prompt_ids):
        tokens[i, padded_len - len(p):] = p
        valid[i, padded_len - len(p):] = True
    return tokens, valid


def _kv_dtype(cfg: GemmaConfig, kv_int8: bool, kv_int4: bool = False):
    """Cache element type for the (kv_int8, kv_int4) pair (see
    ``init_kv_cache``)."""
    if kv_int8 and kv_int4:
        raise ValueError("kv_int8 and kv_int4 are mutually exclusive")
    if kv_int4:
        return "int4"
    return torch.int8 if kv_int8 else cfg.compute_dtype


def _is_stop(cur, prev, stop_contains, stop_ends, stop_starts, eos_id):
    return (cur == eos_id) | stop_contains[cur] | (stop_ends[prev] & stop_starts[cur])


def _prefill_impl(
    params: Params,
    prompt_tokens: torch.Tensor,  # [B, T] int64, left-padded
    prompt_valid: torch.Tensor,  # [B, T] bool
    stops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    kv,  # init_kv_cache's dict of T + max_new_tokens slots, filled in place
    *,
    cfg: GemmaConfig,
    max_new_tokens: int,
    eos_id: int,
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    tp: Optional[dist.ProcessGroup] = None,
):
    """Prompt forward: fills the KV cache, selects the first token.
    Returns ``(kv, g1, finished0, counts)``: ``counts`` is the [B, V]
    frequency-penalty state (every valid prompt token and ``g1`` counted;
    a [B, 1] dummy when the penalty is off)."""
    b = prompt_tokens.shape[0]
    dev = prompt_tokens.device
    # cache-slot validity: prompt pad slots never attendable
    slot_valid = torch.cat(
        [prompt_valid, torch.ones((b, max_new_tokens), dtype=torch.bool, device=dev)], dim=-1
    )
    rope_prompt = torch.clamp(torch.cumsum(prompt_valid.long(), dim=-1) - 1, min=0)
    logits, _, _ = forward(
        params, prompt_tokens, cfg,
        capture=CaptureSpec(),  # prompt-forward captures are excluded from the gate
        kv_cache=dict(kv, pos=torch.zeros((), dtype=torch.int64, device=dev)),
        positions=rope_prompt, attn_valid=slot_valid, logits_last_only=True, tp=tp,
    )
    # freq_penalty parity: the penalty counts every token of the sequence so
    # far, prompt included (pad slots excluded); finished rows keep counting
    # their EOS padding
    if sampling.needs_counts:
        counts = torch.zeros((b, cfg.vocab_size), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, prompt_tokens, prompt_valid.int())
    else:  # dummy state: static shape, never read
        counts = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    g1 = select_token(logits[:, -1], sampling, generator, counts)
    if sampling.needs_counts:
        counts.scatter_add_(1, g1[:, None], torch.ones_like(g1[:, None], dtype=torch.int32))
    finished0 = _is_stop(g1, prompt_tokens[:, -1], *stops, eos_id)
    return kv, g1, finished0, counts


class DecodeState(StaticState):
    """The decode step's buffers for a batch of ``b`` prompts of ``t``
    padded tokens: the cache (``t + max_new`` slots), slot validity, RoPE
    bases and stop tables (inputs, loaded per call), and the loop state
    the step updates in place."""

    MUTABLE = ("step", "prev", "finished", "gen", "valid", "pooled", "n_pooled", "counts")

    def __init__(self, kv, b: int, t: int, max_new: int, n_sites: int, d_model: int,
                 n_counts: int, vocab: int, eos_id: int, device):
        z = dict(device=device)
        self.kv = kv
        self.t = t
        self.slot_valid = torch.ones((b, t + max_new), dtype=torch.bool, **z)
        self.prompt_len = torch.zeros((b,), dtype=torch.int64, **z)
        self.stops = tuple(torch.zeros((vocab,), dtype=torch.bool, **z) for _ in range(3))
        self.step = torch.zeros((), dtype=torch.int64, **z)
        self.prev = torch.zeros((b,), dtype=torch.int64, **z)
        self.finished = torch.zeros((b,), dtype=torch.bool, **z)
        self.gen = torch.full((b, max_new), eos_id, dtype=torch.int64, **z)
        self.valid = torch.zeros((b, max_new), dtype=torch.bool, **z)
        self.pooled = torch.zeros((n_sites, b, d_model), dtype=torch.float32, **z)
        self.n_pooled = torch.zeros((b,), dtype=torch.int32, **z)
        self.counts = torch.zeros((b, n_counts), dtype=torch.int32, **z)

    def load(self, g1, finished0, counts, prompt_valid, stops, eos_id: int) -> None:
        t = self.t
        self.slot_valid[:, :t].copy_(prompt_valid)
        self.prompt_len.copy_(prompt_valid.sum(dim=-1))
        for buf, table in zip(self.stops, stops):
            buf.copy_(table)
        self.step.zero_()
        self.prev.copy_(g1)
        self.finished.copy_(finished0)
        self.gen.fill_(eos_id)
        self.gen[:, 0] = g1
        self.valid.zero_()
        self.valid[:, 0] = True
        self.pooled.zero_()
        self.n_pooled.zero_()
        self.counts.copy_(counts)


def _decode_step(params: Params, st: DecodeState, generator: Optional[torch.Generator], *,
                 cfg: GemmaConfig, capture: CaptureSpec, eos_id: int,
                 sampling: SamplingConfig, tp: Optional[dist.ProcessGroup] = None) -> None:
    """One decode step in place over ``st``, the body of the JAX loop: feed
    the previous token at cache slot ``t + step`` (RoPE position
    ``prompt_len + step``), pool its captures for rows not yet finished,
    select the next token (EOS for finished rows), write it and its
    validity at column ``step + 1``, update ``finished``, advance ``step``.
    Static shapes, no host read: capturable as a CUDA graph."""
    step = st.step
    logits, _, caps = forward(
        params, st.prev[:, None], cfg,
        capture=capture, kv_cache=dict(st.kv, pos=step + st.t),
        positions=(st.prompt_len + step)[:, None], attn_valid=st.slot_valid, tp=tp,
    )
    cap_ok = ~st.finished  # parity: tokens processed before the stop trigger
    if capture.n_sites:
        st.pooled.add_(caps[:, :, 0, :].float() * cap_ok[None, :, None])
    st.n_pooled.add_(cap_ok.int())
    nxt = select_token(logits[:, -1], sampling, generator, st.counts)
    nxt = torch.where(st.finished, eos_id, nxt)
    if sampling.needs_counts:
        st.counts.scatter_add_(1, nxt[:, None], torch.ones_like(nxt[:, None], dtype=torch.int32))
    col = (step + 1).reshape(1)
    st.valid.index_copy_(1, col, cap_ok[:, None])
    st.gen.index_copy_(1, col, nxt[:, None])
    st.finished.copy_(st.finished | _is_stop(nxt, st.prev, *st.stops, eos_id))
    st.prev.copy_(nxt)
    step.add_(1)


def _decode_loop(params, b: int, t: int, *, cfg: GemmaConfig, capture: CaptureSpec,
                 max_new_tokens: int, eos_id: int, sampling: SamplingConfig, kv_dtype,
                 device, eager: bool, tp: Optional[dist.ProcessGroup] = None) -> Loop:
    """The decode loop's state for this call: on the card (unless
    ``eager``) a cached captured step for these parameters and shapes,
    else fresh buffers run eagerly. A graphed step over a ``tp`` group
    that is not NCCL's raises."""
    graphed = device.type == "cuda" and not eager
    if graphed and tp is not None and dist.get_backend(tp) != "nccl":
        raise ValueError(f"a CUDA graph cannot capture {dist.get_backend(tp)} collectives: "
                         "decode with eager=True (or over an nccl group)")

    def make() -> Loop:
        kv = init_kv_cache(cfg, b, t + max_new_tokens, dtype=kv_dtype, device=device)
        n_counts = cfg.vocab_size if sampling.needs_counts else 1
        st = DecodeState(kv, b, t, max_new_tokens, capture.n_sites, cfg.d_model, n_counts,
                         cfg.vocab_size, eos_id, device)
        return Loop(st, device, graphed=graphed, sampling=sampling.do_sample)

    if not graphed:
        return make()
    key = ("decode", tree_key(params), cfg, capture, sampling, str(kv_dtype), b, t,
           max_new_tokens, eos_id, str(device), None if tp is None else id(tp))
    return GRAPHS.get(key, make)


def _decode_loop_impl(
    params: Params,
    loop: Loop,  # from _decode_loop; its cache filled by _prefill_impl
    g1: torch.Tensor,  # [B] first generated token
    finished0: torch.Tensor,  # [B] bool
    counts: torch.Tensor,  # freq-penalty state from prefill
    prompt_valid: torch.Tensor,  # [B, T] bool
    stops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    cfg: GemmaConfig,
    capture: CaptureSpec,
    max_new_tokens: int,
    eos_id: int,
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    check_every: int = CHECK_EVERY,
    tp: Optional[dist.ProcessGroup] = None,
):
    """The decode loop over a prefilled cache: at most ``max_new_tokens -
    1`` steps (:func:`_decode_step`), stopping at the first host check
    that finds every row finished. Returns (tokens, token_valid, pooled,
    n_pooled, n_generated) as tensors."""
    st = loop.state
    st.load(g1, finished0, counts, prompt_valid, stops, eos_id)

    def step(gen):
        _decode_step(params, st, gen, cfg=cfg, capture=capture, eos_id=eos_id,
                     sampling=sampling, tp=tp)

    loop.run(step, lambda: st.finished, max_new_tokens - 1, check_every, generator)
    n_generated = st.valid.sum(dim=-1, dtype=torch.int32)
    return st.gen.clone(), st.valid.clone(), st.pooled.clone(), st.n_pooled.clone(), n_generated


def decode_greedy(
    params: Params,
    prompt_tokens: torch.Tensor,
    prompt_valid: torch.Tensor,
    stops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    cfg: GemmaConfig,
    capture: CaptureSpec,
    max_new_tokens: int,
    eos_id: int,
    sampling: SamplingConfig = SamplingConfig(),
    generator: Optional[torch.Generator] = None,
    kv_int8: bool = False,
    kv_int4: bool = False,
    eager: bool = False,
    check_every: int = CHECK_EVERY,
    tp: Optional[dist.ProcessGroup] = None,
):
    """Prefill + decode loop (greedy, or sampled with ``sampling``, drawing
    from ``generator``: a fresh one seeded 0 when None, as the JAX decode
    takes key 0). ``stops`` are the StopTables arrays as bool tensors on
    the device; ``kv_int8`` / ``kv_int4`` quantize the KV cache. On the
    card the step runs as a replayed CUDA graph unless ``eager``; a
    capture that fails raises. ``tp``: the tensor-parallel group,
    ``params`` this rank's slices (module docstring). Returns (tokens,
    token_valid, pooled, n_pooled, n_generated) as tensors."""
    b, t = prompt_tokens.shape
    dev = prompt_tokens.device
    if sampling.do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        loop = _decode_loop(params, b, t, cfg=cfg, capture=capture,
                            max_new_tokens=max_new_tokens, eos_id=eos_id, sampling=sampling,
                            kv_dtype=_kv_dtype(cfg, kv_int8, kv_int4), device=dev, eager=eager,
                            tp=tp)
        with RECORDER.span("lm.prefill", device=dev):
            _, g1, finished0, counts = _prefill_impl(
                params, prompt_tokens, prompt_valid, stops, loop.state.kv,
                cfg=cfg, max_new_tokens=max_new_tokens, eos_id=eos_id, sampling=sampling,
                generator=generator, tp=tp,
            )
        with RECORDER.span("lm.decode", device=dev) as span:
            out = _decode_loop_impl(
                params, loop, g1, finished0, counts, prompt_valid, stops,
                cfg=cfg, capture=capture, max_new_tokens=max_new_tokens,
                eos_id=eos_id, sampling=sampling, generator=generator, check_every=check_every,
                tp=tp,
            )
            span.count(steps=loop.steps, checks=loop.checks, row_steps=b * loop.steps)
        return out


def generate(
    params: Params,
    cfg: GemmaConfig,
    tokenizer,
    prompts: Sequence[str],
    *,
    max_new_tokens: int = 150,
    capture: Optional[CaptureSpec] = None,
    stop_tables: Optional[StopTables] = None,
    paragraph_stop: bool = True,
    sampling: SamplingConfig = SamplingConfig(),
    seed: int = 0,
    kv_int8: bool = False,
    kv_int4: bool = False,
    spec=None,  # Optional[speculative.SpecConfig]: greedy-exact speculation
    spec_oracle=None,  # [B, >= max_new] drafts for drafter="oracle"
    eager: bool = False,
    check_every: int = CHECK_EVERY,
    tp: Optional[dist.ProcessGroup] = None,
) -> Tuple[List[str], DecodeResult]:
    """End-to-end batched generation: tokenize, decode on the parameters'
    device, detokenize. Sampling draws from a generator on that device
    seeded with ``seed``; ``spec`` runs ``speculative.decode_speculative``
    (greedy only). ``tp``: the tensor-parallel group, ``params`` this
    rank's slices; speculation does not run under TP. Returns (full_texts,
    DecodeResult) where ``full_texts[i]`` is prompt + generation.

    Spans: ``lm.prepare`` (tokenize, pad, copy in), the decode's
    ``lm.prefill`` and ``lm.decode``, ``lm.readback`` and
    ``lm.detokenize``. Once the readback has synchronised, the prefill's
    span gets the batch's ``rows``, ``slots`` (rows x padded length) and
    ``valid`` prompt tokens, and the decode's its ``live`` row-steps (the
    pooled steps of every row, before its stop)."""
    if spec is not None and tp is not None:
        raise ValueError("speculative decode does not run under tensor parallelism")
    if spec is not None and sampling.do_sample:
        raise ValueError("speculative decode is greedy-exact only; "
                         "disable sampling or speculation")
    capture = capture if capture is not None else CaptureSpec.for_probing(cfg)
    if stop_tables is None:
        stop_tables = (
            StopTables.from_token_strings(tokenizer.token_strings())
            if paragraph_stop
            else StopTables.disabled(tokenizer.vocab_size)
        )
    dev = params["final_norm"].device
    with RECORDER.span("lm.prepare"):
        prompt_ids = [tokenizer.encode(p, add_bos=True) for p in prompts]
        tokens, valid = _pad_batch(prompt_ids, tokenizer.pad_id)
        stops = tuple(
            torch.from_numpy(a).to(dev)
            for a in (stop_tables.contains_dbl_nl, stop_tables.ends_nl, stop_tables.starts_nl)
        )
        tokens_t = torch.from_numpy(tokens).long().to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
    common = dict(cfg=cfg, capture=capture, max_new_tokens=max_new_tokens,
                  eos_id=tokenizer.eos_id, kv_int8=kv_int8, kv_int4=kv_int4, eager=eager,
                  check_every=check_every)
    if spec is not None:
        from probing_rag_tpu_torch.models.speculative import decode_speculative

        oracle = None if spec_oracle is None else torch.as_tensor(spec_oracle).long().to(dev)
        gen, gen_valid, pooled, n_pooled, n_gen, _ = decode_speculative(
            params, tokens_t, valid_t, stops, oracle, k=spec.k, drafter=spec.drafter, **common,
        )
    else:
        generator = (torch.Generator(device=dev).manual_seed(seed)
                     if sampling.do_sample else None)
        gen, gen_valid, pooled, n_pooled, n_gen = decode_greedy(
            params, tokens_t, valid_t, stops, sampling=sampling, generator=generator, tp=tp,
            **common,
        )
    with RECORDER.span("lm.readback"):
        result = DecodeResult(
            tokens=gen.to(torch.int32).cpu().numpy(),
            token_valid=gen_valid.cpu().numpy(),
            pooled_captures=pooled.cpu().numpy(),
            n_pooled=n_pooled.cpu().numpy(),
            n_generated=n_gen.cpu().numpy(),
        )
    RECORDER.last("lm.prefill").count(rows=tokens.shape[0], slots=tokens.size,
                                      valid=int(valid.sum()))
    RECORDER.last("lm.decode").count(live=int(result.n_pooled.sum()))
    with RECORDER.span("lm.detokenize"):
        texts = []
        for i, prompt in enumerate(prompts):
            n = result.n_generated[i]
            ids = result.tokens[i, :n][result.token_valid[i, :n]]
            texts.append(prompt + tokenizer.decode([int(x) for x in ids]))
    return texts, result
