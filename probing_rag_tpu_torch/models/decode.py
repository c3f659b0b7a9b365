"""Batched greedy decode over a preallocated KV cache, with stop detection
and fused prober-capture pooling.

Port of ``probing_rag_tpu/models/decode.py`` (``StopTables``,
``_pad_batch``, ``_is_stop``, ``_prefill_impl``, ``_decode_loop_impl``,
``generate``). The JAX ``lax.while_loop`` becomes a Python loop over
``forward`` steps that writes the cache in place; it exits early once
every row has stopped.

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

from probing_rag_tpu_torch.models.gemma import (
    CaptureSpec,
    GemmaConfig,
    Params,
    forward,
    init_kv_cache,
)
from probing_rag_tpu_torch.models.sampling import SamplingConfig, select_token


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
    *,
    cfg: GemmaConfig,
    max_new_tokens: int,
    eos_id: int,
    sampling: SamplingConfig,
    kv_int8: bool = False,
    kv_int4: bool = False,
):
    """Prompt forward: builds the KV cache, selects the first token.
    Returns ``(kv, g1, finished0)``."""
    b, t = prompt_tokens.shape
    dev = prompt_tokens.device
    kv = init_kv_cache(cfg, b, t + max_new_tokens, dtype=_kv_dtype(cfg, kv_int8, kv_int4),
                       device=dev)
    # cache-slot validity: prompt pad slots never attendable
    slot_valid = torch.cat(
        [prompt_valid, torch.ones((b, max_new_tokens), dtype=torch.bool, device=dev)], dim=-1
    )
    rope_prompt = torch.clamp(torch.cumsum(prompt_valid.long(), dim=-1) - 1, min=0)
    logits, kv, _ = forward(
        params, prompt_tokens, cfg,
        capture=CaptureSpec(),  # prompt-forward captures are excluded from the gate
        kv_cache=kv, positions=rope_prompt, attn_valid=slot_valid,
        logits_last_only=True,
    )
    g1 = select_token(logits[:, -1], sampling)
    finished0 = _is_stop(g1, prompt_tokens[:, -1], *stops, eos_id)
    return kv, g1, finished0


def _decode_loop_impl(
    params: Params,
    kv,  # KV cache from _prefill_impl, updated in place
    g1: torch.Tensor,  # [B] first generated token
    finished0: torch.Tensor,  # [B] bool
    prompt_valid: torch.Tensor,  # [B, T] bool
    stops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    cfg: GemmaConfig,
    capture: CaptureSpec,
    max_new_tokens: int,
    eos_id: int,
    sampling: SamplingConfig,
):
    """The decode loop over a prefilled cache. Each step feeds the previous
    token, writes its K/V into the cache in place, pools its captures for
    rows not yet finished, and selects the next token."""
    b = g1.shape[0]
    dev = g1.device
    slot_valid = torch.cat(
        [prompt_valid, torch.ones((b, max_new_tokens), dtype=torch.bool, device=dev)], dim=-1
    )
    prompt_len = prompt_valid.long().sum(dim=-1)  # [B]
    gen_buf = torch.full((b, max_new_tokens), eos_id, dtype=torch.int64, device=dev)
    gen_buf[:, 0] = g1
    valid_buf = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)
    valid_buf[:, 0] = True
    pooled = torch.zeros((capture.n_sites, b, cfg.d_model), dtype=torch.float32, device=dev)
    n_pooled = torch.zeros((b,), dtype=torch.int32, device=dev)
    finished = finished0
    prev = g1
    for step in range(max_new_tokens - 1):
        if bool(finished.all()):
            break
        rope_pos = (prompt_len + step)[:, None]  # prev token's RoPE position
        logits, kv, caps = forward(
            params, prev[:, None], cfg,
            capture=capture, kv_cache=kv, positions=rope_pos, attn_valid=slot_valid,
        )
        cap_ok = ~finished  # parity: tokens processed before the stop trigger
        if capture.n_sites:
            pooled += caps[:, :, 0, :].float() * cap_ok[None, :, None]
        n_pooled += cap_ok.int()
        nxt = select_token(logits[:, -1], sampling)
        nxt = torch.where(finished, torch.full_like(nxt, eos_id), nxt)
        valid_buf[:, step + 1] = ~finished
        gen_buf[:, step + 1] = nxt
        finished = finished | _is_stop(nxt, prev, *stops, eos_id)
        prev = nxt
    n_generated = valid_buf.sum(dim=-1, dtype=torch.int32)
    return gen_buf, valid_buf, pooled, n_pooled, n_generated


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
    kv_int8: bool = False,
    kv_int4: bool = False,
):
    """Prefill + decode loop. ``stops`` are the StopTables arrays as bool
    tensors on the device; ``kv_int8`` / ``kv_int4`` quantize the KV cache.
    Returns (tokens, token_valid, pooled, n_pooled, n_generated) as
    tensors."""
    with torch.inference_mode():
        kv, g1, finished0 = _prefill_impl(
            params, prompt_tokens, prompt_valid, stops,
            cfg=cfg, max_new_tokens=max_new_tokens, eos_id=eos_id, sampling=sampling,
            kv_int8=kv_int8, kv_int4=kv_int4,
        )
        return _decode_loop_impl(
            params, kv, g1, finished0, prompt_valid, stops,
            cfg=cfg, capture=capture, max_new_tokens=max_new_tokens,
            eos_id=eos_id, sampling=sampling,
        )


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
    kv_int8: bool = False,
    kv_int4: bool = False,
) -> Tuple[List[str], DecodeResult]:
    """End-to-end batched generation: tokenize, decode on the parameters'
    device, detokenize. Returns (full_texts, DecodeResult) where
    ``full_texts[i]`` is prompt + generation."""
    capture = capture if capture is not None else CaptureSpec.for_probing(cfg)
    if stop_tables is None:
        stop_tables = (
            StopTables.from_token_strings(tokenizer.token_strings())
            if paragraph_stop
            else StopTables.disabled(tokenizer.vocab_size)
        )
    dev = params["final_norm"].device
    prompt_ids = [tokenizer.encode(p, add_bos=True) for p in prompts]
    tokens, valid = _pad_batch(prompt_ids, tokenizer.pad_id)
    stops = tuple(
        torch.from_numpy(a).to(dev)
        for a in (stop_tables.contains_dbl_nl, stop_tables.ends_nl, stop_tables.starts_nl)
    )
    gen, gen_valid, pooled, n_pooled, n_gen = decode_greedy(
        params,
        torch.from_numpy(tokens).long().to(dev),
        torch.from_numpy(valid).to(dev),
        stops,
        cfg=cfg, capture=capture, max_new_tokens=max_new_tokens,
        eos_id=tokenizer.eos_id, sampling=sampling, kv_int8=kv_int8, kv_int4=kv_int4,
    )
    gen = gen.to(torch.int32).cpu().numpy()
    gen_valid = gen_valid.cpu().numpy()
    n_gen = n_gen.cpu().numpy()
    texts = []
    for i, prompt in enumerate(prompts):
        ids = gen[i, : n_gen[i]][gen_valid[i, : n_gen[i]]]
        texts.append(prompt + tokenizer.decode([int(x) for x in ids]))
    result = DecodeResult(
        tokens=gen,
        token_valid=gen_valid,
        pooled_captures=pooled.cpu().numpy(),
        n_pooled=n_pooled.cpu().numpy(),
        n_generated=n_gen,
    )
    return texts, result
