"""Speculative greedy decode: verify k draft tokens per forward.

Port of ``probing_rag_tpu/models/speculative.py`` (``SpecConfig``,
``_prompt_lookup_drafts``, ``decode_speculative``). A forward over
``k + 1`` tokens a row reads the same weights as a 1-token step, and may
commit up to ``k + 1`` tokens. The drafts need no second model:

- **prompt lookup** (``drafter="prompt"``): the tokens that follow the
  last occurrence of the current token in the prompt (a bigram match
  preferred over a unigram one). RAG generations quote their passages.
- **oracle** (``drafter="oracle"``): drafts from a caller's token array,
  for measuring the acceptance-1 ceiling and forcing acceptance patterns.

Exactness: the committed output equals greedy decode token for token.
Draft ``d_j`` is accepted only when it equals the argmax of the verify
forward at the previous position, and every rejected position is
re-derived from the model's own argmax. Stops, the ``max_new_tokens`` cap
and the gate's pooling follow ``decode.decode_greedy``.

Cache discipline, as in JAX: all rows write their ``k + 1`` fed tokens at
one shared physical cursor; per-row divergence in accepted length is
handled by the per-row slot-validity mask (rejected slots are never
marked valid; the round's last committed token is left invalid and re-fed
as the next round's anchor, so one valid copy of each committed token
exists). RoPE positions are logical. The cache holds ``T + max_new *
(k + 1)`` slots (one committed token a round at worst).

Each verify round is one static-shape step (:func:`_spec_round`); on the
card it is captured as a CUDA graph per block width and replayed, the
host asking every ``check_every`` rounds whether any row is still active.
A round with no active row commits nothing, writes no valid slot and
leaves the cursor where it is, so extra rounds change nothing and need
no extra slots; ``stats["rounds"]`` counts, on the device, the rounds in
which some row was active, as JAX's loop runs them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from probing_rag_tpu_torch.models.decode import CHECK_EVERY, _is_stop, _kv_dtype
from probing_rag_tpu_torch.models.gemma import (
    CaptureSpec,
    GemmaConfig,
    Params,
    forward,
    init_kv_cache,
)
from probing_rag_tpu_torch.models.graphs import GRAPHS, Loop, StaticState, tree_key
from probing_rag_tpu_torch.utils.profiling import RECORDER


@dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs for ``decode.generate(spec=...)``. Greedy only:
    the verification rule is argmax equality."""

    k: int = 4  # drafts verified per forward (block = k + 1 tokens)
    drafter: str = "prompt"  # "prompt" | "oracle"


def _prompt_lookup_drafts(
    prompt_tokens: torch.Tensor,  # [B, T] int
    prompt_valid: torch.Tensor,  # [B, T] bool
    prev: torch.Tensor,  # [B] the token before cur (bigram context)
    cur: torch.Tensor,  # [B] the anchor token the drafts must follow
    k: int,
    eos_id: int,
) -> torch.Tensor:
    """[B, k] drafts: the tokens following cur's last prompt occurrence.

    Prefers the last (prev, cur) bigram match; falls back to the last
    unigram cur match; rows with no match draft EOS (rejected by the
    verification, at no cost: every round still commits a token)."""
    t = prompt_tokens.shape[1]
    pos = torch.arange(t, dtype=torch.int64, device=prompt_tokens.device)[None, :]
    m1 = (prompt_tokens == cur[:, None]) & prompt_valid
    prev_tok = torch.cat([torch.full_like(prompt_tokens[:, :1], -1), prompt_tokens[:, :-1]], dim=1)
    m2 = m1 & (prev_tok == prev[:, None])
    last1 = torch.where(m1, pos, -1).amax(dim=1)
    last2 = torch.where(m2, pos, -1).amax(dim=1)
    start = torch.where(m2.any(dim=1), last2, last1) + 1  # [B] first draft position
    idx = start[:, None] + torch.arange(k, dtype=torch.int64, device=pos.device)[None, :]
    ok = m1.any(dim=1)[:, None] & (idx < t)
    drafts = torch.gather(prompt_tokens, 1, idx.clamp(0, t - 1))
    return torch.where(ok, drafts, eos_id)


class SpecState(StaticState):
    """The verify round's buffers: the cache (``t + max_new * blk`` slots),
    the prompt, its validity, RoPE bases, stop tables and the oracle
    (inputs, loaded per call), and the round state updated in place.
    ``gen`` has one spare column that takes the uncommitted candidates."""

    MUTABLE = ("pos", "cur", "prev_of_cur", "finished", "n_committed", "slot_valid", "gen",
               "pooled", "n_pooled", "rounds")

    def __init__(self, kv, b: int, t: int, max_new: int, blk: int, n_sites: int,
                 d_model: int, vocab: int, n_oracle: int, device):
        z = dict(device=device)
        self.kv = kv
        self.t = t
        self.prompt_tokens = torch.zeros((b, t), dtype=torch.int64, **z)
        self.prompt_valid = torch.zeros((b, t), dtype=torch.bool, **z)
        self.prompt_len = torch.zeros((b,), dtype=torch.int64, **z)
        self.stops = tuple(torch.zeros((vocab,), dtype=torch.bool, **z) for _ in range(3))
        self.oracle = torch.zeros((b, n_oracle), dtype=torch.int64, **z) if n_oracle else None
        self.pos = torch.zeros((), dtype=torch.int64, **z)
        self.cur = torch.zeros((b,), dtype=torch.int64, **z)
        self.prev_of_cur = torch.zeros((b,), dtype=torch.int64, **z)
        self.finished = torch.zeros((b,), dtype=torch.bool, **z)
        self.n_committed = torch.zeros((b,), dtype=torch.int64, **z)
        self.slot_valid = torch.zeros((b, t + max_new * blk), dtype=torch.bool, **z)
        self.gen = torch.zeros((b, max_new + 1), dtype=torch.int64, **z)
        self.pooled = torch.zeros((n_sites, b, d_model), dtype=torch.float32, **z)
        self.n_pooled = torch.zeros((b,), dtype=torch.int32, **z)
        self.rounds = torch.zeros((), dtype=torch.int64, **z)

    def load(self, prompt_tokens, prompt_valid, stops, oracle, g1, finished0, eos_id: int) -> None:
        t = self.t
        self.prompt_tokens.copy_(prompt_tokens)
        self.prompt_valid.copy_(prompt_valid)
        self.prompt_len.copy_(prompt_valid.sum(dim=-1))
        for buf, table in zip(self.stops, stops):
            buf.copy_(table)
        if self.oracle is not None:
            self.oracle.copy_(oracle)
        self.pos.fill_(t)
        self.cur.copy_(g1)
        self.prev_of_cur.copy_(prompt_tokens[:, -1])
        self.finished.copy_(finished0)
        self.n_committed.fill_(1)  # g1
        self.slot_valid.zero_()
        self.slot_valid[:, :t].copy_(prompt_valid)
        self.gen.fill_(eos_id)
        self.gen[:, 0] = g1
        self.pooled.zero_()
        self.n_pooled.zero_()
        self.rounds.zero_()


def _spec_round(params: Params, st: SpecState, *, cfg: GemmaConfig, capture: CaptureSpec,
                max_new: int, eos_id: int, k: int, drafter: str) -> None:
    """One verify round in place over ``st`` (the body of the JAX loop):
    draft, feed ``[cur, drafts]`` at the shared cursor, accept the drafts
    that match the model's argmax chain plus its bonus token, cut at the
    first stop and at ``max_new``, commit, pool and validate the fed
    committed slots, and move the anchor. Rows not active commit nothing.
    Static shapes, no host read: capturable as a CUDA graph."""
    blk = k + 1
    dev = st.cur.device
    j_axis = torch.arange(blk, dtype=torch.int64, device=dev)
    cur, n_committed = st.cur, st.n_committed
    active = ~st.finished & (n_committed < max_new)

    if drafter == "oracle":
        # oracle[row, m] = the m-th generated token of a recorded run; cur
        # is generated token n_committed - 1, so the drafts follow it
        n_or = st.oracle.shape[1]
        oid = n_committed[:, None] + j_axis[None, :k]
        drafts = torch.where(oid < n_or, torch.gather(st.oracle, 1, oid.clamp(0, n_or - 1)),
                             eos_id)
    else:
        drafts = _prompt_lookup_drafts(st.prompt_tokens, st.prompt_valid, st.prev_of_cur, cur,
                                       k, eos_id)
    block = torch.cat([cur[:, None], drafts], dim=1)  # [B, blk]

    # RoPE positions are LOGICAL (cur is fed-index n_committed - 1); buffer
    # slots are the shared physical cursor
    rope = (st.prompt_len + n_committed - 1)[:, None] + j_axis[None, :]
    slots = st.pos + j_axis
    valid_call = st.slot_valid.index_fill(1, slots, True)
    logits, _, caps = forward(params, block, cfg, capture=capture,
                              kv_cache=dict(st.kv, pos=st.pos), positions=rope,
                              attn_valid=valid_call)
    targets = torch.argmax(logits, dim=-1)  # [B, blk]

    # accepted prefix: drafts matching the model's own argmax chain
    match = drafts == targets[:, :-1]  # [B, k]
    acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
    # committed candidates cand_j (j = 1..blk): accepted drafts, then the
    # bonus token targets[acc]
    bonus = torch.gather(targets, 1, acc[:, None])
    cand = torch.where(j_axis[None, 1:] <= acc[:, None], drafts, eos_id)
    cand = torch.cat([cand, torch.full_like(cand[:, :1], eos_id)], dim=1)
    cand = cand.scatter(1, acc[:, None], bonus)  # cand[:, j - 1] = cand_j
    cprev = torch.cat([cur[:, None], cand[:, :-1]], dim=1)
    in_cand = j_axis[None, :] <= acc[:, None]
    stop_here = _is_stop(cand, cprev, *st.stops, eos_id) & in_cand
    # first stop position (1-based candidate index), blk + 1 when none
    first_stop = torch.where(stop_here, j_axis[None, :] + 1, blk + 1).amin(dim=1)
    c = torch.minimum(torch.minimum(acc + 1, first_stop), max_new - n_committed)
    c = torch.where(active, c, 0)

    # commit the candidates at their logical indices (the rest go to the
    # spare column max_new)
    take = j_axis[None, :] < c[:, None]  # also: block position j is a fed committed token
    st.gen.scatter_(1, torch.where(take, n_committed[:, None] + j_axis[None, :], max_new), cand)
    if capture.n_sites:
        st.pooled.add_(torch.einsum("sbjd,bj->sbd", caps.float(), take.float()))
    st.n_pooled.add_(take.sum(dim=1, dtype=torch.int32))
    st.slot_valid.index_copy_(1, slots, take)

    # next round's anchor: the last committed token (cand_c); rows that
    # committed nothing keep theirs
    last = torch.gather(cand, 1, (c - 1).clamp(0, blk - 1)[:, None])[:, 0]
    before = torch.gather(cand, 1, (c - 2).clamp(0, blk - 1)[:, None])[:, 0]
    new_prev = torch.where(c > 1, before, torch.where(c == 1, cur, st.prev_of_cur))
    st.prev_of_cur.copy_(new_prev)
    st.cur.copy_(torch.where(c > 0, last, cur))
    st.finished.copy_(st.finished | (active & (first_stop <= c)))
    st.n_committed.add_(c)
    any_active = active.any()
    st.pos.add_(blk * any_active)
    st.rounds.add_(any_active.long())


def decode_speculative(
    params: Params,
    prompt_tokens: torch.Tensor,  # [B, T] int64, left-padded
    prompt_valid: torch.Tensor,  # [B, T] bool
    stops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    oracle: Optional[torch.Tensor] = None,  # [B, >= max_new] for drafter="oracle"
    *,
    cfg: GemmaConfig,
    capture: CaptureSpec,
    max_new_tokens: int,
    eos_id: int,
    k: int = 4,
    drafter: str = "prompt",
    kv_int8: bool = False,
    kv_int4: bool = False,
    eager: bool = False,
    check_every: int = CHECK_EVERY,
):
    """Greedy decode with k-token speculation. Returns
    ``decode.decode_greedy``'s tuple (tokens, token_valid, pooled,
    n_pooled, n_generated), by the exactness contract the same values,
    plus ``stats``: ``rounds`` (verify forwards run) with ``n_generated``
    summed gives the tokens per forward, 1 + k x acceptance. On the card
    each round is a replayed CUDA graph unless ``eager``."""
    if drafter not in ("prompt", "oracle"):
        raise ValueError(f"drafter must be 'prompt' or 'oracle', got {drafter!r}")
    if drafter == "oracle" and oracle is None:
        raise ValueError("drafter='oracle' needs an oracle token array")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    b, t = prompt_tokens.shape
    dev = prompt_tokens.device
    blk = k + 1
    n_oracle = oracle.shape[1] if drafter == "oracle" else 0
    kv_dtype = _kv_dtype(cfg, kv_int8, kv_int4)
    graphed = dev.type == "cuda" and not eager

    def make() -> Loop:
        kv = init_kv_cache(cfg, b, t + max_new_tokens * blk, dtype=kv_dtype, device=dev)
        st = SpecState(kv, b, t, max_new_tokens, blk, capture.n_sites, cfg.d_model,
                       cfg.vocab_size, n_oracle, dev)
        return Loop(st, dev, graphed=graphed)

    with torch.inference_mode():
        if graphed:
            key = ("spec", tree_key(params), cfg, capture, str(kv_dtype), b, t, max_new_tokens,
                   eos_id, k, drafter, n_oracle, str(dev))
            loop = GRAPHS.get(key, make)
        else:
            loop = make()
        st = loop.state
        # prompt forward (excluded from the gate); generation slots become
        # valid only when a round commits them
        slot_valid0 = torch.cat(
            [prompt_valid, torch.zeros((b, st.slot_valid.shape[1] - t), dtype=torch.bool,
                                       device=dev)], dim=-1)
        rope_prompt = torch.clamp(torch.cumsum(prompt_valid.long(), dim=-1) - 1, min=0)
        with RECORDER.span("lm.prefill", device=dev):
            logits, _, _ = forward(
                params, prompt_tokens, cfg, capture=CaptureSpec(),
                kv_cache=dict(st.kv, pos=torch.zeros((), dtype=torch.int64, device=dev)),
                positions=rope_prompt, attn_valid=slot_valid0, logits_last_only=True,
            )
            g1 = torch.argmax(logits[:, -1], dim=-1)
            finished0 = _is_stop(g1, prompt_tokens[:, -1], *stops, eos_id)
        st.load(prompt_tokens, prompt_valid, stops, oracle, g1, finished0, eos_id)

        def round_(_gen):
            _spec_round(params, st, cfg=cfg, capture=capture, max_new=max_new_tokens,
                        eos_id=eos_id, k=k, drafter=drafter)

        # every active round commits a token and g1 is committed: at most
        # max_new - 1 active rounds. A round verifies blk positions a row
        with RECORDER.span("lm.decode", device=dev) as span:
            loop.run(round_, lambda: st.finished | (st.n_committed >= max_new_tokens),
                     max_new_tokens - 1, check_every)
            span.count(steps=loop.steps, checks=loop.checks, row_steps=b * blk * loop.steps)
        n_committed = st.n_committed.to(torch.int32)
        valid = torch.arange(max_new_tokens, device=dev)[None, :] < st.n_committed[:, None]
        stats = {"rounds": int(st.rounds)}
        return (st.gen[:, :max_new_tokens].clone(), valid, st.pooled.clone(),
                st.n_pooled.clone(), n_committed, stats)
