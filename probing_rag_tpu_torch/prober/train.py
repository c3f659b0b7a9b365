"""Prober training: every probed (layer, site) pair in one step.

Port of ``probing_rag_tpu/prober/train.py``. One frozen-LM forward captures
every probed site; one backward through the stacked prober forward (a
batched product over the site axis) on the sum of the per-site losses gives
each site its own gradient, since the sites share no parameter, and one
AdamW update moves the whole stack. This is the JAX package's
``jax.vmap(jax.value_and_grad(...))`` step.

Parity notes (the reference's train.py and utils.py):
- loss = CrossEntropy applied AFTER a softmax (the reference's
  double-softmax quirk), by default; standard CE behind a flag; a 1-logit
  probe takes the sigmoid + BCE branch.
- pooling ``tokens_mean``: mean over the last ``pred_len`` (answer) token
  activations; ``each_token`` scores every answer token; ``last_token``
  takes the final position; ``tokens_sum`` is the inference-side sum.
- optimizer: ``optax.adamw`` with optax's defaults (b1 0.9, b2 0.999, eps
  1e-8, weight decay 1e-4 on every leaf) under a per-step exponential
  decay of the learning rate (the first update uses ``lr``), batch 8, as
  torch's AdamW with those settings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from probing_rag_tpu_torch.models.gemma import CaptureSpec, GemmaConfig, forward
from probing_rag_tpu_torch.prober.model import improved_probe_forward, init_improved_probe
from probing_rag_tpu_torch.utils.profiling import RECORDER


# ------------------------------------------------------------------- loss


def probe_loss(
    logits: torch.Tensor,  # [..., B, C]
    labels: torch.Tensor,  # [B] int
    double_softmax: bool = True,
    weights: Optional[torch.Tensor] = None,  # [B] 0/1 mask
) -> torch.Tensor:
    """Mean CE over the batch axis, one loss per leading index (a stack of
    probers gives one per site). ``double_softmax=True`` feeds the softmax
    output to a CE that applies log_softmax again, as the reference does.
    A 1-logit probe takes the reference's sigmoid + BCE branch (log terms
    guarded by eps 1e-7). ``weights`` averages over the marked rows only."""
    if logits.shape[-1] == 1:
        p = torch.sigmoid(logits[..., 0])
        y = labels.to(torch.float32)
        eps = 1e-7
        nll = -(y * torch.log(p + eps) + (1.0 - y) * torch.log(1.0 - p + eps))
    else:
        x = torch.softmax(logits, dim=-1) if double_softmax else logits
        logp = torch.log_softmax(x, dim=-1)
        idx = labels.to(torch.int64).expand(logp.shape[:-1])
        nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    if weights is None:
        return nll.mean(dim=-1)
    w = weights.to(nll.dtype)
    return (nll * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1)


# ---------------------------------------------------------------- pooling


def _answer_mask(t: int, pred_lens: torch.Tensor) -> torch.Tensor:
    """[B, T] True on each row's last ``pred_len`` positions."""
    pos = torch.arange(t, device=pred_lens.device)[None, :]
    return pos >= (t - pred_lens[:, None])


def pool_mean_answer_tokens(acts: torch.Tensor, pred_lens: torch.Tensor) -> torch.Tensor:
    """``tokens_mean``: mean over the trailing pred_len positions of each
    row. acts [..., B, T, D], pred_lens [B] -> [..., B, D]."""
    summed = pool_sum_answer_tokens(acts, pred_lens)
    return summed / torch.clamp(pred_lens[:, None], min=1).to(summed.dtype)


def pool_last_token(acts: torch.Tensor, pred_lens: torch.Tensor) -> torch.Tensor:
    return acts[..., -1, :]


def pool_sum_answer_tokens(acts: torch.Tensor, pred_lens: torch.Tensor) -> torch.Tensor:
    """Inference-side pooling: SUM over the generated tokens. Kept distinct
    from the train-side mean: the asymmetry is the reference's."""
    mask = _answer_mask(acts.shape[-2], pred_lens)
    return torch.sum(acts * mask[..., None].to(acts.dtype), dim=-2)


POOLERS: Dict[str, Callable] = {
    "tokens_mean": pool_mean_answer_tokens,
    "last_token": pool_last_token,
    "tokens_sum": pool_sum_answer_tokens,
}


# ------------------------------------------------------------- train step


@dataclass(frozen=True)
class ProberTrainConfig:
    layers: Tuple[int, ...] = (6, 8, 10, 12, 14, 16)
    positions: Tuple[str, ...] = ("resid_mid", "resid_post")
    method: str = "tokens_mean"
    lr: float = 1e-4
    lr_decay: float = 0.995
    batch_size: int = 8
    epochs: int = 2
    max_len: int = 1536
    double_softmax: bool = True
    seed: int = 42

    @property
    def sites(self) -> Tuple[Tuple[int, str], ...]:
        return tuple((l, p) for l in self.layers for p in self.positions)


def stack_leaves(tree) -> List[torch.Tensor]:
    return [v for sub in tree.values() for v in sub.values()]


def make_optimizer(tc: ProberTrainConfig, stacked_params):
    """``optax.adamw(optax.exponential_decay(lr, 1, decay))`` over a prober
    stack: torch's fused AdamW with optax.adamw's defaults (b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every leaf) and a schedule that
    ``prober_train_step`` steps after each update, so the k-th update (from
    0) uses ``lr * decay**k``. Returns the optimizer state (optimizer,
    schedule)."""
    optimizer = torch.optim.AdamW(stack_leaves(stacked_params), lr=tc.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4, fused=True)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda k: tc.lr_decay**k)


def init_prober_stack(
    tc: ProberTrainConfig, d_model: int, generator: torch.Generator, device="cuda"
):
    """Stacked params for all (layer, position) sites: leaves [n_sites, ...]."""
    per_site = [init_improved_probe(generator, d_model, device=device) for _ in tc.sites]
    return {
        mod: {leaf: torch.stack([p[mod][leaf] for p in per_site]) for leaf in per_site[0][mod]}
        for mod in per_site[0]
    }


def site_losses(
    stacked_params,
    captures: torch.Tensor,  # [n_sites, B, T, D]
    labels: torch.Tensor,  # [B]
    pred_lens: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    tc: ProberTrainConfig,
) -> torch.Tensor:
    """The per-site training losses [n_sites]; dropout draws from
    ``generator`` (None: no dropout)."""
    if tc.method == "each_token":
        # score every position with the row's label; the loss averages
        # over the answer tokens only
        n, b, t, d = captures.shape
        logits = improved_probe_forward(stacked_params, captures.reshape(n, b * t, d),
                                        generator=generator)
        mask = _answer_mask(t, pred_lens).to(torch.float32)
        lab = labels[:, None].expand(b, t)
        return probe_loss(logits, lab.reshape(b * t), tc.double_softmax,
                          weights=mask.reshape(b * t))
    pooled = POOLERS[tc.method](captures, pred_lens)  # [n_sites, B, D]
    logits = improved_probe_forward(stacked_params, pooled, generator=generator)
    return probe_loss(logits, labels, tc.double_softmax)


def site_losses_and_grads(
    stacked_params,
    captures: torch.Tensor,
    labels: torch.Tensor,
    pred_lens: torch.Tensor,
    generator: Optional[torch.Generator],
    tc: ProberTrainConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The per-site losses [n_sites] at ``stacked_params`` and the gradient
    of every leaf (in ``stack_leaves`` order)."""
    tracked = {m: {k: v.detach().requires_grad_(True) for k, v in sub.items()}
               for m, sub in stacked_params.items()}
    with torch.enable_grad():
        losses = site_losses(tracked, captures, labels, pred_lens, generator, tc)
        grads = torch.autograd.grad(losses.sum(), stack_leaves(tracked))
    return losses.detach(), grads


def prober_train_step(
    stacked_params,
    opt_state,
    captures: torch.Tensor,  # [n_sites, B, T, D] from the frozen LM
    labels: torch.Tensor,  # [B]
    pred_lens: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    *,
    tc: ProberTrainConfig,
):
    """One AdamW step of every site, ``opt_state`` from ``make_optimizer``
    over ``stacked_params``. The parameters and the state are updated in
    place and returned, with the per-site losses before the step
    ([n_sites])."""
    optimizer, schedule = opt_state
    losses, grads = site_losses_and_grads(stacked_params, captures, labels, pred_lens,
                                          generator, tc)
    for p, g in zip(stack_leaves(stacked_params), grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad()
    schedule.step()
    return stacked_params, opt_state, losses


@torch.no_grad()
def prober_eval_step(
    stacked_params,
    captures: torch.Tensor,
    labels: torch.Tensor,
    pred_lens: torch.Tensor,
    *,
    tc: ProberTrainConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-site (correct_count, loss) on one batch; eval pools as training
    does, but ``each_token`` is scored at the last token."""
    pooler = POOLERS[tc.method] if tc.method != "each_token" else pool_last_token
    logits = improved_probe_forward(stacked_params, pooler(captures, pred_lens))
    correct = (logits.argmax(dim=-1) == labels).sum(dim=-1)
    return correct, probe_loss(logits, labels, tc.double_softmax)


# ------------------------------------------------------------ data + loop


@dataclass
class ProberExample:
    """One training row of the extracted CoT dataset: ``text`` is the
    prompt + question, ``pred`` the model's generation, ``label`` the
    correctness flag."""

    text: str
    pred: str
    label: int


def tensorize_examples(
    examples: Sequence[ProberExample],
    tokenizer,
    max_len: int,
    is_cot: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left-pad tokenized text+pred to ``max_len`` and compute ``pred_len``
    = the number of generation tokens. Returns (tokens, labels, pred_lens).
    A ``train.tensorize`` span counts the ``slots`` (rows x ``max_len``)
    and the ``valid`` tokens."""
    b = len(examples)
    with RECORDER.span("train.tensorize", slots=b * max_len) as span:
        tokens = np.full((b, max_len), tokenizer.pad_id, dtype=np.int32)
        labels = np.zeros((b,), np.int32)
        pred_lens = np.zeros((b,), np.int32)
        valid = 0
        for i, ex in enumerate(examples):
            joined = f"{ex.text}\n{ex.pred}" if is_cot else f"{ex.text} {ex.pred}"
            ids_full = tokenizer.encode(joined, add_bos=True)
            ids_text = tokenizer.encode(ex.text, add_bos=True)
            ids_full = ids_full[-max_len:]
            tokens[i, max_len - len(ids_full):] = ids_full
            labels[i] = ex.label
            pred_lens[i] = max(len(ids_full) - len(ids_text), 1)
            valid += len(ids_full)
        span.count(valid=valid)
    return tokens, labels, pred_lens


def _device(lm_params) -> torch.device:
    return lm_params["final_norm"].device


@torch.no_grad()
def capture_activations(
    lm_params, cfg: GemmaConfig, tokens: np.ndarray, sites, pad_id: int
) -> torch.Tensor:
    """One frozen-LM forward on the parameters' device returning the
    [n_sites, B, T, D] activations of ``sites``. Pads are invalid keys and
    the positions count valid tokens only; the head runs on the last
    position alone (its logits are not read)."""
    arr = torch.as_tensor(tokens, dtype=torch.int64, device=_device(lm_params))
    valid = arr != pad_id
    positions = torch.clamp(torch.cumsum(valid.to(torch.int64), dim=-1) - 1, min=0)
    _, _, caps = forward(lm_params, arr, cfg, capture=CaptureSpec(tuple(sites)),
                         positions=positions, attn_valid=valid, logits_last_only=True)
    return caps


def _batch_tensors(labels: np.ndarray, pred_lens: np.ndarray, device):
    return (torch.as_tensor(labels, dtype=torch.int64, device=device),
            torch.as_tensor(pred_lens, dtype=torch.int64, device=device))


def train_probers(
    lm_params,
    cfg: GemmaConfig,
    tokenizer,
    train_examples: Sequence[ProberExample],
    dev_examples: Sequence[ProberExample] = (),
    tc: ProberTrainConfig = ProberTrainConfig(),
    log: Optional[Callable[[Dict[str, Any]], None]] = None,
):
    """The training loop on the LM's device: each epoch a permutation from
    ``seed + epoch``, whole batches only, then the dev accuracy per site.
    The generator seeded with ``tc.seed`` draws the init, then dropout.
    Returns (stacked_params, history)."""
    dev = _device(lm_params)
    generator = torch.Generator(device=dev).manual_seed(tc.seed)
    stacked = init_prober_stack(tc, cfg.d_model, generator, device=dev)
    opt_state = make_optimizer(tc, stacked)
    history: List[Dict[str, Any]] = []

    n = len(train_examples)
    for epoch in range(tc.epochs):
        perm = np.random.default_rng(tc.seed + epoch).permutation(n)
        for start in range(0, n - n % tc.batch_size, tc.batch_size):
            batch = [train_examples[i] for i in perm[start : start + tc.batch_size]]
            tokens, labels, pred_lens = tensorize_examples(batch, tokenizer, tc.max_len)
            caps = capture_activations(lm_params, cfg, tokens, tc.sites, tokenizer.pad_id)
            stacked, opt_state, losses = prober_train_step(
                stacked, opt_state, caps, *_batch_tensors(labels, pred_lens, dev), generator, tc=tc,
            )
            rec = {"epoch": epoch, "step": start // tc.batch_size,
                   "losses": losses.cpu().tolist()}
            history.append(rec)
            if log:
                log(rec)

        if dev_examples:
            acc = evaluate_probers(lm_params, cfg, tokenizer, dev_examples, stacked, tc)
            rec = {"epoch": epoch, "dev_acc": acc.tolist()}
            history.append(rec)
            if log:
                log(rec)
    return stacked, history


def evaluate_probers(
    lm_params, cfg, tokenizer, examples, stacked_params, tc: ProberTrainConfig,
    max_batches: int = 500,
) -> np.ndarray:
    """Per-site accuracy over whole batches of ``examples`` (at most
    ``max_batches``, the reference's dev cap)."""
    dev = _device(lm_params)
    correct = np.zeros(len(tc.sites), np.int64)
    total = 0
    n = len(examples)
    for bi, start in enumerate(range(0, n - n % tc.batch_size, tc.batch_size)):
        if bi >= max_batches:
            break
        batch = examples[start : start + tc.batch_size]
        tokens, labels, pred_lens = tensorize_examples(batch, tokenizer, tc.max_len)
        caps = capture_activations(lm_params, cfg, tokens, tc.sites, tokenizer.pad_id)
        c, _ = prober_eval_step(stacked_params, caps, *_batch_tensors(labels, pred_lens, dev), tc=tc)
        correct += c.cpu().numpy()
        total += len(batch)
    return correct / max(total, 1)
