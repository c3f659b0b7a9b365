"""Job ``index``: a dense index build, ``index-build --dense``:
``retrieval/dense.py::DenseIndex.build`` in batches of 512 over
``models/encoder.py::text_encoder`` with the stand-in tokenizer.

Set-up: the encoder's f32 weights drawn on the card from the seed (the
products run in bf16, as the CLI's ``_dense_encoder`` casts them), the
tokenizer, a pool of ``pool_calls`` calls' passages drawn from the seed,
which the window cycles through, one warm-up call. A unit is one ``DenseIndex.build`` call of ``call_docs``
passages, as a sharded build makes them. The check holds a sample of the
stored embeddings, drawn from the seed before each call (with the call's
longest passage), to ``reference/encoder.py``.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import encoder as enc_counts
from benchmark.lib.tokenizer import StandInTokenizer
from benchmark.lib.words import Vocabulary
from benchmark.reference import encoder as ref_encoder
from benchmark.reference import exact_matmuls


def encoder_config(c: Dict):
    from probing_rag_tpu_torch.models.encoder import EncoderConfig

    if c["model_type"] != "bert":
        raise ValueError(f"job index runs BERT-family encoders, not {c['model_type']!r}")
    return dataclasses.replace(
        EncoderConfig.contriever(), vocab_size=c["vocab_size"], d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        d_ff=c["intermediate_size"], max_positions=c["max_position_embeddings"],
        n_token_types=c["type_vocab_size"], norm_eps=float(c["layer_norm_eps"]),
        compute_dtype=torch.bfloat16)


def encoder_weights(c: Dict, g: torch.Generator, device) -> Dict:
    """f32 weights in the program's layout ([in, out], stacked over layers):
    N(0, 0.02^2) products and embeddings (BERT's initializer range), zero
    biases, LayerNorms at identity, drawn on ``device``."""
    d, f, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]

    def dense(*shape):
        return torch.randn(shape, generator=g, device=device).mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ln(*shape):
        return {"w": torch.ones(shape, device=device), "b": zeros(*shape)}

    return {
        "tok_embed": dense(c["vocab_size"], d), "pos_embed": dense(c["max_position_embeddings"], d),
        "type_embed": dense(c["type_vocab_size"], d), "embed_ln": ln(d),
        "layers": {"wq": dense(L, d, d), "bq": zeros(L, d), "wk": dense(L, d, d), "bk": zeros(L, d),
                   "wv": dense(L, d, d), "bv": zeros(L, d), "wo": dense(L, d, d), "bo": zeros(L, d),
                   "attn_ln": ln(L, d), "w1": dense(L, d, f), "b1": zeros(L, f),
                   "w2": dense(L, f, d), "b2": zeros(L, d), "mlp_ln": ln(L, d)},
    }


class Job:
    unit_name = "build"
    work_metric = "docs_per_s"

    def __init__(self, root: Path, config: Dict, traffic: Dict, seed: int, device: str, spans,
                 shared=None):
        from probing_rag_tpu_torch.models.encoder import text_encoder

        self.c, self.t, self.seed, self.device, self.spans = config, traffic, seed, device, spans
        self.cfg = encoder_config(config)
        self.vocab = Vocabulary.of_mix(traffic)
        self.tok = StandInTokenizer(self.vocab, config["vocab_size"],
                                    traffic["tokenizer"]["one_piece"])
        # pieces of each word of the vocabulary (passages hold words alone)
        self.pieces = np.array([len(self.tok.encode(" " + w)) for w in self.vocab.words])
        g = torch.Generator(device=device).manual_seed(seed)
        self.weights = encoder_weights(config, g, device)
        self.encode = text_encoder(self.weights, self.cfg, self.tok, device)
        p = traffic["passages"]
        self.call_docs, self.batch = p["call_docs"], p["batch"]
        self.rng = np.random.default_rng([seed % 2**63, 1])
        # the window cycles through a pool of calls: drawing a call's texts
        # takes ~0.2 s, which set-up pays once a call. Each call's passage
        # lengths come from the mix's own seed, the same for every --seed,
        # so that every seed pads the same batches: the seed draws the words
        sizes = np.random.default_rng(p["lengths_seed"])
        self.pool = [self._passages(sizes) for _ in range(p["pool_calls"])]
        self.next = 0
        self.record = False
        self.kept: List[tuple] = []

    def _passages(self, sizes: np.random.Generator):
        """One call's passages: token counts log-normal (median, sigma) from
        ``sizes``, cut at ``tokens_max``; words drawn by frequency from the
        seed's generator until each passage has its count (a last word of
        two pieces that would pass it becomes a stopword, one piece), so
        every seed pads the same batches. Returns (texts, token counts)."""
        p = self.t["passages"]
        n = self.call_docs
        want = np.exp(sizes.normal(math.log(p["tokens_median"]), p["tokens_sigma"], n))
        want = np.clip(np.round(want), 1, p["tokens_max"]).astype(np.int64)
        starts = np.cumsum(want) - want
        seg = np.repeat(np.arange(n), want)
        ranks = self.vocab.draw(self.rng, int(want.sum()))  # pieces >= 1 a word: enough
        pieces = self.pieces[ranks]
        within = np.cumsum(pieces) - (np.cumsum(pieces)[starts] - pieces[starts])[seg]
        hits = np.flatnonzero(within >= want[seg])
        last = hits[np.searchsorted(hits, starts)]  # each passage's last word
        over = within[last] > want
        ranks[last[over]] = self.rng.integers(0, self.vocab.n_stop, int(over.sum()))
        words = last - starts + 1
        keep = np.arange(len(ranks)) - starts[seg] < words[seg]
        return self.vocab.render(ranks[keep], words), want

    def unit(self) -> int:
        from probing_rag_tpu_torch.retrieval.dense import DenseIndex

        texts, tokens = self.pool[self.next % len(self.pool)]
        self.next += 1
        if self.record:  # the rows this call's check reads, drawn before it runs
            rows = self.rng.choice(len(texts), self.t["check"]["rows_per_call"], replace=False)
            rows = np.unique(np.append(rows, int(np.argmax(tokens))))
        with self.spans.span(self.unit_name):
            index = DenseIndex.build(texts, self.encode, batch_size=self.batch)
        if self.record:
            emb = index.embeddings
            ok = emb.shape == (len(texts), self.cfg.d_model) and bool(np.isfinite(emb).all())
            self.kept.append(([texts[r] for r in rows], emb[rows].copy(), ok, tokens))
        return len(texts)

    def start_window(self) -> None:
        self.tok.seconds, self.kept, self.record = 0.0, [], True

    def end_window(self) -> None:
        self.record = False
        self.tokenize_s = self.tok.seconds

    def lengths(self) -> List[int]:
        return [int(n) for _, _, _, tokens in self.kept for n in tokens]

    def model_flops(self) -> float:
        return enc_counts.flops(self.c, self.lengths())

    def profiled_unit(self):
        texts, tokens = self.pool[self.next % len(self.pool)]
        self.unit()
        self.trace_counts = {"lengths": [int(n) for n in tokens]}

    def end_to_end(self, work: int, window_s: float) -> Dict:
        return {self.work_metric: work / window_s}

    def free_program(self) -> None:
        self.encode = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    @torch.inference_mode()
    def check(self) -> Dict[str, float]:
        exact_matmuls()
        return {"emb_rel_err": self.embedding_error(None),
                "calls_malformed": sum(not ok for _, _, ok, _ in self.kept)}

    @torch.inference_mode()
    def control(self) -> Dict[str, float]:
        """The check's number for the control: the reference with fp8
        (e4m3) products, each input row and each weight column scaled to
        e4m3's range, rounded, and multiplied in float32."""
        exact_matmuls()

        def fp8(x, dim):
            s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
            return (x / s).to(torch.float8_e4m3fn).float() * s

        return {"emb_rel_err": self.embedding_error(lambda x, m: fp8(x, -1) @ fp8(m.float(), 0))}

    def embedding_error(self, linear) -> float:
        """The widest ``|e - r| / |r|`` over the sampled rows, ``r`` the
        reference's embedding (``linear``: its products, for the control)."""
        texts = [t for ts, _, _, _ in self.kept for t in ts]
        got = np.concatenate([e for _, e, _, _ in self.kept])
        worst = 0.0
        step = self.t["check"]["reference_rows"]
        for s in range(0, len(texts), step):
            ids = [self.tok.encode(t)[: self.cfg.max_positions] for t in texts[s:s + step]]
            width = max(len(i) for i in ids)
            arr = np.zeros((len(ids), width), np.int64)
            mask = np.zeros((len(ids), width), bool)
            for r, row in enumerate(ids):
                arr[r, :len(row)] = np.minimum(row, self.cfg.vocab_size - 1)
                mask[r, :len(row)] = True
            ref = ref_encoder.forward(self.weights, self.c, torch.as_tensor(arr, device=self.device),
                                      torch.as_tensor(mask, device=self.device), linear)
            e = torch.as_tensor(got[s:s + step], device=self.device)
            err = (e - ref).norm(dim=1) / ref.norm(dim=1)
            worst = max(worst, float(err.max()))
        return worst
