"""Job ``rag``: the probing loop that Probing-RAG's users run over a dev set
(``rag-run --retr-method probing``), ``pipeline/rag.py::
AdaptiveRAGPipeline.run`` over ``retrieval/bm25.py::BM25Engine``.

Set-up: the corpus (fixed for the mix), its BM25 index with the CLI's
default ``BM25Config`` (built once per checkout into ``.bench_cache/bm25``
and loaded after), the LM's bf16 weights and the prober stack drawn on the
card from the seed, the stand-in tokenizer, one warm-up chunk. A unit is
one ``pipe.run`` chunk of ``batch`` questions drawn from the seed. The
check samples the window's generate calls of every round, and its searches,
afterwards and holds them to ``benchmark/reference``: the served tokens'
logits, the pooled captures, the gate's scores and BM25's top-k.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.counts import lm as lm_counts
from benchmark.lib.tokenizer import StandInTokenizer
from benchmark.lib.words import Vocabulary
from benchmark.reference import exact_matmuls
from benchmark.reference import gate as ref_gate
from benchmark.reference import lm as ref_lm
from benchmark.reference.bm25 import ReferenceBM25

HIDDEN = 512  # the paper's prober width


def lm_config(c: Dict):
    """The program's config for the file's numbers, on the preset of its
    family (the family's semantics: plain RMSNorm weights, SwiGLU, no
    embedding scale, untied head)."""
    from probing_rag_tpu_torch.models.gemma import GemmaConfig

    if c["model_type"] != "mistral":
        raise ValueError(f"job rag runs Mistral-family models, not {c['model_type']!r}")
    d, h = c["hidden_size"], c["num_attention_heads"]
    return dataclasses.replace(
        GemmaConfig.mistral_7b(), vocab_size=c["vocab_size"], d_model=d,
        n_layers=c["num_hidden_layers"], n_heads=h, n_kv_heads=c["num_key_value_heads"],
        head_dim=d // h, d_ff=c["intermediate_size"], rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]), probe_layers=tuple(c["probe_layers"]),
        tied_head=bool(c["tie_word_embeddings"]), compute_dtype=torch.bfloat16)


def lm_weights(c: Dict, g: torch.Generator, device) -> Dict:
    """bf16 weights in the program's layouts ([in, out], stacked over
    layers), N(0, 1 / fan_in), norms at 1, drawn on ``device`` a leaf at a
    time in the type they are served in."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    kv, hd, f, L, v = (c["num_key_value_heads"], d // h, c["intermediate_size"],
                       c["num_hidden_layers"], c["vocab_size"])

    def dense(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16).mul_(
            shape[-2] ** -0.5)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=torch.bfloat16)

    return {
        "embed": dense(v, d), "final_norm": ones(d), "lm_head": dense(d, v),
        "layers": {"attn_norm": ones(L, d), "wq": dense(L, d, h * hd), "wk": dense(L, d, kv * hd),
                   "wv": dense(L, d, kv * hd), "wo": dense(L, h * hd, d), "mlp_norm": ones(L, d),
                   "w_gate": dense(L, d, f), "w_up": dense(L, d, f), "w_down": dense(L, f, d)},
    }


def prober_stack(n: int, d: int, g: torch.Generator, device) -> Dict:
    """``n`` probers stacked (the program's layout), f32, torch.nn.Linear's
    default U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorms at identity."""
    def u(shape, fan_in):
        return torch.rand(shape, generator=g, device=device).mul_(2 * fan_in ** -0.5).sub_(
            fan_in ** -0.5)

    def ln(width):
        return {"w": torch.ones(n, width, device=device), "b": torch.zeros(n, width, device=device)}

    def lin(i, o):
        return {"w": u((n, i, o), i), "b": u((n, o), i)}

    return {"ln_in": ln(d), "fc1": lin(d, HIDDEN), "ln1": ln(HIDDEN), "fc2": lin(HIDDEN, HIDDEN),
            "ln2": ln(HIDDEN), "fc3": lin(HIDDEN, 2)}


def templates() -> List[str]:
    """The program's prompt templates, rendered empty: their chunks get
    pieces of their own in the stand-in tokenizer."""
    from probing_rag_tpu_torch.data import prompts

    return [prompts.cot_prompt(""), prompts.retr_qa_cot2("", prompts.format_evidences([""] * 5))]


class Retriever:
    """The engine behind the pipeline's ``retriever``: a span around each
    search (the call returns host arrays, so it ends synchronised), and
    while recording each call's queries and top-k."""

    def __init__(self, engine, spans):
        self.engine, self.spans = engine, spans
        self.record = False
        self.calls: List[tuple] = []

    def search(self, queries, k=5):
        with self.spans.span("search"):
            res = self.engine.search(queries, k=k)
        if self.record:
            self.calls.append((list(queries), np.array(res.doc_indices), np.array(res.scores)))
        return res


def recording_pipeline(base):
    """The program's pipeline with each generate call of ``run`` kept while
    ``record`` is set: its round (0 without retrieval, then 1, 2, ...), the
    prompts it was given, the texts it returned, the pooled captures the
    decode loop summed ([sites, rows, D]) and the gate's scores of them."""
    class Pipeline(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.record = False
            self.calls: List[dict] = []
            self._round = 0

        def run(self, questions):
            self._round = 0
            return super().run(questions)

        def _generate(self, prompt_texts, with_capture):
            texts, pooled = super()._generate(prompt_texts, with_capture)
            if self.record:
                self.calls.append({"round": self._round, "prompts": list(prompt_texts),
                                   "texts": list(texts), "pooled": np.array(pooled, np.float32)})
            self._round += 1
            return texts, pooled

        def _gate(self, pooled):
            retrieve, scores = super()._gate(pooled)
            if self.record:
                self.calls[-1]["scores"] = np.asarray(scores, np.float64)
            return retrieve, scores

    return Pipeline


class Job:
    unit_name = "chunk"
    work_metric = "questions_per_s"

    def __init__(self, root: Path, config: Dict, traffic: Dict, seed: int, device: str, spans,
                 shared: Optional[Dict] = None):
        """``shared``: a dict kept across jobs of one process (calibration
        runs many seeds), which holds the corpus, its index and engine."""
        from probing_rag_tpu_torch.data.corpus import DocStore
        from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
        from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

        self.c, self.t = config, traffic
        self.seed, self.device, self.spans = seed, device, spans
        self.cfg = lm_config(config)
        shared = {} if shared is None else shared
        if "engine" not in shared:
            corpus = traffic["corpus"]
            shared["vocab"] = Vocabulary.of_mix(traffic)
            rng = np.random.default_rng(corpus["seed"])
            shared["ranks"] = shared["vocab"].draw(rng, (corpus["docs"], corpus["words_per_doc"]))
            shared["texts"] = shared["vocab"].render(shared["ranks"],
                                                     [corpus["words_per_doc"]] * corpus["docs"])
            shared["engine"] = BM25Engine(self._index(root, shared["texts"]), device=device)
        self.vocab, self.ranks, texts = shared["vocab"], shared["ranks"], shared["texts"]
        self.engine = shared["engine"]
        self.tok = StandInTokenizer(self.vocab, config["vocab_size"],
                                    traffic["tokenizer"]["one_piece"], templates())
        g = torch.Generator(device=device).manual_seed(seed)
        self.weights = lm_weights(config, g, device)
        self.probers = prober_stack(len(self.cfg.probe_layers), self.cfg.d_model, g, device)
        self.retriever = Retriever(self.engine, spans)
        loop = traffic["loop"]
        self.rag = RAGConfig(retr_method="probing", threshold=loop["threshold"],
                             top_k=loop["top_k"], max_new_tokens=loop["max_new_tokens"],
                             batch_size=loop["batch"])
        self.pipe = recording_pipeline(AdaptiveRAGPipeline)(
            self.weights, self.cfg, self.tok, self.retriever,
            DocStore.from_texts(texts, [str(i) for i in range(len(texts))]), self.probers,
            self.rag)
        self.chunk = -1  # the warm-up chunk; the window's are 0, 1, ...
        self.diag: Dict[str, list] = {}  # per-token readings of the check, for calibration

    def _index(self, root: Path, texts):
        """The CLI's default BM25 index of ``texts``, cached in the checkout
        under a key of everything that makes it."""
        from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

        src = (Path(__file__).resolve().parent.parent / "lib" / "words.py").read_bytes()
        key = hashlib.sha256(json.dumps(
            [self.t["corpus"], self.t["words"]], sort_keys=True).encode() + src).hexdigest()[:16]
        path = root / ".bench_cache" / "bm25" / key
        if (path / "manifest.json").exists():
            return BM25Index.load(path)
        index = BM25Index.build(texts, BM25Config())
        tmp = path.with_name(f"{key}.{os.getpid()}.tmp")
        index.save(tmp)
        os.replace(tmp, path)
        return index

    def questions(self, chunk: int) -> List[str]:
        q = self.t["questions"]
        rng = np.random.default_rng([self.seed % 2**63, chunk + 1])
        lens = rng.integers(q["words_min"], q["words_max"] + 1, self.rag.batch_size)
        ranks = self.vocab.draw(rng, int(lens.sum()), content_only=True)
        return [s + "?" for s in self.vocab.render(ranks, lens)]

    # ------------------------------------------------------------ the window
    def unit(self) -> int:
        qs = self.questions(self.chunk)
        with self.spans.span(self.unit_name):
            self.pipe.run(qs)
        self.chunk += 1
        return len(qs)

    def start_window(self) -> None:
        from probing_rag_tpu_torch.models import graphs

        self.tok.clear()
        self.tok.record = self.retriever.record = self.pipe.record = True
        self.retriever.calls, self.pipe.calls = [], []
        self.captures0 = dict(graphs.CAPTURES)

    def end_window(self) -> None:
        from probing_rag_tpu_torch.models import graphs

        self.tok.record = self.retriever.record = self.pipe.record = False
        self.calls = self.pipe.calls
        self.capture_s = graphs.CAPTURES["seconds"] - self.captures0["seconds"]

    def generations(self) -> List[tuple]:
        """(prompt token counts, served token counts) of each generate call
        of the window, from the order of the tokenizer's calls: a run of
        prompt encodes, then a run of decodes."""
        out, enc, dec = [], [], []
        for kind, key in self.tok.log:
            if kind == "encode":
                if dec:
                    out.append((enc, dec))
                    enc, dec = [], []
                enc.append(len(self.tok.prompts[key]))
            else:
                dec.append(len(self.tok.decoded[key]))
        if enc:
            out.append((enc, dec))
        return out

    def model_flops(self) -> float:
        """The LM's FLOPs of the window's prompts and served tokens
        (``counts/lm.py``): each served token but the last was fed."""
        total = 0.0
        for enc, dec in self.generations():
            for p in enc:
                total += lm_counts.prefill_flops(self.c, p)
            for p, n in zip(enc, dec):
                total += lm_counts.decode_flops(self.c, p, max(n - 1, 0))
        return total

    def profiled_unit(self):
        """One more chunk for the device trace, recorded apart from the
        window's records (which the check reads): keeps the decode
        attention's launches and the prompts of its generate calls."""
        from probing_rag_tpu_torch import kernels

        window = (self.tok.prompts, self.tok.decoded, self.tok.log)
        self.tok.clear()
        self.tok.record = True
        before = kernels.LAUNCHES["decode_attention"]
        self.unit()
        self.tok.record = False
        self.trace_counts = {"decode_attention_launches":
                             kernels.LAUNCHES["decode_attention"] - before,
                             "generations": self.generations()}
        self.tok.prompts, self.tok.decoded, self.tok.log = window

    def end_to_end(self, work: int, window_s: float) -> Dict:
        return {self.work_metric: work / window_s}

    def free_program(self) -> None:
        """Drops the program's state (graphs with their caches, the engine's
        device store, the pipeline) before the reference runs; keeps the
        weights and the probers, which the benchmark made."""
        from probing_rag_tpu_torch.models import graphs

        graphs.GRAPHS.clear()
        self.pipe = self.engine = self.retriever.engine = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- the check
    def stop_index(self, prev: int, ids: np.ndarray) -> int:
        """The first served token that is a stop (EOS; a piece holding a
        blank line; a piece starting with a newline after one ending with
        one), or -1."""
        strings = self.tok.token_strings()
        for j, t in enumerate(ids.tolist()):
            s, p = strings[t], strings[prev]
            if t == self.tok.eos_id or "\n\n" in s or (p.endswith("\n") and s.startswith("\n")):
                return j
            prev = t
        return -1

    def samples(self) -> List[dict]:
        """The check's sample of the window's generations, drawn from the
        seed: ``per_round`` rows of every round's generate calls (round 0's
        short prompts and each retrieval round's long ones; rounds 1-3's
        answers are the next rounds' search queries), and the longest answer
        of the window. Each holds the prompt's ids and the served ids as the
        tokenizer saw them, the pooled captures and the gate's scores of its
        row, and how many served tokens were fed back (those the gate
        pooled). A row whose returned text no recorded prompt and decode
        explain is ``missing``."""
        rng = np.random.default_rng([self.seed % 2**63, 99])
        rows = [(c, j) for c, call in enumerate(self.calls) for j in range(len(call["prompts"]))]

        def answer_chars(row):
            call = self.calls[row[0]]
            return len(call["texts"][row[1]]) - len(call["prompts"][row[1]])

        longest = max(rows, key=answer_chars)
        picks = [longest]
        for r in sorted({call["round"] for call in self.calls}):
            pool = [row for row in rows if self.calls[row[0]]["round"] == r and row != longest]
            n = min(self.t["check"]["per_round"], len(pool))
            picks += [pool[i] for i in rng.choice(len(pool), n, replace=False)]
        max_new = self.rag.max_new_tokens
        out = []
        for c, j in picks:
            call = self.calls[c]
            prompt, text = call["prompts"][j], call["texts"][j]
            pids = self.tok.prompts.get(prompt)
            ids = self.tok.decoded.get(text[len(prompt):]) if text.startswith(prompt) else None
            if pids is None or ids is None or len(ids) == 0:
                out.append({"missing": True})
                continue
            stop = self.stop_index(int(pids[-1]), ids)
            out.append({"missing": False, "round": call["round"], "pids": pids, "ids": ids,
                        "pooled": call["pooled"][:, j], "scores": call["scores"][j],
                        "truncated": len(ids) < max_new and stop != len(ids) - 1,
                        "fed": stop if stop >= 0 else min(len(ids), max_new - 1)})
        return out

    def reference(self, s: dict) -> tuple:
        """The reference over one sample's prompt and served tokens: its
        logits at the served positions [n, V], its pooled residuals at the
        probed layers [sites, D] (the served tokens fed back), the sequence
        on the card."""
        seq = torch.as_tensor(np.concatenate([s["pids"], s["ids"]]).astype(np.int64),
                              device=self.device)
        n0 = len(s["pids"])
        logits, kept = ref_lm.forward(self.weights, self.c, seq,
                                      range(n0 - 1, n0 - 1 + len(s["ids"])), self.cfg.probe_layers)
        pooled = torch.stack([kept[l][n0:n0 + s["fed"]].sum(0) for l in self.cfg.probe_layers])
        return logits, pooled, seq

    @staticmethod
    def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> np.ndarray:
        """How far below the reference's best logit each token's lies."""
        return (logits.max(1).values - logits.gather(1, tokens[:, None])[:, 0]).cpu().numpy()

    @staticmethod
    def mean_square(gaps) -> float:
        """The mean square of the gaps over every sampled token: rounding
        flips near-ties by small gaps, and their squares stay small; a
        lower precision flips wider ones; one wrong token adds its whole
        gap squared."""
        return float(np.mean(np.concatenate(gaps) ** 2)) if gaps else 0.0

    @staticmethod
    def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """``|got - ref| / |ref|`` over the last two axes."""
        return (got - ref).flatten(-2).norm(dim=-1) / ref.flatten().norm()

    @torch.inference_mode()
    def check(self) -> Dict[str, float]:
        exact_matmuls()
        pooled_err = gate_err = 0.0
        missing = truncated = 0
        for s in self.samples():
            if s["missing"]:
                missing += 1
                continue
            truncated += int(s["truncated"])
            logits, ref_pooled, _ = self.reference(s)
            served = torch.as_tensor(s["ids"].astype(np.int64), device=self.device)
            self.diag.setdefault("gaps", []).append(self.gaps(logits, served))
            top2 = logits.topk(2, dim=1).values
            self.diag.setdefault("margins", []).append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            mine = torch.as_tensor(s["pooled"], device=self.device)
            pooled_err = max(pooled_err, float(self.rel_err(mine, ref_pooled)))
            ref_scores = ref_gate.scores(self.probers, mine).double().cpu().numpy()
            gate_err = max(gate_err, float(np.abs(ref_scores - s["scores"]).max()))
        rng = np.random.default_rng([self.seed % 2**63, 98])
        return {"lm_gap_ms": self.mean_square(self.diag.get("gaps")), "pooled_err": pooled_err,
                "gate_err": gate_err,
                "bm25_err": self.check_bm25(rng, self.t["check"]["searches"]),
                "answers_missing": missing, "answers_truncated": truncated}

    @torch.inference_mode()
    def control(self) -> Dict[str, float]:
        """The check's numbers for the control, the nearest precision below
        each stage's: the program's own int8 serving path in the LM's place
        (``quantize_lm_params(bits=8)``, w8a16 products, and an int8 KV
        cache), read at every served position of the same sequences (the
        token it puts first; its pooled residuals); the reference gate in
        bf16 on the program's own pooled rows; BM25 with bf16 impacts."""
        from probing_rag_tpu_torch.models.gemma import (CaptureSpec, forward, init_kv_cache,
                                                        quantize_lm_params)

        exact_matmuls()
        q8 = quantize_lm_params(self.weights, bits=8)
        capture = CaptureSpec(tuple((l, "resid_post") for l in self.cfg.probe_layers))
        pooled_err = gate_err = 0.0
        gaps = []
        for s in self.samples():
            if s["missing"]:
                continue
            logits, ref_pooled, seq = self.reference(s)
            n0, n = len(s["pids"]), len(s["ids"])
            kv = init_kv_cache(self.cfg, 1, len(seq), dtype=torch.int8, device=self.device)
            low, _, caps = forward(q8, seq[None], self.cfg, capture=capture, kv_cache=kv)
            first = low[0, n0 - 1:n0 - 1 + n].float().argmax(-1)
            gaps.append(self.gaps(logits, first))
            pooled = caps[:, 0, n0:n0 + s["fed"]].float().sum(1)
            pooled_err = max(pooled_err, float(self.rel_err(pooled, ref_pooled)))
            mine = torch.as_tensor(s["pooled"], device=self.device)
            exact = ref_gate.scores(self.probers, mine)
            low_gate = ref_gate.scores(self.probers, mine, torch.bfloat16)
            gate_err = max(gate_err, float((exact - low_gate).abs().max()))
        rng = np.random.default_rng([self.seed % 2**63, 98])
        self.diag["control_gaps"] = gaps
        return {"lm_gap_ms": self.mean_square(gaps), "pooled_err": pooled_err,
                "gate_err": gate_err,
                "bm25_err": self.check_bm25(rng, self.t["check"]["searches"], torch.bfloat16)}

    def reference_bm25(self) -> ReferenceBM25:
        b = self.t["bm25"]
        return ReferenceBM25(self.ranks, self.vocab.words, self.vocab.n_stop, k1=b["k1"], b=b["b"],
                             epsilon=b["epsilon"], cap=b["cap"], device=self.device)

    def check_bm25(self, rng, n: int, impact_dtype=None) -> float:
        """Over a sample of the window's searches (the longest query in it),
        the widest error of a returned document, over the reference's best
        score: its returned score against the reference's score of it, or
        its reference score short of the reference's score at its rank
        (ties cost nothing, a wrong document its gap). With
        ``impact_dtype`` (the control) the reference with impacts rounded
        to that type stands in for the engine."""
        ref = self.reference_bm25()
        calls = self.retriever.calls
        rows = [(c, r) for c, call in enumerate(calls) for r in range(len(call[0]))]
        widest = max(range(len(rows)), key=lambda i: len(calls[rows[i][0]][0][rows[i][1]]))
        rest = [i for i in range(len(rows)) if i != widest]
        picks = [widest] + rng.choice(rest, min(n - 1, len(rest)), replace=False).tolist()
        kept_by_call: Dict[int, list] = {}
        worst = 0.0
        for i in picks:
            c, r = rows[i]
            queries, docs, scores = calls[c]
            if c not in kept_by_call:
                kept_by_call[c] = ref.kept_terms(queries)
            exact = ref.scores(kept_by_call[c][r])
            k = docs.shape[1]
            best = torch.topk(exact, k).values
            if impact_dtype is None:
                got_docs = torch.as_tensor(docs[r].astype(np.int64), device=exact.device)
                got_scores = torch.as_tensor(scores[r].astype(np.float64), device=exact.device)
            else:
                low = ref.scores(kept_by_call[c][r], impact_dtype)
                got_scores, got_docs = torch.topk(low, k)
            found = got_docs >= 0
            truth = torch.where(found, exact[got_docs.clamp(min=0)], torch.zeros_like(best))
            err = torch.maximum(best - truth, torch.where(found, (got_scores - truth).abs(),
                                                          torch.zeros_like(best)))
            if float(best[0]) > 0:
                worst = max(worst, float(err.max()) / float(best[0]))
        return worst

