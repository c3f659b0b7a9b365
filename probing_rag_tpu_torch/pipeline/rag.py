"""The adaptive probe -> retrieve -> regenerate loop.

Port of ``probing_rag_tpu/pipeline/rag.py`` (modes ``none``, ``simple``,
``probing``, plus ``run_resumable`` with the same manifest format).
Control flow parity (exp_rag.py:394-531):

- round 0: CoT generation with no retrieval; the prober gate decides whether
  any retrieval happens.
- retrieval rounds: the search query is the original question on round 0 and
  the *full previous generation text* afterwards; top-k passages are
  formatted as the ``passage i:`` block into ``retr_qa_cot2``; the model
  regenerates; the gate re-decides. ``retr_count`` increments at most to 3
  and a 4th retrieval round runs before the hard break.
- the recorded prediction is the initial generation when the gate never
  fired and the *last* regeneration otherwise.

Queries run in batches of ``batch_size`` (the last one padded by repeating
its final prompt, as the JAX pipeline does) and only the shrinking active
set crosses rounds.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.data import prompts
from probing_rag_tpu_torch.models.decode import StopTables, generate
from probing_rag_tpu_torch.models.gemma import CaptureSpec, GemmaConfig
from probing_rag_tpu_torch.models.speculative import SpecConfig
from probing_rag_tpu_torch.prober.gate import gate_decision
from probing_rag_tpu_torch.utils.logging import get_logger
from probing_rag_tpu_torch.utils.profiling import RECORDER

logger = get_logger(__name__)


@dataclass(frozen=True)
class RAGConfig:
    retr_method: str = "probing"  # probing | none | simple
    threshold: float = 0.0
    ablation: int = 0
    top_k: int = 5
    max_new_tokens: int = 150  # CoT setting, exp_rag.py:234
    max_extra_rounds: int = 3  # retr_count cap: 4 rounds total
    batch_size: int = 8
    position: str = "resid_post"
    kv_int8: bool = False  # int8 KV cache
    kv_int4: bool = False  # int4 KV cache (exclusive with kv_int8)
    # speculative decode (greedy-exact, models/speculative.py): verify
    # spec_k prompt-lookup drafts per forward; 0 = off
    spec_k: int = 0
    spec_drafter: str = "prompt"
    # the JAX pipeline's two-program serving path, an XLA workaround that
    # is not ported: setting it raises in AdaptiveRAGPipeline
    split_prefill: bool = False


@dataclass
class RAGResult:
    pred_list: List[str]
    retr_count_list: List[int]
    gate_scores: List[Optional[np.ndarray]] = field(default_factory=list)


class AdaptiveRAGPipeline:
    def __init__(
        self,
        lm_params,
        cfg: GemmaConfig,
        tokenizer,
        retriever,  # .search(queries, k) -> result with .doc_indices
        docstore,  # .texts(indices) -> List[str]
        prober_stack=None,  # stacked prober params (probing method)
        rag: RAGConfig = RAGConfig(),
    ):
        if rag.split_prefill:
            raise NotImplementedError("RAGConfig split_prefill (an XLA workaround) is not ported")
        self.lm_params = lm_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.retriever = retriever
        self.docstore = docstore
        self.prober_stack = prober_stack
        self.rag = rag
        self.capture = CaptureSpec(tuple((l, rag.position) for l in cfg.probe_layers))
        self.stop_tables = StopTables.from_token_strings(tokenizer.token_strings())
        self.spec = SpecConfig(k=rag.spec_k, drafter=rag.spec_drafter) if rag.spec_k else None

    # ------------------------------------------------------------ helpers
    def _generate(self, prompt_texts: Sequence[str], with_capture: bool):
        """Batched generation padded to the configured batch size. Each
        batch is an ``lm.generate`` span that counts its pad rows, whose
        live steps it takes out of its ``lm.decode`` span's."""
        n = len(prompt_texts)
        bs = self.rag.batch_size
        texts_out: List[str] = []
        pooled_out: List[np.ndarray] = []
        capture = self.capture if with_capture else CaptureSpec()
        for start in range(0, n, bs):
            chunk = list(prompt_texts[start : start + bs])
            pad = bs - len(chunk)
            padded = chunk + [chunk[-1]] * pad
            with RECORDER.span("lm.generate", rows=bs, pad_rows=pad):
                texts, result = generate(
                    self.lm_params, self.cfg, self.tokenizer, padded,
                    max_new_tokens=self.rag.max_new_tokens,
                    capture=capture, stop_tables=self.stop_tables,
                    kv_int8=self.rag.kv_int8, kv_int4=self.rag.kv_int4, spec=self.spec,
                )
                if pad:
                    RECORDER.last("lm.decode").count(live=-int(result.n_pooled[len(chunk):].sum()))
            texts_out.extend(texts[: len(chunk)])
            if with_capture:
                pooled_out.append(result.pooled_captures[:, : len(chunk), :])
        pooled = np.concatenate(pooled_out, axis=1) if pooled_out else None
        return texts_out, pooled

    def _gate(self, pooled: np.ndarray):
        dev = self.prober_stack["fc1"]["w"].device
        with RECORDER.span("rag.gate", rows=pooled.shape[1]), torch.inference_mode():
            retrieve, scores = gate_decision(
                self.prober_stack, torch.from_numpy(pooled).to(dev),
                threshold=self.rag.threshold, ablation=self.rag.ablation,
            )
            return retrieve.cpu().numpy(), scores.cpu().numpy()

    def retrieval_prompts(
        self, questions: Sequence[str], search_queries: Sequence[str]
    ) -> List[str]:
        """Search the top-k passages for each of ``search_queries`` and
        render the regeneration prompt of the matching question over them."""
        with RECORDER.span("rag.retrieve", queries=len(search_queries)):
            result = self.retriever.search(list(search_queries), k=self.rag.top_k)
            out = []
            for q, row in zip(questions, result.doc_indices):
                passages = self.docstore.texts([int(d) for d in row if d >= 0])
                out.append(prompts.retr_qa_cot2(q, prompts.format_evidences(passages)))
            return out

    # -------------------------------------------------------------- modes
    def run(self, questions: Sequence[str]) -> RAGResult:
        method = self.rag.retr_method
        with RECORDER.span("rag.run", questions=len(questions)):
            if method == "none":
                return self._run_none(questions)
            if method == "simple":
                return self._run_simple(questions)
            if method == "probing":
                return self._run_probing(questions)
        raise ValueError(f"unknown retr_method {method!r}")

    def _run_none(self, questions: Sequence[str]) -> RAGResult:
        texts, _ = self._generate([prompts.cot_prompt(q) for q in questions], False)
        return RAGResult(texts, [0] * len(texts))

    def _run_simple(self, questions: Sequence[str]) -> RAGResult:
        texts, _ = self._generate(self.retrieval_prompts(questions, questions), False)
        return RAGResult(texts, [1] * len(texts))

    def _run_probing(self, questions: Sequence[str]) -> RAGResult:
        if self.prober_stack is None:
            raise ValueError("probing method needs a trained prober stack")
        n = len(questions)
        preds: List[Optional[str]] = [None] * n
        retr_counts = [0] * n
        gate_scores: List[Optional[np.ndarray]] = [None] * n

        # round 0: no-retrieval CoT + gate
        texts, pooled = self._generate([prompts.cot_prompt(q) for q in questions], True)
        retrieve, scores = self._gate(pooled)
        for i in range(n):
            gate_scores[i] = scores[i]
            if not retrieve[i]:
                preds[i] = texts[i]
        active = [i for i in range(n) if retrieve[i]]
        last_gen = {i: texts[i] for i in active}
        logger.info("gate round 0: %d/%d queries retrieve", len(active), n)

        # retrieval rounds: a 4th round runs, then the loop hard-breaks;
        # retr_count is capped at max_extra_rounds
        for round_idx in range(self.rag.max_extra_rounds + 1):
            if not active:
                break
            search_queries = [questions[i] if round_idx == 0 else last_gen[i] for i in active]
            prompt_texts = self.retrieval_prompts([questions[i] for i in active], search_queries)
            texts, pooled = self._generate(prompt_texts, True)
            retrieve, scores = self._gate(pooled)

            next_active = []
            for j, i in enumerate(active):
                last_gen[i] = texts[j]
                gate_scores[i] = scores[j]
                if round_idx < self.rag.max_extra_rounds:
                    retr_counts[i] += 1
                if retrieve[j] and round_idx < self.rag.max_extra_rounds:
                    next_active.append(i)
                else:
                    preds[i] = texts[j]
            active = next_active
            logger.info("gate round %d: %d queries still retrieving", round_idx + 1, len(active))

        if any(p is None for p in preds):
            raise RuntimeError("a query left the loop without a prediction")
        return RAGResult(list(preds), retr_counts, gate_scores)

    # --------------------------------------------------------- resumability
    def run_resumable(
        self, questions: Sequence[str], manifest_path, chunk_size: int = 64
    ) -> RAGResult:
        """Questions run in fixed chunks; each chunk's results append to a
        JSONL manifest keyed by query index, and a rerun skips completed
        chunks (the JAX pipeline's manifest format)."""
        manifest_path = Path(manifest_path)
        manifest_path.parent.mkdir(parents=True, exist_ok=True)
        done: dict = {}
        if manifest_path.exists():
            for line in manifest_path.read_text().splitlines():
                if line.strip():
                    rec = json.loads(line)
                    done[rec["i"]] = rec

        preds: List[Optional[str]] = [None] * len(questions)
        counts = [0] * len(questions)
        scores: List[Optional[np.ndarray]] = [None] * len(questions)
        with manifest_path.open("a") as f:
            for start in range(0, len(questions), chunk_size):
                idxs = list(range(start, min(start + chunk_size, len(questions))))
                if all(i in done for i in idxs):
                    for i in idxs:
                        preds[i] = done[i]["pred"]
                        counts[i] = done[i]["retr_count"]
                        gs = done[i].get("gate_scores")
                        scores[i] = None if gs is None else np.asarray(gs)
                    continue
                chunk_result = self.run([questions[i] for i in idxs])
                for j, i in enumerate(idxs):
                    preds[i] = chunk_result.pred_list[j]
                    counts[i] = chunk_result.retr_count_list[j]
                    gs = chunk_result.gate_scores[j] if j < len(chunk_result.gate_scores) else None
                    scores[i] = gs
                    f.write(json.dumps({
                        "i": i,
                        "pred": preds[i],
                        "retr_count": counts[i],
                        "gate_scores": None if gs is None else np.asarray(gs).tolist(),
                    }) + "\n")
                f.flush()
        return RAGResult(list(preds), counts, scores)
