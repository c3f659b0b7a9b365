"""Comparison baselines: DRAGIN, FLARE, fix-length and fix-sentence RAG,
and the LLM-as-classifier gate.

Port of ``probing_rag_tpu/pipeline/baselines.py``, with the same
semantics. Generation runs through the port's batched decode (``generate``
with no captures and no paragraph stop); one more forward over the
generated ids returns the last layer's attention probs and the logits, from
which ``traced_generate`` derives per-word attention received, entropy and
chosen-token logprob. Everything downstream (sentence splits, word merging,
hallucination scoring, query reformulation) is host-side text work.

The JAX trace forwards pad the ids to a power of two to bound the number
of compiled programs; PyTorch compiles nothing, so here they run at the
exact length (the values are the same: pad slots are masked keys and pad
rows are cut).

spaCy: the reference splits sentences and filters "real words" by POS with
en_core_web_sm. spaCy is used when it and its model load; otherwise a
regex sentencizer and a stopword/shape content-word filter stand in (the
fallback is pinned by ``tests/fixtures/pos_content_golden.json``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from probing_rag_tpu_torch.data import prompts
from probing_rag_tpu_torch.models.decode import StopTables, generate
from probing_rag_tpu_torch.models.gemma import CaptureSpec, GemmaConfig, Params, forward
from probing_rag_tpu_torch.retrieval.text import ENGLISH_STOPWORDS

# ------------------------------------------------------------ text utils

_SENT_RE = re.compile(r"[^.!?]*[.!?]+(?:\s|$)|[^.!?]+$")


def _spacy_nlp():
    try:
        import spacy

        return spacy.load("en_core_web_sm")
    except (ImportError, OSError):  # no spaCy, or no model to load
        return None


_NLP = None


def _nlp():
    global _NLP
    if _NLP is None:
        _NLP = _spacy_nlp() or False
    return _NLP


def sentencize(text: str) -> List[str]:
    nlp = _nlp()
    if nlp:
        return [s.text.strip() for s in nlp(text).sents if s.text.strip()]
    return [m.group().strip() for m in _SENT_RE.finditer(text) if m.group().strip()]


# Closed-class words the stopword list misses but spaCy's POS filter drops:
# conjunct/degree/manner adverbs and a few prepositions/pronouns. A finite
# list rather than an "-ly" suffix rule, which would drop -ly nouns (Italy,
# family, July, supply): a dropped content term is lost to retrieval, a kept
# adverb adds one low-value query term.
_FALLBACK_NONCONTENT = frozenset("""
however therefore thus hence moreover furthermore meanwhile instead
otherwise almost always never often sometimes seldom soon already still
yet again twice once perhaps maybe indeed also quite rather somewhat
despite near none well anyway anywhere everywhere somewhere nowhere
together apart aside else ever even away less least enough ago
quickly slowly carefully easily really actually finally usually normally
generally typically especially particularly specifically recently
currently previously originally eventually ultimately approximately
nearly mostly mainly largely highly widely commonly frequently rarely
hardly barely simply merely exactly directly immediately quietly loudly
badly strongly completely entirely totally fully partly partially
significantly slightly extremely incredibly surprisingly interestingly
importantly notably honestly sadly unfortunately fortunately certainly
probably possibly clearly obviously apparently suddenly gradually
rapidly steadily constantly continuously regularly occasionally
officially formally initially subsequently similarly
""".split())


def content_words(text: str) -> set:
    """The reference's NOUN/ADJ/VERB/PROPN/NUM filter; the fallback keeps
    numbers and the non-stopword words of more than two characters outside
    the closed-class list above."""
    nlp = _nlp()
    if nlp:
        return {t.text for t in nlp(text) if t.pos_ in ("NOUN", "ADJ", "VERB", "PROPN", "NUM")}
    words = re.findall(r"\w+", text)
    return {
        w
        for w in words
        if w.isdigit()
        or (
            w.lower() not in ENGLISH_STOPWORDS
            and w.lower() not in _FALLBACK_NONCONTENT
            and len(w) > 2
        )
    }


# ------------------------------------------------------- traced generation


@dataclass
class GenerationTrace:
    text: str  # generated text (no prompt)
    words: List[str]  # merged word-level units
    word_attn: List[float]  # attention received per word (last layer)
    word_entropy: List[float]  # mean next-token entropy per word
    word_logprob: List[float]  # mean chosen-token logprob per word


def _merge_tokens_to_words(token_texts: List[str]) -> List[Tuple[int, int]]:
    """Group consecutive token strings into word ranges: a new word starts on
    a leading space/newline or after one (the reference's space rule)."""
    ranges: List[Tuple[int, int]] = []
    prev_ends_space = True
    for i, t in enumerate(token_texts):
        starts_new = t.startswith(" ") or t.startswith("\n") or prev_ends_space
        if i == 0 or starts_new:
            ranges.append((i, i))
        else:
            ranges[-1] = (ranges[-1][0], i)
        prev_ends_space = t.endswith(" ") or t.endswith("\n")
    return ranges


def _generate_one(lm_params: Params, cfg: GemmaConfig, tokenizer, prompt: str,
                  max_new_tokens: int):
    """Greedy generation of one prompt, no captures, no paragraph stop."""
    texts, result = generate(
        lm_params, cfg, tokenizer, [prompt],
        max_new_tokens=max_new_tokens, capture=CaptureSpec(),
        stop_tables=StopTables.disabled(tokenizer.vocab_size),
    )
    return texts[0], result


def forward_with_attn(lm_params: Params, ids: torch.Tensor, valid: torch.Tensor,
                      cfg: GemmaConfig):
    """The forward that also returns the LAST layer's attention probs (the
    reference reads ``.attentions[-1]``): (logits, None, None, probs
    [B, H, T, T] f32). ``valid`` [B, T] masks key slots."""
    with torch.inference_mode():
        return forward(lm_params, ids, cfg, attn_valid=valid, attn_probs_layer=-1)


def _ids_tensor(lm_params: Params, ids: Sequence[int]):
    dev = lm_params["final_norm"].device
    t = torch.tensor([list(ids)], dtype=torch.int64, device=dev)
    return t, torch.ones(t.shape, dtype=torch.bool, device=dev)


def trace_ids(lm_params: Params, cfg: GemmaConfig, tokenizer, gen_ids: Sequence[int],
              attn_solver: str = "max") -> Tuple[List[str], List[float], List[float], List[float]]:
    """Per-word (words, attention received, entropy, logprob) of the
    generated ids ``gen_ids``, from one forward over them alone (the prompt
    is not part of it, as in the reference)."""
    ids, valid = _ids_tensor(lm_params, gen_ids)
    logits, _, _, probs = forward_with_attn(lm_params, ids, valid, cfg)
    n = len(gen_ids)
    probs = probs[0].float().cpu().numpy()  # [H, T, T]
    # attention received per token: max over query positions, mean over heads
    if attn_solver == "max":
        received = probs.max(axis=1).mean(axis=0)  # [T]
    else:
        received = probs.sum(axis=1).mean(axis=0)
        received /= np.maximum(n - np.arange(n), 1)

    logp = torch.log_softmax(logits[0].float(), dim=-1).cpu().numpy()  # [T, V]
    p = np.exp(logp)
    entropy = -(p * logp).sum(-1)  # [T] next-token entropies
    # chosen-token logprob: token t+1's logprob comes from position t
    chosen = np.zeros(n, np.float32)
    for t in range(1, n):
        chosen[t] = float(logp[t - 1, gen_ids[t]])

    token_texts = [tokenizer.decode([i]) for i in gen_ids]
    words, w_at, w_en, w_lp = [], [], [], []
    for lo, hi in _merge_tokens_to_words(token_texts):
        word = "".join(token_texts[lo : hi + 1]).strip()
        if word:
            words.append(word)
            w_at.append(float(received[lo : hi + 1].sum()))
            w_en.append(float(entropy[lo : hi + 1].mean()))
            w_lp.append(float(chosen[lo : hi + 1].mean()))
    return words, w_at, w_en, w_lp


def traced_generate(
    lm_params: Params,
    cfg: GemmaConfig,
    tokenizer,
    prompt: str,
    max_new_tokens: int,
    attn_solver: str = "max",
) -> GenerationTrace:
    """Generate greedily, then trace the generated ids with one forward that
    returns the last layer's attention and the logits."""
    text, result = _generate_one(lm_params, cfg, tokenizer, prompt, max_new_tokens)
    n = int(result.n_generated[0])
    gen_ids = [int(t) for t in result.tokens[0, :n]]
    if not gen_ids:
        return GenerationTrace("", [], [], [], [])
    words, w_at, w_en, w_lp = trace_ids(lm_params, cfg, tokenizer, gen_ids, attn_solver)
    return GenerationTrace(text[len(prompt):], words, w_at, w_en, w_lp)


# ------------------------------------------------------------- baselines


@dataclass
class BaselineCounter:
    """Retrieval and generation accounting (the reference's counter)."""

    retrieve: int = 0
    generate: int = 0
    hallucinated: int = 0
    token: int = 0
    sentence: int = 0


@dataclass
class BaselineConfig:
    generate_max_length: int = 150
    hallucination_threshold: float = 1.2
    query_formulation: str = "real_words"  # DRAGIN default
    retrieve_keep_top_k: int = 25
    check_real_words: bool = True
    flare_threshold: float = 0.4  # low-confidence sentence trigger
    top_k: int = 5
    max_rounds: int = 8  # safety cap on the while loops


class BaselineRAG:
    """Shared plumbing: retriever, docstore and traced generator."""

    def __init__(self, lm_params, cfg, tokenizer, retriever, docstore,
                 bc: Optional[BaselineConfig] = None):
        self.lm_params = lm_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.retriever = retriever
        self.docstore = docstore
        self.bc = bc or BaselineConfig()
        self.counter = BaselineCounter()

    def _retrieve(self, query: str) -> List[str]:
        self.counter.retrieve += 1
        res = self.retriever.search([query], k=self.bc.top_k)
        return self.docstore.texts([int(d) for d in res.doc_indices[0] if d >= 0])

    def _gen(self, prompt: str, trace: bool = False) -> GenerationTrace:
        self.counter.generate += 1
        if trace:
            out = traced_generate(self.lm_params, self.cfg, self.tokenizer, prompt,
                                  self.bc.generate_max_length)
        else:
            text, _ = _generate_one(self.lm_params, self.cfg, self.tokenizer, prompt,
                                    self.bc.generate_max_length)
            out = GenerationTrace(text[len(prompt):], [], [], [], [])
        self.counter.token += len(self.tokenizer.encode(out.text))
        self.counter.sentence += len(sentencize(out.text))
        return out

    def _context_prompt(self, demo: str, docs: Sequence[str], case: str) -> str:
        """The DRAGIN-family regeneration prompt."""
        ctx = "".join(f"[{i + 1}] {d}\n" for i, d in enumerate(docs))
        return f"{demo}Context:\n{ctx}Answer in the same format as before.\n{case}"

    def _done(self, text: str, old_len: int) -> bool:
        """The loops' stop: over the length budget, no growth, or an answer."""
        n_tok = len(self.tokenizer.encode(text))
        return (n_tok > self.bc.generate_max_length or len(text) <= old_len
                or "the answer is" in text)


class DraginRAG(BaselineRAG):
    """DRAGIN (the reference's AttnWeightRAG): sentence-level hallucination
    detection by attention x entropy, attention-guided query reformulation,
    retrieve and regenerate."""

    def modifier(self, trace: GenerationTrace):
        """Find the first hallucinated sentence. Returns (hallucinated,
        prev_text, curr_words, hit_flags)."""
        sentences = sentencize(trace.text)
        n = len(trace.words)
        # the reference's spans: scan forward until the joined word window
        # CONTAINS the sentence; the last sentence takes every remaining
        # word. Counting words instead would stay skewed after a
        # punctuation-merged word; the substring scan resyncs (an unmatched
        # sentence gets an empty span and is skipped).
        spans = []
        tid = 0
        for sid, sent in enumerate(sentences):
            tl, tr = tid, tid
            if sid == len(sentences) - 1:
                tl, tr = tid, n
            else:
                for i in range(tid + 1, n):
                    if sent in " ".join(trace.words[tl:i]):
                        tr = i
                        break
                tid = tr
            spans.append((tl, tr))
        for (tl, tr), sent in zip(spans, sentences):
            if tr <= tl:
                continue
            attns = np.asarray(trace.word_attn[tl:tr], np.float64)
            total = attns.sum() or 1.0
            attns = attns / total
            weight = np.asarray(trace.word_entropy[tl:tr], np.float64)
            value = attns * weight * (tr - tl)
            hits = (value > self.bc.hallucination_threshold).astype(int)
            if hits.any():
                if self.bc.check_real_words:
                    real = content_words(sent)
                    for i in range(len(hits)):
                        if not any(wd in trace.words[tl + i] for wd in real):
                            hits[i] = 0
                sid = sentences.index(sent)
                prev = "" if sid == 0 else " ".join(sentences[:sid])
                return True, prev, trace.words[tl:tr], hits.tolist()
        return False, trace.text, None, None

    def keep_real_words(self, prev_text: str, curr_words: List[str], hits: List[int]) -> str:
        """Attention-weighted content-word query: score each word by the
        attention the hallucinated words pay to it, keep the top-k content
        words in document order."""
        all_text = prev_text + " " + " ".join(curr_words)
        ids = self.tokenizer.encode(all_text)
        if not ids:
            return prev_text
        ids_t, valid = _ids_tensor(self.lm_params, ids)
        _, _, _, probs = forward_with_attn(self.lm_params, ids_t, valid, self.cfg)
        probs = probs[0].float().cpu().numpy().mean(axis=0)  # [T, T] mean over heads
        token_texts = [self.tokenizer.decode([i]) for i in ids]
        ranges = _merge_tokens_to_words(token_texts)
        words = ["".join(token_texts[lo:hi + 1]).strip() for lo, hi in ranges]
        curr_st = len(words) - len(curr_words)

        # attention received by each word FROM the hallucinated words
        scores = np.zeros(len(words))
        hit_cnt = 0
        for i, h in enumerate(hits):
            if not h or curr_st + i >= len(ranges):
                continue
            lo, hi = ranges[curr_st + i]
            row = probs[lo:hi + 1, :].mean(axis=0)  # [T]
            scores += np.asarray([row[l:h2 + 1].sum() for l, h2 in ranges])
            hit_cnt += 1
        if hit_cnt:
            scores /= hit_cnt

        real = content_words(all_text)
        pairs = [
            (scores[i], words[i], i)
            for i in range(len(words))
            if words[i]
            and not (i >= curr_st and curr_st >= 0 and i - curr_st < len(hits) and hits[i - curr_st])
            and any(wd in words[i] for wd in real)
        ]
        pairs.sort(key=lambda x: x[0], reverse=True)
        pairs = sorted(pairs[: self.bc.retrieve_keep_top_k], key=lambda x: x[2])
        return " ".join(p[1] for p in pairs)

    def inference(self, question: str, demo: str, case: str) -> str:
        text = ""
        for _ in range(self.bc.max_rounds):
            old_len = len(text)
            prompt = demo + " ".join(s for s in (case, text) if s)
            trace = self._gen(prompt, trace=True)
            hallucinated, ptext, curr_words, hits = self.modifier(trace)
            if not hallucinated:
                text = (text.strip() + " " + trace.text.strip()).strip()
            else:
                self.counter.hallucinated += 1
                forward_all = " ".join(s for s in (question, text, ptext) if s)
                if self.bc.query_formulation == "real_words":
                    query = self.keep_real_words(
                        question + " " + text + " " + ptext, curr_words, hits
                    )
                elif self.bc.query_formulation == "current":
                    query = " ".join(curr_words)
                else:  # "forward_all", and the reference's default
                    query = forward_all
                docs = self._retrieve(query)
                case_text = " ".join(s for s in (case, text, ptext.strip()) if s)
                regen = self._gen(self._context_prompt(demo, docs, case_text))
                sents = sentencize(regen.text)
                first = sents[0] if sents else ""
                text = " ".join(s for s in (text.strip(), ptext.strip(), first) if s)
            if self._done(text, old_len):
                break
        return text


class FixLengthRAG(BaselineRAG):
    """fix-length-retrieval / fix-sentence: retrieve before every
    generation chunk, keeping the whole chunk or its first sentence."""

    def __init__(self, *args, method: str = "fix-length-retrieval", **kw):
        super().__init__(*args, **kw)
        self.method = method

    def inference(self, question: str, demo: str, case: str) -> str:
        text = ""
        query = question
        for _ in range(self.bc.max_rounds):
            old_len = len(text)
            docs = self._retrieve(query)
            out = self._gen(self._context_prompt(demo, docs, case + " " + text))
            new_text = out.text.strip()
            if self.method == "fix-length-retrieval":
                text = (text.strip() + " " + new_text).strip()
                query = new_text
            else:  # fix-sentence
                sents = sentencize(new_text)
                if not sents:
                    break
                text = (text.strip() + " " + sents[0]).strip()
                query = sents[0]
            if self._done(text, old_len):
                break
        return text


class FlareRAG(BaselineRAG):
    """FLARE: regenerate low-confidence sentences with retrieved passages."""

    def inference(self, question: str, demo: str, case: str) -> str:
        text = ""
        for _ in range(self.bc.max_rounds):
            old_len = len(text)
            prompt = demo + " ".join(s for s in (case, text) if s)
            trace = self._gen(prompt, trace=True)
            sents = sentencize(trace.text)
            if not sents:
                break
            # confidence of the first sentence = its least word probability
            first = sents[0]
            n_words = len(first.split())
            word_probs = np.exp(np.asarray(trace.word_logprob[:n_words] or [0.0]))
            if word_probs.size and word_probs.min() < self.bc.flare_threshold:
                # mask low-confidence words, reformulate, retrieve, regenerate
                masked = " ".join(
                    "____" if i < len(word_probs) and word_probs[i] < self.bc.flare_threshold
                    else w
                    for i, w in enumerate(first.split())
                )
                q_out = self._gen(prompts.flare_query_reformulation_prompt(question, masked))
                q_sents = sentencize(q_out.text)
                query = q_sents[0] if q_sents else masked
                docs = self._retrieve(query)
                regen = self._gen(
                    prompts.flare_for_new_sent_prompt(first, prompts.format_evidences(docs))
                )
                regen_sents = sentencize(regen.text)
                first = regen_sents[0] if regen_sents else first
            text = (text.strip() + " " + first).strip()
            if self._done(text, old_len):
                break
        return text


class LLMClassifierGate:
    """LLM-as-retrieval-classifier baseline: few-shot prompt the LM itself to
    say whether it can answer without retrieval (the 'LLM-based' row of the
    paper's retrieval-call table)."""

    def __init__(self, lm_params, cfg, tokenizer, max_new_tokens: int = 4):
        self.lm_params = lm_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens

    def needs_retrieval(self, questions: Sequence[str]) -> List[bool]:
        """One batched generation over every question's prompt."""
        prompts_ = [prompts.llm_based_clf_prompt(q) for q in questions]
        texts, _ = generate(
            self.lm_params, self.cfg, self.tokenizer, prompts_,
            max_new_tokens=self.max_new_tokens, capture=CaptureSpec(),
            stop_tables=StopTables.disabled(self.tokenizer.vocab_size),
        )
        # "1" == can answer -> no retrieval; anything else retrieves
        return ["1" not in t[len(p):].split("\n")[0] for p, t in zip(prompts_, texts)]
