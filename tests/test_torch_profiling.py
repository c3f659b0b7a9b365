"""The port's recorder of spans and counts (``utils/profiling.py``) on the
CPU: nesting, parents and roots, self time, the ring's bound, counts summed
over a window of the host clock, the profiler ranges on the trace's clock;
and the counts the program's layers attach, on the tiny configs: a generate
call's slots, valid tokens, row-steps and live row-steps, the pipeline's
pad rows, the encoder's slots and valid tokens, BM25's search, a graph
cache hit and ``tensorize_examples``."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.lib.trace import summarize
from probing_rag_tpu_torch.models import decode as td
from probing_rag_tpu_torch.models import encoder as te
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models import graphs
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.pipeline import rag as trag
from probing_rag_tpu_torch.prober.train import ProberExample, tensorize_examples
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.retrieval.dense import WINDOW_BATCHES, DenseIndex
from probing_rag_tpu_torch.utils.profiling import RECORDER, Recorder

torch.set_num_threads(1)

CFG = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)
PROMPTS = ["the cat sat on the mat", "ab ab ab", "hello there, a longer prompt than the rest"]


@pytest.fixture(scope="module")
def lm():
    return tg.init_params(CFG, torch.Generator().manual_seed(3), device="cpu"), ByteTokenizer()


def spans_since(t0_ns: int):
    return [s for s in RECORDER.ring if s.start_ns >= t0_ns]


def only(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, [s.name for s in spans]
    return found[0]


# ------------------------------------------------------------- the recorder
def test_spans_nest_with_parents_and_roots():
    rec = Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        with rec.span("d") as d:
            pass
    with rec.span("e") as e:
        pass
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.id, b.id, a.id, None)
    assert {s.root for s in (a, b, c, d)} == {a.id} and e.root == e.id
    assert [s.name for s in rec.ring] == ["c", "b", "d", "a", "e"]  # in the order they closed


def test_self_time_leaves_out_the_children():
    rec = Recorder()
    with rec.span("outer") as outer:
        time.sleep(0.01)
        with rec.span("inner") as inner:
            with rec.span("leaf"):
                time.sleep(0.02)
    assert outer.child_ns == inner.end_ns - inner.start_ns
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds, abs=1e-9)
    assert 0.01 <= outer.self_seconds < outer.seconds - 0.02
    assert rec.report()["outer"]["self_s"] == round(outer.self_seconds, 4)


def test_ring_is_bounded_and_totals_count_everything():
    rec = Recorder(ring=4)
    made = []
    for i in range(10):
        with rec.span("x", rows=i) as s:
            made.append(s)
    assert list(rec.ring) == made[-4:]
    r = rec.report()["x"]
    assert r["count"] == 10 and r["counts"] == {"rows": 45}


def test_window_sums_the_spans_inside_it():
    rec = Recorder()
    with rec.span("x", rows=1):
        pass
    t0 = time.perf_counter()
    with rec.span("x", rows=2, slots=8) as a:
        with rec.span("y"):
            time.sleep(0.002)
    with rec.span("x", rows=3) as b:
        pass
    b.count(live=5)  # read after the span, as a decode's live rows are
    t1 = time.perf_counter()
    with rec.span("x", rows=4):
        pass
    w = rec.window("x", t0, t1)
    assert w.spans == 2 and w.counts == {"rows": 5, "slots": 8, "live": 5}
    assert w.seconds == pytest.approx(a.seconds + b.seconds, abs=1e-9)
    assert w.self_seconds == pytest.approx(a.self_seconds + b.self_seconds, abs=1e-9)
    assert w.self_seconds < w.seconds - 0.002
    assert w.device_seconds is None  # no CUDA events on the CPU
    assert rec.window("z", t0, t1).spans == 0
    assert rec.report()["x"]["counts"] == {"rows": 10, "slots": 8, "live": 5}


def test_last_is_per_thread():
    rec = Recorder()
    with rec.span("x") as first:
        pass
    with rec.span("x") as second:
        pass
    seen = []
    t = threading.Thread(target=lambda: seen.append(rec.last("x")))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert rec.last("x") is second is not first and seen == [None]


def test_no_profiler_range_without_a_profiler():
    rec = Recorder()
    with rec.span("x", device=torch.device("cpu")) as s:
        assert s._range is None and s._events is None


# ------------------------------------------------------- the trace's clock
def test_spans_are_profiler_ranges_on_the_trace_clock(lm):
    """Under ``torch.profiler`` each span of a generate call is a range of
    its name, placed by the recorder's anchor within 0.5 ms; the benchmark's
    trace reader, given those ranges, puts an idle gap inside ``lm.prepare``
    down to ``lm.prepare``."""
    from torch.profiler import ProfilerActivity, profile

    params, tok = lm
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.generate(params, CFG, tok, PROMPTS, max_new_tokens=3)
    mine = spans_since(t0)
    names = {"lm.prepare", "lm.prefill", "lm.decode", "lm.readback", "lm.detokenize"}
    assert {s.name for s in mine} == names
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in names]
    assert len(ranges) == len(mine)
    for s in mine:
        _, start, end = next(r for r in ranges if r[0] == s.name)
        assert abs(RECORDER.to_trace_ns(s.start_ns) - start) < 500_000
        assert abs(RECORDER.to_trace_ns(s.end_ns) - end) < 500_000
    lo = min(r[1] for r in ranges) - 1000
    hi = max(r[2] for r in ranges) + 1000
    _, p0, p1 = next(r for r in ranges if r[0] == "lm.prepare")
    device = [("k", lo, p0 + 100), ("k", p1 - 100, hi)]  # the card idles inside lm.prepare
    t = summarize(device, [("unit", lo, hi)] + ranges)
    assert [name for name, _ in t.gaps] == ["lm.prepare"]


# ------------------------------------------------------ the program's counts
def test_generate_counts_slots_valid_and_row_steps(lm, monkeypatch):
    params, tok = lm
    steps = []
    run = graphs.Loop.run

    def counting_run(self, *a, **k):
        n = run(self, *a, **k)
        steps.append(self.steps)
        return n

    monkeypatch.setattr(graphs.Loop, "run", counting_run)
    t0 = time.perf_counter_ns()
    _, result = td.generate(params, CFG, tok, PROMPTS, max_new_tokens=6)
    mine = spans_since(t0)
    assert [s.name for s in mine] == ["lm.prepare", "lm.prefill", "lm.decode", "lm.readback",
                                      "lm.detokenize"]
    tokens, valid = td._pad_batch([tok.encode(p, add_bos=True) for p in PROMPTS], tok.pad_id)
    pre, dec = only(mine, "lm.prefill"), only(mine, "lm.decode")
    assert pre.counts == {"rows": 3, "slots": tokens.size, "valid": int(valid.sum())}
    assert len(steps) == 1 and 0 < steps[0] <= 5
    assert dec.counts["steps"] == steps[0] and dec.counts["row_steps"] == 3 * steps[0]
    assert dec.counts["live"] == int(result.n_pooled.sum()) <= dec.counts["row_steps"]
    assert dec.counts["checks"] >= 1


def test_pipeline_counts_pad_rows_and_takes_out_their_steps(lm, monkeypatch):
    """5 prompts at batch 8: 3 pad rows, whose live steps leave the
    decode's count; the generate spans lie under the ``rag.run`` root."""
    params, tok = lm
    results = []
    generate = trag.generate

    def keeping(*a, **k):
        out = generate(*a, **k)
        results.append(out[1])
        return out

    monkeypatch.setattr(trag, "generate", keeping)
    rag = trag.RAGConfig(retr_method="none", max_new_tokens=5, batch_size=8)
    pipe = trag.AdaptiveRAGPipeline(params, CFG, tok, None, None, None, rag)
    questions = ["a?", "bb cc?", "ddd?", "e f g?", "hh?"]
    t0 = time.perf_counter_ns()
    pipe.run(questions)
    mine = spans_since(t0)
    root, gen, dec = only(mine, "rag.run"), only(mine, "lm.generate"), only(mine, "lm.decode")
    assert root.counts == {"questions": 5} and root.parent is None
    assert gen.counts == {"rows": 8, "pad_rows": 3} and gen.parent == root.id
    assert dec.root == root.id and dec.counts["row_steps"] == 8 * dec.counts["steps"]
    assert dec.counts["live"] == int(results[0].n_pooled[:5].sum())


def tiny_text_encoder(tok=None):
    cfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    params = te.init_encoder_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = tok or ByteTokenizer(259)
    return te.text_encoder(params, cfg, tok, "cpu"), tok


def sorted_slices(texts, tok, batch_size):
    """The batches text_encoder cuts: longest first, ties in caller order."""
    ranked = sorted(texts, key=lambda t: -len(tok.encode(t)))
    return [ranked[s:s + batch_size] for s in range(0, len(ranked), batch_size)]


def test_text_encoder_counts_slots_and_valid_tokens():
    encode, tok = tiny_text_encoder()
    texts = ["short", "a somewhat longer passage", "mid length", "x", "yy", "zzz"]
    t0 = time.perf_counter_ns()
    DenseIndex.build(texts, encode, batch_size=4)
    mine = spans_since(t0)
    build = only(mine, "index.build")
    assert build.counts == {"passages": 6} and build.parent is None
    batch = only(mine, "encoder.batch")
    forwards = [s for s in mine if s.name == "encoder.forward"]
    assert batch.counts["rows"] == 6 and batch.parent == build.id
    assert len(forwards) == 2 and all(f.parent == batch.id for f in forwards)
    for f, part in zip(forwards, sorted_slices(texts, tok, 4)):
        lens = [len(tok.encode(t)) for t in part]
        assert f.counts == {"slots": len(part) * max(lens), "valid": sum(lens)}
    kids = [s.name for s in mine if s.parent == batch.id]
    assert kids == ["encoder.tokenize"] + 2 * ["encoder.pad", "encoder.copy_in",
                                               "encoder.forward", "encoder.readback"]


def test_text_encoder_slots_follow_the_sorted_slices():
    """Each forward's slots are its slice's rows x longest, slices cut
    from the window sorted by length: fewer than caller-order batches."""
    encode, tok = tiny_text_encoder()
    rng = np.random.default_rng(5)
    texts = ["w" * int(n) for n in rng.integers(1, 40, size=23)]
    t0 = time.perf_counter_ns()
    encode(texts, batch_size=5)
    forwards = [s for s in spans_since(t0) if s.name == "encoder.forward"]
    slices = sorted_slices(texts, tok, 5)
    assert [f.counts["slots"] for f in forwards] == [
        len(p) * max(len(tok.encode(t)) for t in p) for p in slices]
    assert sum(f.counts["valid"] for f in forwards) == sum(len(tok.encode(t)) for t in texts)
    unsorted = sum(len(texts[s:s + 5]) * max(len(tok.encode(t)) for t in texts[s:s + 5])
                   for s in range(0, len(texts), 5))
    assert sum(f.counts["slots"] for f in forwards) < unsorted


def test_index_build_tokenizes_one_window_at_a_time():
    """A build over three windows: every passage tokenized once, inside the
    tokenize span of its window (at most WINDOW_BATCHES x batch_size of
    them), and the embeddings in passage order across windows."""
    encode, tok = tiny_text_encoder()
    stamps = []

    class Stamped:
        def encode(self, text):
            stamps.append(time.perf_counter_ns())
            return tok.encode(text)

    stamped, _ = tiny_text_encoder(Stamped())
    rng = np.random.default_rng(9)
    texts = ["v" * int(n) for n in rng.integers(1, 30, size=2 * WINDOW_BATCHES * 2 + 7)]
    t0 = time.perf_counter_ns()
    ix = DenseIndex.build(texts, stamped, batch_size=2)
    spans = [s for s in spans_since(t0) if s.name == "encoder.tokenize"]
    per_span = [sum(s.start_ns <= t <= s.end_ns for t in stamps) for s in spans]
    assert per_span == [2 * WINDOW_BATCHES, 2 * WINDOW_BATCHES, 7] and len(stamps) == len(texts)
    np.testing.assert_allclose(ix.embeddings, encode(texts), rtol=1e-6, atol=1e-6)


def test_bm25_search_span_and_its_analyzer():
    texts = ["paris is the capital of france", "the pacific ocean is large",
             "mount everest is tall", "water boils"]
    engine = BM25Engine(BM25Index.build(texts, BM25Config()), device="cpu")
    t0 = time.perf_counter_ns()
    engine.search(["capital of france", "tall mountain"], k=2)
    mine = spans_since(t0)
    search, analyze = only(mine, "retrieval.search"), only(mine, "retrieval.analyze")
    assert search.counts == {"queries": 2} and analyze.parent == search.id


def test_graph_cache_counts_a_hit():
    cache = graphs.GraphCache(2)
    made = []
    before = dict(graphs.CAPTURES)
    cache.get("k", lambda: made.append(1) or "entry")
    assert graphs.CAPTURES["hits"] == before["hits"]
    assert cache.get("k", lambda: made.append(1) or "other") == "entry"
    assert graphs.CAPTURES["hits"] == before["hits"] + 1 and made == [1]


def test_tensorize_examples_counts_slots_and_valid_tokens():
    tok = ByteTokenizer()
    examples = [ProberExample("question one", "answer", 1), ProberExample("q", "a longer one", 0),
                ProberExample("x" * 40, "y" * 40, 1)]
    t0 = time.perf_counter_ns()
    tokens, _, _ = tensorize_examples(examples, tok, max_len=48)
    span = only(spans_since(t0), "train.tensorize")
    lens = [min(len(tok.encode(f"{e.text}\n{e.pred}", add_bos=True)), 48) for e in examples]
    assert span.counts == {"slots": tokens.size, "valid": sum(lens)}
    assert tokens.size == 3 * 48 and lens[2] == 48
