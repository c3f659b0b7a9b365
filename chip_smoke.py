#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``probing_rag_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its own line with its seconds; any failure raises
and the script exits non-zero:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``) and turns TF32 off.
2. build: compiles the CUDA kernels from ``probing_rag_tpu_torch/kernels/
   csrc`` and loads them.
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at the shapes the main path gives it, with times.
4. BM25 at scale: a seeded Zipf corpus of 100k docs x 60 tokens (50k
   vocabulary), 4096 four-term queries through the kernels, checked
   against the plain path and against the exact host oracle.
5. main path: the adaptive probing RAG loop at Gemma-2B width (random bf16
   weights from a seed, byte tokenizer, random probers), batch 8, 150 new
   tokens, gate threshold 1e6 so that all 4 retrieval rounds run; then the
   loop's first and last BM25 searches again, kernels against the plain
   path, at the widths the loop gave them (up to 2M slots per row).

The line before the last is the card's name and power limit; the last line
is the result as one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda"  # a CPU rehearsal of the phases may set "cpu"
N_DOCS = 100_000
DOC_LEN = 60
VOCAB = 50_000
N_QUERIES = 4096
K = 5
# 2M is the width of the over-cap rows the probing loop searches
SORT_WIDTHS = (2048, 32768, 524288, 1 << 21)
SORT_ROWS = {2048: 1024, 32768: 64, 524288: 4, 1 << 21: 2}

REPO_KERNELS = "probing_rag_tpu_torch/kernels/csrc"
REPLACES = {
    "bm25_gather": "probing_rag_tpu/ops/pallas_sparse.py:663",
    "bitonic_sort": "probing_rag_tpu/ops/pallas_sort.py:55",
    "bitonic_sort_wide": "probing_rag_tpu/ops/pallas_sort.py:155",
    "segment_topk": "probing_rag_tpu/ops/pallas_sparse.py:84",
}
SOURCES = {
    "bm25_gather": f"{REPO_KERNELS}/bm25_gather.cu",
    "bitonic_sort": f"{REPO_KERNELS}/bitonic_sort.cu",
    "bitonic_sort_wide": f"{REPO_KERNELS}/bitonic_sort.cu",
    "segment_topk": f"{REPO_KERNELS}/segment_topk.cu",
}


class Phase:
    """Context manager printing ``[phase] name ... <seconds>`` lines."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        print(f"[phase] {self.name} ...", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase] {self.name} {status} in {dt:.2f}s", flush=True)
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def zipf_tokens(rng, n: int, a: float = 1.3, lo: int = 180):
    """Exactly ``n`` Zipf(a) draws >= ``lo`` (the corpus of bench.py: the
    head ranks dropped as stopword removal would)."""
    import numpy as np

    out, need = [], n
    while need > 0:
        z = rng.zipf(a, size=int(need / 0.17) + 1024)
        z = z[z >= lo]
        out.append(z[:need])
        need -= len(out[-1])
    return np.concatenate(out)


def alternating_blocks(keys, vals, block: int):
    """Sort every ``block`` of each row, ascending at even block index and
    descending at odd: the precondition of ``k_start = 2 * block``."""
    import torch

    q, p = keys.shape
    kb = keys.view(q, p // block, block)
    vb = vals.view(q, p // block, block)
    sk, idx = torch.sort(kb, dim=2)
    sv = torch.gather(vb, 2, idx)
    odd = torch.arange(p // block, device=keys.device) % 2 == 1
    sk[:, odd] = sk[:, odd].flip(2)
    sv[:, odd] = sv[:, odd].flip(2)
    return sk.reshape(q, p).contiguous(), sv.reshape(q, p).contiguous()


def lexsorted_pairs(keys, vals):
    """(keys, vals) of each row ordered by key then value bits (a
    canonical order for comparing pair multisets)."""
    import torch

    vbits = vals.contiguous().view(torch.int32).to(torch.int64)
    combo = (keys.to(torch.int64) << 32) | (vbits & 0xFFFFFFFF)
    s, _ = torch.sort(combo, dim=1)
    return (s >> 32).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)


def phase_sort(results: dict) -> None:
    import torch

    from probing_rag_tpu_torch.ops.sort import sort_pairs, sort_pairs_plain

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs: dict = {}
    for p in SORT_WIDTHS:
        q = SORT_ROWS[p]
        name = "bitonic_sort" if p <= 32768 else "bitonic_sort_wide"
        for k_start in (2, 2048):
            keys = torch.randint(0, 1 << 20, (q, p), generator=gen, device=DEVICE, dtype=torch.int32)
            vals = torch.rand((q, p), generator=gen, device=DEVICE)
            if k_start > 2:
                keys, vals = alternating_blocks(keys, vals, k_start // 2)
            got_k, got_v = sort_pairs(keys, vals, k_start=k_start)
            ref_k, ref_v = sort_pairs_plain(keys, vals)
            sync()
            if not torch.equal(got_k, ref_k):
                raise AssertionError(f"sort P={p} k_start={k_start}: keys differ")
            gk, gv = lexsorted_pairs(got_k, got_v)
            rk, rv = lexsorted_pairs(ref_k, ref_v)
            if not (torch.equal(gk, rk) and torch.equal(gv, rv)):
                raise AssertionError(f"sort P={p} k_start={k_start}: pairs differ")
            err = max(float((got_k - ref_k).abs().max()),
                      float((gv.view(torch.float32) - rv.view(torch.float32)).abs().max()))
            ms = cuda_ms(lambda: sort_pairs(keys, vals, k_start=k_start))
            plain_ms = cuda_ms(lambda: sort_pairs_plain(keys, vals))
            print(f"  sort [{q}, {p}] k_start={k_start}: equal (max abs err {err}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            errs[name] = max(errs.get(name, 0.0), err)
            if k_start == 2048 and p in (32768, 1 << 21):
                results[name] = {"ms": ms, "plain_ms": plain_ms}
    for name, err in errs.items():  # the largest over every width of the name
        results[name]["max_abs_err"] = err


def build_zipf_index():
    import numpy as np

    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

    rng = np.random.default_rng(SEED)
    term_ids = (zipf_tokens(rng, N_DOCS * DOC_LEN) % VOCAB).astype(np.int64)
    docs_tokens = [
        [f"t{t}" for t in term_ids[i * DOC_LEN : (i + 1) * DOC_LEN]]
        for i in range(N_DOCS)
    ]
    index = BM25Index.build_tokenized(
        docs_tokens, BM25Config(stem=False, remove_stopwords=False)
    )
    q_terms = (zipf_tokens(rng, N_QUERIES * 4).reshape(N_QUERIES, 4) % VOCAB).astype(np.int64)
    queries = [index.encode_query([f"t{t}" for t in row]) for row in q_terms]
    return index, docs_tokens, queries, rng


def phase_gather_segment(engine, queries, results: dict) -> None:
    """Gather and segment top-k, kernel vs plain, at the row width most
    rows of the phase-4 query stream have."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.ops.sort import sort_pairs
    from probing_rag_tpu_torch.ops.sparse import (
        TOPK_MAX, bm25_gather, bm25_gather_plain, segment_topk, segment_topk_plain,
    )
    from probing_rag_tpu_torch.retrieval.bm25 import _dedup_term_ids, _next_pow2, _weight_blocks

    uniq, weights, _ = _dedup_term_ids(queries)
    plan = engine._plan_bitonic(uniq, weights)
    src, srcr, slot, rlen, big, totals, wt = plan
    block = engine._store.block
    pads = np.asarray([_next_pow2(max(int(t), 1), block) for t in totals])
    widths, counts = np.unique(pads, return_counts=True)
    print("  row widths of the query stream: "
          + ", ".join(f"{w}: {c}" for w, c in zip(widths, counts)))
    pad = int(widths[np.argmax(counts)])  # the bucket with most rows
    rows = np.nonzero(pads == pad)[0]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(DEVICE)
    desc = [put(a) for a in (src, srcr, slot, rlen, big)]
    wtblk = torch.from_numpy(_weight_blocks(slot[rows], wt[rows], pad, block)).to(DEVICE)
    sentinel = engine.index.n_docs
    kw = dict(pad=pad, block=block, sentinel=sentinel)
    got = bm25_gather(engine._dev_store, *desc, wtblk, **kw)
    ref = bm25_gather_plain(engine._dev_store, *desc, wtblk, **kw)
    sync()
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError(f"gather [{len(rows)}, {pad}]: rows differ")
    err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
    ms = cuda_ms(lambda: bm25_gather(engine._dev_store, *desc, wtblk, **kw))
    plain_ms = cuda_ms(lambda: bm25_gather_plain(engine._dev_store, *desc, wtblk, **kw))
    print(f"  gather [{len(rows)}, {pad}]: equal (max abs err {err}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    results["bm25_gather"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    doc, imp = sort_pairs(*got, k_start=2 * block)
    # the main path's k, and the widest k over the same rows plus one row
    # that holds only the sentinel
    empty = torch.full_like(doc[:1], sentinel)
    wide_doc = torch.cat([doc, empty])
    wide_imp = torch.cat([imp, torch.zeros_like(imp[:1])])
    for k, d, v in ((K, doc, imp), (TOPK_MAX, wide_doc, wide_imp)):
        gv, gi = segment_topk(d, v, k=k, sentinel=sentinel)
        rv1, ri1 = segment_topk_plain(d, v, k=k + 1, sentinel=sentinel)
        sync()
        rv, ri = rv1[:, :k], ri1[:, :k]
        # summation order differs (the plain version's scatter_add_ uses
        # atomics on the card): scores allclose; ids compared where the plain
        # score is distinct from its neighbours, the (k+1)-th included
        if not torch.allclose(gv, rv, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"segment top-k k={k}: scores differ")
        gap = (rv1[:, 1:] - rv1[:, :-1]).abs() > 1e-4  # [Q, k]
        distinct = gap.clone()
        distinct[:, 1:] &= gap[:, :-1]
        bad = int((gi[distinct] != ri[distinct]).sum())
        if bad:
            raise AssertionError(f"segment top-k k={k}: {bad} ids differ where scores are distinct")
        if d is wide_doc and not (bool((gi[-1] == -1).all()) and bool((gv[-1] == 0).all())):
            raise AssertionError("segment top-k: the sentinel-only row is not empty")
        if k == K:
            err = float((gv - rv).abs().max())
    ms = cuda_ms(lambda: segment_topk(doc, imp, k=K, sentinel=sentinel))
    plain_ms = cuda_ms(lambda: segment_topk_plain(doc, imp, k=K, sentinel=sentinel))
    print(f"  segment top-k [{len(rows)}, {pad}]: max abs err {err:.3g} (k={K}; k={TOPK_MAX} "
          f"and an empty row also agree); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["segment_topk"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def assert_same_topk(res, ref, what: str) -> None:
    """``res`` (k per query) against the plain path's ``ref`` (k + 1 per
    query): scores allclose, since the kernels sum in another order; doc ids
    equal where the plain score is distinct from its neighbours."""
    import numpy as np

    k = res.scores.shape[1]
    if not np.allclose(res.scores, ref.scores[:, :k], rtol=1e-5, atol=1e-4):
        raise AssertionError(f"{what}: BM25 scores differ from the plain path")
    gap = np.abs(np.diff(ref.scores, axis=1)) > 1e-4  # [Q, k]
    distinct = gap.copy()
    distinct[:, 1:] &= gap[:, :-1]
    bad = int((res.doc_indices[distinct] != ref.doc_indices[:, :k][distinct]).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} ids differ from the plain path where scores are distinct")


def phase_bm25(engine, cpu_engine, index, queries, rng) -> None:
    import numpy as np

    t0 = time.time()
    res = engine.search_term_ids(queries, k=K)
    sync()
    dt = time.time() - t0
    t0 = time.time()
    res = engine.search_term_ids(queries, k=K)
    sync()
    dt2 = time.time() - t0
    print(f"  {len(queries)} queries: {dt:.3f}s first pass, {dt2:.3f}s second "
          f"({len(queries) / dt2:.0f} q/s end to end); {engine.last_stats}")
    assert_same_topk(res, cpu_engine.search_term_ids(queries, k=K + 1), "phase-4 queries")
    print(f"  equal to the plain path (CPU) on all {len(queries)} queries")
    # score-threshold recall@10 against the exact host oracle (bench.py)
    rk = 10
    sample = rng.choice(len(queries), size=64, replace=False)
    res10 = engine.search_term_ids([queries[i] for i in sample], k=rk)
    recalls = []
    for row, qi in enumerate(sample):
        oracle = index.score_all(queries[qi])
        denom = min(rk, int((oracle > 0).sum()))
        if denom == 0:
            continue
        thresh = np.partition(oracle, -denom)[-denom]
        d = res10.doc_indices[row]
        hits = int((oracle[d[d >= 0]] >= thresh - 1e-3).sum())
        recalls.append(min(hits, denom) / denom)
    recall = float(np.mean(recalls)) if recalls else 1.0
    print(f"  recall@10 vs oracle on 64 sampled queries: {recall}")
    if recall != 1.0:
        raise AssertionError(f"recall@10 {recall} != 1.0")


def phase_lm_reference() -> float:
    """The port's forward on the card against the same forward on the CPU
    (tiny config, f32, shared parameters): max abs logit difference."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig, forward, init_params

    cfg = dataclasses.replace(GemmaConfig.tiny(), compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    ref, _, _ = forward(params, tokens, cfg)
    on_card = {k: ({n: w.to(DEVICE) for n, w in v.items()} if isinstance(v, dict) else v.to(DEVICE))
               for k, v in params.items()}
    got, _, _ = forward(on_card, tokens.to(DEVICE), cfg)
    err = float((got.cpu() - ref).abs().max())
    # f32 with TF32 off on both sides; sums in another order
    if not torch.allclose(got.cpu(), ref, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"tiny forward on the card differs from the CPU: {err}")
    return err


class TimedRetriever:
    """Delegates ``search`` to a BM25 engine, sums its wall seconds
    (synchronised), so the main path's time splits into retrieval and the
    rest, and keeps each call's queries."""

    def __init__(self, engine):
        self.engine = engine
        self.seconds = 0.0
        self.calls = []

    def search(self, queries, k=5):
        sync()
        t0 = time.time()
        res = self.engine.search(queries, k=k)
        sync()
        self.seconds += time.time() - t0
        self.calls.append(list(queries))
        return res


class TextStore:
    """The pipeline's docstore interface over a list of passage texts."""

    def __init__(self, texts):
        self._texts = texts

    def texts(self, indices):
        return [self._texts[i] for i in indices]


def phase_main_path(index, docs_tokens, cpu_engine) -> dict:
    """``rag-run --retr-method probing`` at Gemma-2B width through the
    pipeline API: random bf16 weights and probers from a seed. Returns the
    kernel launch counts of the probing loop."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import StopTables, generate
    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_params
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig, init_prober_stack
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    err = phase_lm_reference()
    print(f"  tiny f32 forward, card vs CPU: max abs logit diff {err:.3g}")

    cfg = GemmaConfig.gemma_2b()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.time()
    params = init_params(cfg, gen, device=DEVICE, dtype=torch.bfloat16)
    n_params = sum(w.numel() for v in params.values()
                   for w in (v.values() if isinstance(v, dict) else [v]))
    tc = ProberTrainConfig(layers=cfg.probe_layers, positions=("resid_post",))
    probers = init_prober_stack(tc, cfg.d_model, gen, device=DEVICE)
    sync()
    print(f"  Gemma-2B width: {n_params / 1e9:.3f}B params (bf16), initialised in "
          f"{time.time() - t0:.1f}s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    tok = ByteTokenizer(cfg.vocab_size)
    store = TextStore([" ".join(d) for d in docs_tokens])
    engine = BM25Engine(index, device=DEVICE)
    retriever = TimedRetriever(engine)
    lens = index.term_offsets[1:] - index.term_offsets[:-1]
    heavy = np.argsort(lens)[::-1]
    names = {v: k for k, v in index.vocab.items()}
    rng = np.random.default_rng(SEED + 5)
    # questions of corpus terms: the even ones hold six of the 24 heaviest
    # terms, so their first retrieval's rows are wider than 32K (the wide
    # sort); the odd ones only mid-frequency terms (narrow rows). Later
    # rounds search with whole generations, which are wider still.
    questions = []
    for i in range(16):
        terms = [names[int(t)] for t in rng.choice(heavy[:24], 6 if i % 2 == 0 else 0, replace=False)]
        terms += [names[int(t)] for t in rng.choice(heavy[1000:20000], 3, replace=False)]
        questions.append("What links " + " and ".join(terms) + "?")
    rag = RAGConfig(retr_method="probing", threshold=1e6, top_k=K, max_new_tokens=150,
                    batch_size=8)
    pipe = AdaptiveRAGPipeline(params, cfg, tok, retriever, store, probers, rag)

    kernels.reset_launches()
    sync()
    t0 = time.time()
    result = pipe.run(questions)
    sync()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"  probing loop over {len(questions)} questions: {wall:.1f}s wall, of which "
          f"BM25 search {retriever.seconds:.3f}s ({len(retriever.calls)} calls, "
          f"{sum(map(len, retriever.calls))} queries); retr_count {result.retr_count_list}; "
          f"kernel launches {launches}; last search {engine.last_stats}")
    if result.retr_count_list != [3] * len(questions):
        raise AssertionError(f"retr_count {result.retr_count_list} != all 3")
    if not all(isinstance(p, str) and p for p in result.pred_list):
        raise AssertionError("empty prediction")
    for s in result.gate_scores:
        if s is None or s.shape != (2,) or not np.isfinite(s).all() \
                or abs(float(s.sum()) - len(tc.sites)) > 1e-3:
            raise AssertionError(f"gate scores {s} are not {len(tc.sites)} softmax sums")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # the loop's first search (the questions) and last one (whole
    # generations, over-cap rows) again: kernels against the plain path
    for label, queries in (("first", retriever.calls[0]), ("last", retriever.calls[-1])):
        res = engine.search(queries, k=K)
        stats = engine.last_stats
        assert_same_topk(res, cpu_engine.search(queries, k=K + 1), f"{label} loop search")
        print(f"  {label} loop search again ({len(queries)} queries, {stats}): "
              f"equal to the plain path (CPU)")

    # decode rate at batch 8 on a retrieval-round prompt, stops off so all
    # 150 tokens are generated; the 1-token call times the prefill
    prompts8 = pipe.retrieval_prompts(questions[:8], questions[:8])
    stops = StopTables.disabled(cfg.vocab_size)

    def timed(n):
        sync()
        t = time.time()
        _, res = generate(params, cfg, tok, prompts8, max_new_tokens=n, stop_tables=stops)
        sync()
        return time.time() - t, res

    timed(1)
    t1, _ = timed(1)
    t150, res = timed(150)
    n_tok = int(res.n_generated.sum())
    if n_tok != 8 * 150 or not np.isfinite(res.pooled_captures).all():
        raise AssertionError("decode did not produce 150 finite steps per row")
    decode_tps = 8 * 149 / (t150 - t1)
    print(f"  decode at batch 8, prompt {len(tok.encode(prompts8[0]))} tokens: prefill "
          f"{t1:.3f}s, 150 tokens {t150:.3f}s -> {decode_tps:.1f} decode tokens/s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from probing_rag_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    with Phase("1 device"):
        card = card_line()
        print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with Phase("2 build"):
        t0 = time.time()
        kernels.build(verbose=True)
        kernels.library()
        print(f"  build + load {time.time() - t0:.1f}s")

    results: dict = {}
    with Phase("3 kernels vs plain"):
        import numpy as np

        from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

        t0 = time.time()
        index, docs_tokens, queries, rng = build_zipf_index()
        print(f"  Zipf index: {index.n_docs} docs, {index.nnz} postings, "
              f"built in {time.time() - t0:.1f}s")
        engine = BM25Engine(index, device=DEVICE)
        phase_sort(results)
        phase_gather_segment(engine, queries, results)
    with Phase("4 BM25 at scale"):
        cpu_engine = BM25Engine(index, device="cpu")
        phase_bm25(engine, cpu_engine, index, queries, rng)
        del engine
    with Phase("5 main path"):
        launches = phase_main_path(index, docs_tokens, cpu_engine)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
