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
   card, on seeded inputs at the shapes the main path gives it, with times:
   the sort (2 to 8M wide, from k_start 2 and 2048, keys from 2^20 and
   from 64 values; the schedule's rarer plans, in place and strided; its
   passes timed one by one), the bitonic gather and segment top-k on the
   phase-4 stream (and on rows whose runs cross every chunk boundary, with
   equal scores in different chunks), the aligned
   gather in its plain form on the "dma" mode's commonest bucket of that
   stream (with the sort against ``torch.sort``), and the over-cap
   hybrid's kernels on one batch of eight 1,500-token Zipf queries: the
   E/O gather of the long terms, the assembly of the short tails (weighted,
   unweighted, and cut at half their pad), the assembly alone on a bucket
   with no long term at ``pad_short`` 2^20 (eight rows of over 2,048
   distinct short terms), each assembly with the grid
   ``ops/sparse.py::plan_assemble`` gave it, and its floor (one posting a
   row, beside a ``fill_`` of the doc rows), and the ``k_stop = 1024``
   sort of the tails, then the chain's sort and segment top-k on the
   assembled rows, with their bounds.
4. BM25 at scale: a seeded Zipf corpus of 100k docs x 60 tokens (50k
   vocabulary), 4096 four-term queries through the kernels, checked
   against the plain path and against the exact host oracle; then the same
   queries through ``BM25Engine(mode="dma")``, against the same plain
   results and the oracle.
5. main path: the adaptive probing RAG loop at Gemma-2B width (random bf16
   weights from a seed, byte tokenizer, random probers), batch 8, 150 new
   tokens, gate threshold 1e6 so that all 4 retrieval rounds run; its later
   searches route rows over 512K slots to the over-cap hybrid. Then the
   loop's first and last BM25 searches again, kernels against the plain
   path, and the last one through both card routes (the hybrid, and
   ``max_pad = MAX_SORT_WIDTH``: every row on the bitonic kernels) with
   their seconds and row widths.
6. dense kernels vs plain: the flat dense top-k at 500,000 x 768 with 256
   queries (ip and l2 bf16, the int8 rerank pool, int8 x int8), the f32
   coarse quantizer (64 x 4096 x 768, nprobe 32 and 128), the probing
   loop's own shape (8 x 100,000 x 768 l2 bf16, timed with its bound), 1,
   9, 65 and 257 queries (the planner's tile edges), 72 and 144 (tiles
   whose last column is a real query), a store length that
   is no multiple of the 128-row step, lists of 256 in bf16, and depths of
   32 and 100; a yardstick the port never calls, ``torch.topk(q @ emb.T,
   k)`` at ip bf16; the IVF top-k over a clustered 1,000,000 x 768 corpus
   (k-means on the card, nlist 4096, nprobe 32, block 256) at 64, 8 (the
   loop's, timed with its bound and bytes), 72 and 68 queries, bf16 and
   int8. Each case prints the regime the planner chose (``ops/dense.py::
   plan_dense``, ``ops/ivf.py::plan_ivf``), which must be the one it lists,
   and is held to its plain version: scores allclose, ids equal where the
   scores are distinct, recall@10 = 1.0, int8 x int8 bit-equal. A coarse probe of nprobe 512
   (above dense_topk's 256: the full-row probe) against the CPU probe, and
   the search it plans. Then IVF engines at depth 40 and block 48 against
   the same engines on the CPU.
7. dense main path: a flat l2 index of the phase-4 corpus rendered as text,
   encoded by a Contriever-width encoder (random bf16 weights from a seed,
   byte tokenizer), and an IVF index over it; the probing loop of phase
   5's model and probers over the flat engine and then over the IVF
   engine, 8 questions each, all 4 retrieval rounds, each loop with its
   own launch counts; then the flat loop's first and last searches again
   through the flat bf16, flat int8 + rerank, IVF bf16 and IVF int8
   engines, each against the same engine on the CPU. Then the port's
   Porter stemmer against the committed NLTK golden (no NLTK needed), and
   a default (stemming) BM25 index over the same texts, one batch of the
   loop's questions on the card against the CPU.
8. quantized main path: phase 5's bf16 weights quantized on the card
   (per-channel int8); the int8-weight matmul kernel against its plain
   version at every product of a Gemma-2B decode step (M = 8, the tied
   head transposed), at every product of the speculative verify forward
   (M = 40), at every prefill product (M = 8 x the padded prompt
   length), at a ragged prefill M and a transposed weight at prefill M, at
   ragged shapes (wgmma with ragged K and N, ragged shapes for the tail)
   and in f32, each case with the regime the planner gave it (wgmma,
   small-M, tail); the small-M and wgmma regimes timed on the same
   products at M from 16 to 512 (where the wgmma regime starts);
   then the int4-weight kernel (``matmul_int4``) against its plain
   version (``phase_matmul_int4_kernels``): every decode product of
   Gemma-2B and the verify round's wo and w_down in both schemes (rank-1
   and grouped, group 128), the tied head of an int4 embedding, rank-1 at
   every prefill product, at the capture forward's M and a ragged prefill
   M, grouped at 1,024 rows, Mistral-7B's w_gate / w_up and w_down at
   decode (both schemes) and its rank-1 prefill, ragged M, N and K in each
   regime, a group of 64, and f32, each with its plan, bound, plain time
   and the ``torch._weight_int4pack_mm`` yardstick (grouped at 1,024 rows
   also the dequantized copy's route); then the shared launches (a list of
   weights to ``matmul_int4``) at decode and verify rows;
   quantized tiny f32 forwards (int8 and rank-1 int4 weights, int8 and
   int4 KV, w8a8 prefill) against the CPU; the probing loop with
   ``--quantize int8 --kv-int8`` over the phase-4 BM25 index (8
   questions, all 4 rounds) with its own launch counts, and the prefill
   and decode seconds of each of its generate calls; the same loop with
   ``--quantize int4 --kv-int4`` (grouped, the CLI's default), its own
   launch counts; then
   prefill seconds, decode tokens/s at batch 8 (the median of
   ``GRAPHED_CALLS`` graphed calls of 150 tokens, each split into prefill,
   decode loop, garbage collections and captures, beside a replayed
   step's device ms; the eager step over ``EAGER_TOKENS``) and peak memory for
   bf16, int8 + int8 KV, int8 +
   act_int8_rows 512 + int8 KV, rank-1 int4 + int4 KV and grouped int4 +
   int4 KV. In the two int4 modes no int4 weight may be unpacked on the
   card (``NoWeightUnpack``; grouped's prefill rows are past
   ``_INT4_DEQUANT_ROWS``, where it multiplies by a dequantized copy as
   JAX does), the captured step launches matmul_int4 72 times (the 126
   products, those that share an input in one launch; the profiler counts
   them in one replay; the same step captured with one launch a weight is
   timed beside it), and a speculative generate (verify rounds of 40
   rows) and a capture forward launch it too.
9a. the block's elementwise kernels against their plain versions
   (``phase_block_kernels``), bf16 and f32: ``rms_norm`` (the residual add
   folded into RMSNorm; the add bit-equal, the norm within
   ``ops/block.py::norm_tolerance``), ``rope_kv`` (RoPE of q and k with k
   and v written into bf16, f32, int8 and int4 caches or the no-cache
   layout; q within ``rope_tolerance``, the cache's v bit-equal, its k
   bit-equal where q is) and ``gated_act`` (gelu / silu times up, within
   ``gated_tolerance``), at Gemma-2B's decode step (8 rows, cursor 3,800
   of 3,862 slots), verify round (8 x 5), prefill (8 x 3,712) and capture
   (8 x 1,536) rows, Mistral-7B's widths (D 4096 without ``1 + w``, 32 / 8
   heads x 128, silu at 14,336) and the tiny configs'; each bound checked
   against faults that must exceed it (a flipped ``1 + w``, a skipped add,
   a position off by one, an unrounded activation, gate and up swapped);
   the prefill, capture and decode shapes timed beside the plain version,
   the byte bound and, for the norm, ``F.rms_norm`` on the summed f32
   input (a yardstick only); ``gated_act`` also at ragged n (a tiny
   width and a prefill-sized one), each case with its plan (``ops/block.py::plan_act``) and
   its count of elements not bit-equal, the timed ones (each launch on a
   fresh copy of gate) beside the same-bytes ``torch.add(gate, up,
   out=gate)`` (the first design's bracketed times were taken in place);
   then the card's launch floor at ``gated_act``'s decode plan: an empty
   kernel of its geometry (built here with nvcc) by ``cuda_ms`` and as 18
   launches in a captured CUDA graph, beside 18 ``gated_act`` and 18
   same-bytes adds in graphs of their own.
9. generation: at Gemma-2B width on phase 5's weights, batch 8, the
   retrieval-round prompts, 150 tokens with stops off. First the decode
   attention kernel against its plain version at [8 x 8 heads x 3,862
   slots x 256] (the retrieval round's cache) for the f32 (T 1), bf16,
   int8 and int4 caches at T 1 (a decode step) and 5 (a verify round),
   rows 0-6 left-padded and row 7 all pad, each with its split plan, max
   abs error and limit, kernel / plain ms, bound and, on the bf16 cache,
   ``scaled_dot_product_attention`` as a yardstick; f32 compute over the
   int8 and int4 caches and at T 5; Mistral-7B's shape (32 heads over 8 kv
   heads at 128) and one tensor-parallel rank's kv-head slice of it. Then
   the prefill attention kernel against its plain version, after ptxas's
   registers and spills of each of its instantiations beside the plan's
   setmaxnreg budgets: the retrieval
   round's prefill (8 x 3,712 prompt tokens into 3,862 slots, the same
   pads and all-pad row) over bf16, int8 and int4 caches, the capture
   forward's no-cache shape (8 x 1,536, positions-style pads), Mistral-7B's
   at 1,024 tokens over int8 and its kv-head slice; each with its plan,
   kernel / plain / ``scaled_dot_product_attention`` ms and the bound from
   its attended pairs, its rows with no attendable slot against the mean
   of v, and a second launch bit-equal to the first. The bf16 limit is
   ``rounding_tolerance``'s, element by element, and
   two faults (probabilities left unrounded, one tile dropped) must exceed
   it. Then the decode step
   replayed as a CUDA graph against the same step run eagerly, bf16 and
   int8 weights + int8 KV: tokens, validity, counts and pooled captures
   bit-equal, matmul_int8 launched 127 times a step plus the prefill's,
   decode_attention 18 times a step (one a layer), prefill_attention 18
   times a prefill, the capture's seconds, host checks, tokens/s both
   ways, the step's wall and one replay's device time, and a
   ``torch.profiler`` breakdown of a replay; the prefill's seconds and
   peak GiB with the kernel and with plain attention in the same call, and
   a ``torch.profiler`` breakdown of one bf16 prefill each way (with the
   kernel: ``prefill_attn``'s ms and share of the device time); the same
   graphed step with plain attention
   (rows that part must part where the logit gap is within
   ``ATTN_DRIFT``), and in f32 the graphed decode's tokens equal to the
   plain-attention step's; the same with the block's plain ops
   (``PlainBlock``): the prefill's seconds and peak, one replay's device
   ms and its ``torch.profiler`` launches and top kernels, tokens/s, rows
   within ``ATTN_DRIFT`` (bf16) or equal (f32), and the block's kernels
   launched once a layer a forward (the norm twice, plus the final norm); speculative decode (k 4) on the weights upcast to f32
   equal to graphed greedy with the prompt drafter and with the oracle
   drafter at acceptance 1 (greedy's tokens), and in bf16 with both
   drafters (rows equal, rounds, tokens per forward, tokens/s); a sampled
   generate (top_k 40, top_p 0.9, temperature 0.7, freq_penalty 0.5)
   that repeats under one seed and equals the eager step; the probing
   loop with ``spec_k`` 4 over the phase-4 BM25 index.
10. prober training: the paper's phases 2 and 3 and the offline
   evaluation on phase 5's weights (``phase_prober_training``):
   ``dataset-make`` over the 16 questions in ``none`` and ``simple`` mode
   (golds from a first run, so both labels occur; rows saved, loaded and
   balanced), ``train_probers`` on the JAX package's separable task at
   the default 12 sites, max_len 1536, batch 8 (best dev accuracy > 0.9),
   one train step on the card against the CPU, the trained stack saved and
   read by the CLI's ``_load_probers`` to gate a loop batch,
   ``prober_offline_eval`` against the CPU, the capture forward's seconds
   through prefill_attention (18 launches) and the block's kernels (37
   norms, 18 rope_kv, 18 gated_act), with plain attention and with the
   block's plain ops, and
   the capture forward with int8 weights (matmul_int8 at [12288 x 2048 -> 16384] with its bound
   and ``torch._weight_int8pack_mm``).
11. baselines and the CLI chain (``phase_baselines``): on phase 5's
   weights over the phase-4 index with a word tokenizer (an id decodes to
   a corpus term, so generations re-enter retrieval), DRAGIN, FLARE,
   fix-length and fix-sentence at batch 1 over 8 four-term Zipf
   questions (64 new tokens, ``bench_baselines.py``'s setup) and the LLM
   classifier gate at batch 8: queries/s, retrieval calls a query,
   generate calls, tokens, hallucination triggers, graph captures and
   their seconds, BM25 launches (one segment top-k a search) and peak
   memory, every search equal to the CPU engine's; one trace at width
   (probs rows sum to 1, zero above the diagonal, per-word attention,
   entropy and logprob within ``TRACE_DRIFT`` of the weights upcast to
   f32); each method on the tiny f32 model equal to its CPU run; the
   CLI's ``parity`` (tiny model, fixture corpus) leaving every artifact,
   ``rag-sweep`` at thresholds -1e6, 0, 1e6 (the lowest and highest mean
   retrieval steps at the extremes) and ``analyze --report``;
   ``init_quantized_lm_params`` at Gemma-2B width bit-equal to
   ``quantize_lm_params(init_params(...))``, the peak of each, and a
   generate call on it launching matmul_int8.

12. native builder, sharded retrieval, tensor parallelism
   (``phase_parallel``; ranks sharing the one card: no scaling). The C++
   index builder (``g++`` at first use) over phase 7's texts in original
   Porter mode against the numpy build, docs/s of each, and the native
   ``QueryEncoder`` over the phase-4 queries as text feeding
   ``BM25Engine.search_term_ids`` on the card, against the analyzer path.
   Four ranks over gloo on the card, mesh (2, 2), each check against the
   single engine on the card and each rank's launches printed: sharded
   BM25 (bitonic) over the phase-4 index, its 4096 queries at k 10
   (recall@10 1.0 against the oracle on 256), then phase 3's over-cap
   batch through the sharded hybrid; sharded flat dense at 500,000 x 768,
   256 queries (ip and l2 bf16, an int8 store); sharded IVF at 1,000,000
   x 768, nlist 4096, nprobe 32, Q 64. Two ranks over gloo, tp 2, on
   phase 5's weights: the forward on 8 x 512 tokens in bf16 and with int8
   weights against the unsharded forward (logit drift within
   ``TP_DRIFT`` of the largest logit), matmul_int8 at the sharded shapes
   against its plain version, and a 32-token eager decode (f32: tokens
   equal; bf16: where a row parts, the unsharded logit gap between the
   two tokens within ``TP_DRIFT``). Then NCCL at world size 1: the
   graphed decode step at tp 1 bit-equal to the unsharded graphed step.

The probing loops of phases 5, 7, 8, 9 and 10 run the decode step graphed
(``models/graphs.py``), as ``generate`` does on the card by default.

Kernel times are CUDA-event means after a warm-up, with the card given a
head start (``cuda_ms``). The kernels line lists, for each kernel, its
launches on its path, its max abs error, kernel / plain / library ms and
its bound (``bound``): fifteen kernels. The line before the last is the card's name and
power limit; the last line is the result as one JSON object.

``python3 chip_smoke.py --matmul`` runs phases 1, 2 and phase 8's
matmul_int8 and matmul_int4 cases alone; ``--attention`` phases 1, 2 and phase 9's
decode and prefill attention cases; ``--block`` phases 1, 2 and 9a; ``--train`` runs phases 1, 2 and phase 10, and
``--baselines`` phases 1, 2 and 11, ``--parallel`` phases 1, 2 and 12
(each with the phase-4 index and phase 5's model).
"""

from __future__ import annotations

import contextlib
import json
import statistics
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
# 2M is the width of the over-cap rows the probing loop searches on the
# bitonic path; 8M the widest row the over-cap hybrid can plan
SORT_WIDTHS = (2048, 32768, 524288, 1 << 21, 1 << 23)
SORT_ROWS = {2048: 1024, 32768: 64, 524288: 4, 1 << 21: 2, 1 << 23: 1}
# the sort's rarer plans (k_start past the tile, k_stop past it, in place,
# strided) at this width; its passes timed one by one on (rows, width,
# k_start): the main path's narrow sort, the dma mode's full sort, the
# over-cap chain's sort, the widest row
SORT_PLAN_WIDTH = 1 << 21
SORT_PASS_CASES = ((64, 32768, 2048), (256, 16384, 2), (8, 1 << 21, 2048), (1, 1 << 23, 2))
# the tile pass's stages up to this one are the network's compare-exchange
# steps, in registers (bitonic_sort.cu kItems); those above, merges
TILE_NETWORK_MAX = 16
# phase 3's over-cap batch: queries of Zipf text, like the loop's later
# searches (whole generations and prompts)
OVERCAP_QUERIES, OVERCAP_TOKENS = 8, 1500
# and its widest bucket with no long term: the short terms' pad, and the
# terms a row must exceed (rows over 2048 distinct short terms)
WIDE_SHORT_PAD, WIDE_SHORT_MIN_TERMS = 1 << 20, 2048

# phase 6: bench_dense.py's shape, the IVF quantizer's, bench_ivf.py's
DENSE_N, DENSE_Q, DENSE_D = 500_000, 256, 768
QUANT_Q, QUANT_NLIST = 64, 4096
IVF_N, IVF_CLUSTERS, IVF_NLIST, IVF_NPROBE, IVF_BLOCK = 1_000_000, 4096, 4096, 32, 256
IVF_QS = (64, 8, 72, 68)  # the service's Q, the loop's, nine full tiles, a partial ninth
DENSE_K = 10
N_DENSE_QUESTIONS = 8
WIDE_NPROBE = 128  # a faiss nprobe above the rerank pool's 32
WIDEST_NPROBE = 512  # above dense_topk's 256-long lists: the full-row probe
# query counts at the edges of the flat kernel's query tiles (widths 8,
# 16 and 72 with padding columns, three tiles of 86 at width 88), counts
# whose tiles' last column is a real query on the thread-per-query
# insertion path (72; two tiles of 72), and a store length cut to no
# multiple of its 128-row step
EDGE_QS = (1, 9, 65, 257, 72, 144)
RAGGED_N_CUT = 63
# depths that are not a multiple of the kernels' 64-deep step, and IVF
# blocks that are not a multiple of the IVF kernel's 32-row step
TAIL_DS, TAIL_N, TAIL_Q = (32, 100), 20_011, 37
TAIL_IVF_D, TAIL_IVF_N, TAIL_IVF_NLIST, TAIL_IVF_BLOCK = 40, 20_000, 64, 48

# phase 8: the decode batch and Gemma-2B's products as (K, N)
MM_DECODE_M = 8
MM_VERIFY_M = 40  # the speculative verify forward: batch 8 x (k + 1) = 5 tokens
GEMMA_MM = {"wq/wo": (2048, 2048), "wk/wv": (2048, 256), "w_gate/w_up": (2048, 16384),
            "w_down": (16384, 2048)}
TIED_HEAD = (2048, 256_000)  # (K, N): the [V, D] embedding read transposed
N_QUANT_QUESTIONS = 8
# phase 8's eager decode, timed over fewer tokens than the graphed one (a
# step's eager cost does not change along the decode)
EAGER_TOKENS = 50
# phase 8's graphed 150-token calls a serving mode, timed one by one
GRAPHED_CALLS = 3
GEN_TOKENS = 150  # phase 9's decode length, stops off
SPEC_K = 4
# phase 9's decode attention cases: batch 8 over the retrieval-round cache
# (3,712 prompt slots + GEN_TOKENS), left pads of rows 0-6 (row 7 is all
# pad), at T 1 (a decode step) and SPEC_K + 1 (a verify round)
ATTN_PROMPT = 3712
ATTN_SLOTS = ATTN_PROMPT + GEN_TOKENS
ATTN_PADS = (0, 37, 300, 1000, 2000, 3000, 3700)
# a cache this many times longer, timed once: whether the kernel's distance
# from its byte bound is a fixed cost or a cost per byte
ATTN_LONG = 16
# phase 9's prefill attention cases: the retrieval round's prompt length
# (ATTN_PADS are its pads; other lengths scale them), the capture forward's
# (TRAIN_MAX_LEN) and Mistral-7B's, short enough that its plain version's f32
# [8, 32, T, S] scores fit beside it
PREFILL_T = ATTN_PROMPT
PREFILL_MISTRAL_T = 1024
# bf16 decode, kernel against plain attention: where a row parts, the plain
# model's logit gap between the two tokens, as a share of its largest logit
ATTN_DRIFT = 0.05

# H100 SXM data sheet: HBM rate and dense peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

# cuda_ms's head start for the card: ~5 ms at the H100's ~1.98 GHz clock
SPIN_CYCLES = 10_000_000

REPO_KERNELS = "probing_rag_tpu_torch/kernels/csrc"
REPLACES = {
    "bm25_gather": "probing_rag_tpu/ops/pallas_sparse.py:663",
    "bitonic_sort": "probing_rag_tpu/ops/pallas_sort.py:55",
    "bitonic_sort_wide": "probing_rag_tpu/ops/pallas_sort.py:155",
    "segment_topk": "probing_rag_tpu/ops/pallas_sparse.py:84",
    "dense_topk": "probing_rag_tpu/ops/pallas_dense.py:185",
    "ivf_topk": "probing_rag_tpu/ops/pallas_ivf.py:52",
    "matmul_int8": "probing_rag_tpu/ops/pallas_matmul.py:27",
    # not a Pallas kernel: XLA's int4 convert fused into the dot's weight load
    "matmul_int4": "probing_rag_tpu/models/gemma.py:685",
    "postings_gather": "probing_rag_tpu/ops/pallas_sparse.py:208",
    "postings_assemble": "probing_rag_tpu/ops/pallas_sparse.py:389",
    # not a Pallas kernel: XLA's fused attention over the cache
    "decode_attention": "probing_rag_tpu/models/gemma.py:755",
    "prefill_attention": "probing_rag_tpu/models/gemma.py:755",
    # not Pallas kernels: XLA's fusions of the block's elementwise work
    "rms_norm": "probing_rag_tpu/models/gemma.py:338",
    "rope_kv": "probing_rag_tpu/models/gemma.py:743",
    "gated_act": "probing_rag_tpu/models/gemma.py:915",
}
SOURCES = {
    "bm25_gather": f"{REPO_KERNELS}/bm25_gather.cu",
    "bitonic_sort": f"{REPO_KERNELS}/bitonic_sort.cu",
    "bitonic_sort_wide": f"{REPO_KERNELS}/bitonic_sort.cu",
    "segment_topk": f"{REPO_KERNELS}/segment_topk.cu",
    "dense_topk": f"{REPO_KERNELS}/dense_topk.cu",
    "ivf_topk": f"{REPO_KERNELS}/ivf_topk.cu",
    "matmul_int8": f"{REPO_KERNELS}/matmul_int8.cu",
    "matmul_int4": f"{REPO_KERNELS}/matmul_int4.cu",
    "postings_gather": f"{REPO_KERNELS}/postings_gather.cu",
    "postings_assemble": f"{REPO_KERNELS}/postings_assemble.cu",
    "decode_attention": f"{REPO_KERNELS}/decode_attention.cu",
    "prefill_attention": f"{REPO_KERNELS}/prefill_attention.cu",
    "rms_norm": f"{REPO_KERNELS}/rms_norm.cu",
    "rope_kv": f"{REPO_KERNELS}/rope_kv.cu",
    "gated_act": f"{REPO_KERNELS}/gated_act.cu",
}
# the kernels each path must launch
BM25_KERNELS = ("bm25_gather", "bitonic_sort", "bitonic_sort_wide", "segment_topk",
                "postings_gather", "postings_assemble")
DENSE_KERNELS = ("dense_topk", "ivf_topk")
BLOCK_KERNELS = ("rms_norm", "rope_kv", "gated_act")
QUANT_KERNELS = ("matmul_int8",) + BM25_KERNELS
INT4_KERNELS = (("matmul_int4", "matmul_int8", "decode_attention", "prefill_attention")
                + BM25_KERNELS + BLOCK_KERNELS)


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
    warm-up, timed with CUDA events. The card first spins for ~5 ms while
    the host queues the runs, so that a call whose host side is slower than
    its kernels is timed by its device time."""
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
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of ``nbytes`` (each
    input read once, each output written once) over the HBM rate and
    ``ops`` over the peak rate of their ``kind``. Returns the kernels
    line's ``bound_ms`` and ``bound_by``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


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


def sort_bound(q: int, p: int, k_start: int, k_last: int) -> dict:
    """``bound`` of a sort of [q, p] rows from stage ``k_start`` through
    ``k_last``: each pair read and written once; the operations are the
    passes' compares (a tile pass's compare-exchanges, one compare a pair
    for each merge level)."""
    from probing_rag_tpu_torch.ops.sort import sort_schedule

    ops = 0
    for s in sort_schedule(p, k_start, k_last):
        if s.kind == "tile":
            for k in (1 << b for b in range(s.k_lo.bit_length() - 1, s.k_hi.bit_length())):
                # the network's steps of stage k, or one merge level
                ops += q * p // 2 * (k.bit_length() - 1) if k <= TILE_NETWORK_MAX else q * p
        elif s.kind == "merge":
            ops += q * p
    return bound(2 * q * p * 8, ops, "f32")


def sort_pass_times(keys, vals, k_start: int) -> str:
    """Where a sort's time goes: each pass of its schedule alone (ms,
    launched as the wrapper launches it, on the rows the pass before it
    left), and a device copy of the same bytes, the floor of one pass."""
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.ops import sort as sort_mod

    q, p = keys.shape
    bufs = {"in": (keys, vals, p),
            "out": (torch.empty_like(keys), torch.empty_like(vals), p),
            "scratch": (torch.empty_like(keys), torch.empty_like(vals), p)}
    lib, stream = kernels.library(), kernels.stream_ptr(keys.device)
    parts = []
    for s in sort_mod.sort_schedule(p, k_start, p):
        label = f"tile {s.k_lo}..{s.k_hi}" if s.kind == "tile" else f"merge {s.run}"
        ms = cuda_ms(lambda s=s: sort_mod.launch_pass(lib, s, bufs, q, p, stream))
        parts.append(f"{label} {ms:.4f}")
    dk, dv, _ = bufs["out"]
    copy_ms = cuda_ms(lambda: (dk.copy_(keys), dv.copy_(vals)))
    return f"[{q}, {p}] k_start={k_start}: " + ", ".join(parts) + f"; copy {copy_ms:.4f} ms"


def check_sorted_pairs(got, ref, what: str, block: int = 0) -> float:
    """A sort's (keys, values) against the plain version's: keys equal and
    each row's (key, value) pairs equal as multisets (per ``block`` when
    given: a ``k_stop`` sort). Returns the max abs error (0)."""
    import torch

    sync()
    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"{what}: keys differ")
    pairs = (lambda k, v: blockwise_pairs(k, v, block)) if block else lexsorted_pairs
    gk, gv = pairs(*got)
    rk, rv = pairs(*ref)
    if not (torch.equal(gk, rk) and torch.equal(gv, rv)):
        raise AssertionError(f"{what}: pairs differ")
    return max(float((got[0] - ref[0]).abs().max()),
               float((gv.view(torch.float32) - rv.view(torch.float32)).abs().max()))


def phase_sort(results: dict) -> None:
    """The sort against its plain version at every width from 2K to 8M, from
    k_start 2 and 2048, with keys from 2^20 values and from 64 (equal runs
    across tiles and merge windows); from a k_start past the tile; with a
    k_stop between the tile and the row; in place; into a strided ``out``
    and from an unaligned strided input. Times against ``torch.sort``, and
    each pass of the sort's schedule alone."""
    import torch

    from probing_rag_tpu_torch.ops import sort as sort_mod
    from probing_rag_tpu_torch.ops.sort import sort_pairs, sort_pairs_plain

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def draw(q, p, k_start, key_hi):
        keys = torch.randint(0, key_hi, (q, p), generator=gen, device=DEVICE, dtype=torch.int32)
        vals = torch.rand((q, p), generator=gen, device=DEVICE)
        return alternating_blocks(keys, vals, k_start // 2) if k_start > 2 else (keys, vals)

    errs: dict = {}
    for p in SORT_WIDTHS:
        q = SORT_ROWS[p]
        name = "bitonic_sort" if p <= 32768 else "bitonic_sort_wide"
        for k_start, key_hi in ((2, 1 << 20), (2048, 1 << 20), (2, 64), (2048, 64)):
            keys, vals = draw(q, p, k_start, key_hi)
            what = f"sort [{q}, {p}] k_start={k_start} keys<{key_hi}"
            err = check_sorted_pairs(sort_pairs(keys, vals, k_start=k_start),
                                     sort_pairs_plain(keys, vals), what)
            errs[name] = max(errs.get(name, 0.0), err)
            if key_hi == 64:
                print(f"  {what}: equal")
                continue
            ms = cuda_ms(lambda: sort_pairs(keys, vals, k_start=k_start))
            plain_ms = cuda_ms(lambda: sort_pairs_plain(keys, vals))
            line = (f"  {what}: equal (max abs err {err}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
            if k_start == 2048 and p in (32768, 1 << 21) or p == 1 << 23:
                lib_ms = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True))
                b = sort_bound(q, p, k_start, p)
                line += (f", bound {b['bound_ms']:.4f} ms ({b['bound_by']}), torch.sort "
                         f"{lib_ms:.4f} ms")
                if p == 1 << 23:  # beside the [2, 2M] numbers: the widest row
                    results[name].update({f"{key}_8m_k_start_{k_start}": x for key, x in (
                        ("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                        ("bound_ms", b["bound_ms"]))})
                else:
                    results[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **b}
            print(line, flush=True)

    # the rarer plans: a k_start past the tile (the first merge reads odd
    # runs backwards; in place with an odd count of merges, from a copy), a
    # k_stop between the tile and the row (odd blocks written reversed), in
    # place, a strided out and an unaligned strided input (4-byte copies)
    p, q = SORT_PLAN_WIDTH, 2
    for k_start, k_stop, key_hi in ((65536, None, 1 << 20), (32768, None, 64),
                                    (2048, 65536, 1 << 20), (2, 1 << 18, 64)):
        keys, vals = draw(q, p, k_start, key_hi)
        ref = sort_pairs_plain(keys, vals, k_start=k_start, k_stop=k_stop)
        blk = k_stop or 0
        what = f"sort [{q}, {p}] k_start={k_start} k_stop={k_stop} keys<{key_hi}"
        errs["bitonic_sort_wide"] = max(errs["bitonic_sort_wide"], check_sorted_pairs(
            sort_pairs(keys, vals, k_start=k_start, k_stop=k_stop), ref, what, blk))
        ik, iv = keys.clone(), vals.clone()
        sort_pairs(ik, iv, k_start=k_start, k_stop=k_stop, out=(ik, iv))
        check_sorted_pairs((ik, iv), ref, f"{what}, in place", blk)
        wide_k = torch.zeros((q, 2 * p + 4), dtype=torch.int32, device=DEVICE)
        wide_v = torch.zeros((q, 2 * p + 4), device=DEVICE)
        wide_k[:, 1:p + 1], wide_v[:, 1:p + 1] = keys, vals
        out = (wide_k[:, p + 4:], wide_v[:, p + 4:])
        sort_pairs(wide_k[:, 1:p + 1], wide_v[:, 1:p + 1], k_start=k_start, k_stop=k_stop,
                   out=out)
        check_sorted_pairs(out, ref, f"{what}, unaligned strided input, strided out", blk)
        print(f"  {what}: equal; in place and strided equal "
              f"({len(sort_mod.sort_schedule(p, k_start, k_stop or p, in_place=True))} "
              f"passes in place)")
    for name, err in errs.items():  # the largest over every width of the name
        results[name]["max_abs_err"] = err

    for q, p, k_start in SORT_PASS_CASES:
        print(f"  sort passes, ms: {sort_pass_times(*draw(q, p, k_start, 1 << 20), k_start)}",
              flush=True)


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
    from probing_rag_tpu_torch.ops.sparse import TOPK_MAX, bm25_gather, bm25_gather_plain
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
    # reads the rows' real postings (doc + impact) and the weight blocks,
    # writes the [Q, pad] rows; no arithmetic to speak of
    gbound = bound(int(totals[rows].sum()) * 8 + wtblk.numel() * 4 + len(rows) * pad * 8, 0, "f32")
    results["bm25_gather"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": None, **gbound}

    doc, imp = sort_pairs(*got, k_start=2 * block)
    # the main path's k, and the widest k over the same rows plus one row
    # that holds only the sentinel
    empty = torch.full_like(doc[:1], sentinel)
    wide_doc = torch.cat([doc, empty])
    wide_imp = torch.cat([imp, torch.zeros_like(imp[:1])])
    err = check_segment(doc, imp, K, sentinel, f"segment top-k [{len(rows)}, {pad}]")
    check_segment(wide_doc, wide_imp, TOPK_MAX, sentinel, "segment top-k with an empty row",
                  empty_rows=(-1,))
    # rows that test which block owns a run: a run across every chunk
    # boundary, a real part that ends mid-chunk, a sentinel-only row, equal
    # scores in different chunks
    bd, bi, ties = segment_boundary_rows(SEG_BOUNDARY_WIDTH)
    for k in (K, TOPK_MAX):
        err = max(err, check_segment(bd, bi, k, SEG_BOUNDARY_SENTINEL,
                                     f"segment top-k boundary rows k={k}",
                                     empty_rows=(2,), exact_rows=ties))
    print(f"  segment top-k [{len(rows)}, {pad}]: max abs err {err:.3g} (k={K}; k={TOPK_MAX} "
          f"with an empty row, and the boundary rows [{bd.shape[0]}, {bd.shape[1]}] at k={K} "
          f"and k={TOPK_MAX}, also agree)")
    results["segment_topk"] = {"max_abs_err": err, "library_ms": None,
                               **segment_times(doc, imp, sentinel, f"[{len(rows)}, {pad}]")}


def check_segment(doc, imp, k: int, sentinel: int, what: str, *, empty_rows=(),
                  exact_rows=()) -> float:
    """segment_topk against its plain version: scores allclose (rtol 1e-5,
    atol 1e-4: the plain version's ``scatter_add_`` sums in another order on
    the card); ids equal where the plain score is distinct from its
    neighbours, the (k+1)-th included; ``empty_rows`` all (0, -1);
    ``exact_rows`` (sums of exact dyadic values, ties included) equal in
    scores and ids. Returns the max abs error."""
    import torch

    from probing_rag_tpu_torch.ops.sparse import segment_topk, segment_topk_plain

    gv, gi = segment_topk(doc, imp, k=k, sentinel=sentinel)
    rv1, ri1 = segment_topk_plain(doc, imp, k=k + 1, sentinel=sentinel)
    sync()
    rv, ri = rv1[:, :k], ri1[:, :k]
    if not torch.allclose(gv, rv, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"{what}: scores differ")
    gap = (rv1[:, 1:] - rv1[:, :-1]).abs() > 1e-4  # [Q, k]
    distinct = gap.clone()
    distinct[:, 1:] &= gap[:, :-1]
    bad = int((gi[distinct] != ri[distinct]).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} ids differ where scores are distinct")
    for r in empty_rows:
        if not (bool((gi[r] == -1).all()) and bool((gv[r] == 0).all())):
            raise AssertionError(f"{what}: the sentinel-only row {r} is not empty")
    for r in exact_rows:
        if not (torch.equal(gv[r], rv[r]) and torch.equal(gi[r], ri[r])):
            raise AssertionError(f"{what}: row {r} of equal scores differs: {gv[r].tolist()} "
                                 f"{gi[r].tolist()} vs {rv[r].tolist()} {ri[r].tolist()}")
    return float((gv - rv).abs().max())


# the boundary rows: 32 chunks of 4096 slots (16 of 8192, 8 of 16384)
SEG_BOUNDARY_WIDTH = 1 << 17
SEG_BOUNDARY_SENTINEL = 1 << 20


def segment_boundary_rows(p: int):
    """Sorted (doc, impact) rows for the segment top-k's chunk ownership,
    on the card: row 0 pairs every even slot with the one before it, so a
    run crosses every chunk boundary; row 1's real part ends mid-chunk
    (5 x 4096 + 1234 slots); row 2 is the sentinel only; row 3 has six docs
    of equal top score (10.0, from exact dyadic postings) with heads in six
    chunks, one of them a run across a boundary, among runs of 1-3 postings
    of at most 3 each; row 4 has runs of 1-16 postings. Returns (doc, imp,
    the rows whose sums are exact: (3,))."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 7)
    s = SEG_BOUNDARY_SENTINEL
    doc = np.full((5, p), s, np.int32)
    imp = np.zeros((5, p), np.float32)
    doc[0] = (np.arange(p) + 1) // 2
    imp[0] = rng.random(p) * 3

    def runs(n, max_len):
        lens = rng.integers(1, max_len + 1, n)
        d = np.repeat(np.arange(n) * 3 + rng.integers(0, 3, n), lens)
        return d.astype(np.int32)

    real = 5 * 4096 + 1234
    doc[1, :real] = runs(real, 4)[:real]
    imp[1, :real] = rng.random(real) * 3
    d3 = runs(p, 3)[:p]
    doc[3] = d3
    imp[3] = (rng.integers(0, 12, p) / 4).astype(np.float32)  # dyadic, at most 2.75
    heads = np.flatnonzero(np.r_[True, d3[1:] != d3[:-1]])
    starts = [int(heads[np.searchsorted(heads, c * 4096 + 100)]) for c in (1, 4, 9, 17, 23)]
    b = 12 * 4096
    doc[3, b] = doc[3, b - 1]  # the run at slot b - 1 goes on over the boundary
    cross = b - 1
    while doc[3, cross - 1] == doc[3, b]:
        cross -= 1
    for h in starts + [cross]:
        end = h + 1
        while end < p and doc[3, end] == doc[3, h]:
            end += 1
        imp[3, h:end] = 0.0
        imp[3, h] = 2.5
        imp[3, h + 1 if end > h + 1 else h] += 7.5  # 10.0 exactly
    d4 = runs(p, 16)[:p]
    doc[4] = d4
    imp[4] = rng.random(p) * 3
    put = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return put(doc), put(imp), (3,)


def segment_times(doc, imp, sentinel: int, shape: str) -> dict:
    """segment_topk's time at k = K and its plain version's; the bound
    reads each row's slots up to its first sentinel (the kernel stops
    there) and writes k pairs. Returns the kernels-line fields."""
    from probing_rag_tpu_torch.ops.sparse import SEG_CHUNK, segment_topk, segment_topk_plain

    ms = cuda_ms(lambda: segment_topk(doc, imp, k=K, sentinel=sentinel))
    plain_ms = cuda_ms(lambda: segment_topk_plain(doc, imp, k=K, sentinel=sentinel))
    real = int((doc != sentinel).sum())
    q, p = doc.shape
    b = bound(real * 8 + q * K * 8, real, "f32")
    print(f"  segment top-k {shape}, k={K}, {real} real slots: kernel {ms:.4f} ms (chunk "
          f"{SEG_CHUNK}), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
          f"all {q * p} slots: {q * p * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, **b}


def blockwise_pairs(keys, vals, width: int):
    """``lexsorted_pairs`` of every ``width`` block of each row."""
    q, p = keys.shape
    return lexsorted_pairs(keys.reshape(q * p // width, width), vals.reshape(q * p // width, width))


def check_equal(got, ref, what: str) -> float:
    """A gather's (doc, impact) rows against its plain version's: equal bit
    for bit. Returns the max abs error (0)."""
    import torch

    sync()
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError(f"{what}: rows differ from the plain version")
    return max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))


def phase_dma_gather(dma_engine, queries) -> dict:
    """The aligned gather's plain form, kernel vs plain, on one chunk of the
    "dma" mode's commonest bucket of the phase-4 stream, as the engine plans
    it; then the full sort of those rows against ``torch.sort``. Returns
    the gather's max abs error."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.ops.sort import sort_pairs, sort_pairs_plain
    from probing_rag_tpu_torch.ops.sparse import postings_gather, postings_gather_plain
    from probing_rag_tpu_torch.retrieval.bm25 import trim_to_cap

    eng = dma_engine
    lens = eng._term_lens
    a_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    totals = [int(lens[np.asarray(q, np.int64)].sum()) for q in queries]
    pads = np.asarray([eng._bucket_pad(min(t, eng.max_pad), base=4) for t in totals])
    widths, counts = np.unique(pads, return_counts=True)
    print("  dma-mode buckets of the query stream: "
          + ", ".join(f"{w}: {c}" for w, c in zip(widths, counts)))
    pad = int(widths[np.argmax(counts)])
    rows = np.nonzero(pads == pad)[0][: eng.q_tile]  # one chunk, as the engine runs it
    kept = [trim_to_cap(lens, np.asarray(queries[i], np.int64), eng.max_pad)[0] for i in rows]
    tq = max(max(len(k) for k in kept), 1)
    starts = np.zeros((len(rows), tq), np.int32)
    alens = np.zeros((len(rows), tq), np.int32)
    for r, ids in enumerate(kept):
        starts[r, : len(ids)] = a_start[ids]
        alens[r, : len(ids)] = lens[ids]
    args = (*eng._aligned, torch.from_numpy(starts).to(DEVICE), torch.from_numpy(alens).to(DEVICE))
    sentinel = eng.index.n_docs
    got = postings_gather(*args, pad=pad, sentinel=sentinel)
    err = check_equal(got, postings_gather_plain(*args, pad=pad, block=1024, sentinel=sentinel),
                      f"postings_gather [{len(rows)}, {pad}]")
    ms = cuda_ms(lambda: postings_gather(*args, pad=pad, sentinel=sentinel))
    plain_ms = cuda_ms(lambda: postings_gather_plain(*args, pad=pad, block=1024, sentinel=sentinel))
    real = int((got[0] != sentinel).sum())
    b = bound(real * 8 + len(rows) * pad * 8, 0, "f32")
    print(f"  postings_gather, plain form (dma) [{len(rows)}, {pad}], {real} real postings: "
          f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms")
    sk, sv = sort_pairs(*got)
    rk, rv = sort_pairs_plain(*got)
    sync()
    if not (torch.equal(sk, rk) and all(torch.equal(a, c) for a, c in
                                        zip(lexsorted_pairs(sk, sv), lexsorted_pairs(rk, rv)))):
        raise AssertionError(f"dma full sort [{len(rows)}, {pad}]: differs from plain")
    sort_ms = cuda_ms(lambda: sort_pairs(*got))
    lib_ms = cuda_ms(lambda: torch.sort(got[0], dim=1, stable=True))
    print(f"  dma full sort [{len(rows)}, {pad}] (k_start 2): equal; bitonic kernel {sort_ms:.4f} ms, "
          f"torch.sort {lib_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}


def assemble_case(what: str, aargs, pad: int, sentinel: int) -> dict:
    """``postings_assemble`` on ``aargs`` (compact store, src, rlen, weights
    or None) against its plain version, bit for bit, then both timed with
    the bound (8 bytes read for each real posting kept, 8 written a slot);
    prints the plan it launched (``ops/sparse.py::last_plan``). Returns
    the kernels line's entry."""
    from probing_rag_tpu_torch.ops import sparse

    sparse.last_plan = None
    got = sparse.postings_assemble(*aargs, pad=pad, sentinel=sentinel)
    plan = sparse.last_plan
    if DEVICE == "cuda" and plan is None:
        raise AssertionError(f"postings_assemble {what}: no kernel launched")
    err = check_equal(got, sparse.postings_assemble_plain(*aargs, pad=pad, sentinel=sentinel),
                      f"postings_assemble {what}")
    ms = cuda_ms(lambda: sparse.postings_assemble(*aargs, pad=pad, sentinel=sentinel))
    plain_ms = cuda_ms(lambda: sparse.postings_assemble_plain(*aargs, pad=pad, sentinel=sentinel))
    m = aargs[2].shape[0]
    real = int(aargs[3].sum(dim=1).clamp(max=pad).sum())
    b = bound(real * 8 + m * pad * 8, 0, "f32")
    grid = "none (CPU)" if plan is None else (
        f"span {plan.span}, grid {plan.grid} ({plan.grid[0] * plan.grid[1]} blocks)")
    print(f"  postings_assemble, {what}, {real} postings kept: equal; plan {grid}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b}


def wide_short_bucket(engine, rng):
    """The over-cap hybrid's widest bucket with no long term (the route
    that runs ``postings_assemble`` alone): ``OVERCAP_QUERIES`` rows of
    distinct short terms of the store, each row over half of
    ``WIDE_SHORT_PAD`` postings, so the engine's planner
    (``_fallback_chunks``) gives it ``pad_short = WIDE_SHORT_PAD``. The
    terms come from the longest short lists, as few as hold
    ``WIDE_SHORT_PAD`` postings. Returns (rows, pad_short, the most terms a
    row, the assembly's arguments on the card)."""
    import numpy as np
    import torch

    lens = engine._term_lens
    short = np.nonzero((engine._store.aligned_len == 0) & (lens > 0))[0]
    short = short[np.argsort(-lens[short], kind="stable")]
    pool = short[: int(np.searchsorted(np.cumsum(lens[short]), WIDE_SHORT_PAD)) + 1]
    if lens[pool].sum() < WIDE_SHORT_PAD:
        raise AssertionError(f"the store's short terms hold {lens[pool].sum()} postings, "
                             f"under {WIDE_SHORT_PAD}")
    rows, weights = [], []
    for _ in range(OVERCAP_QUERIES):
        ids = rng.permutation(pool)
        target = int(rng.uniform(0.55, 0.95) * WIDE_SHORT_PAD)
        ids = ids[: int(np.searchsorted(np.cumsum(lens[ids]), target)) + 1]
        rows.append(ids)
        weights.append(rng.integers(1, 4, len(ids)).astype(np.float32))
    chunks = list(engine._fallback_chunks(rows, weights))
    if len(chunks) != 1 or chunks[0][1] != 0 or chunks[0][2] != WIDE_SHORT_PAD:
        raise AssertionError(f"wide short bucket planned as {[c[1:3] for c in chunks]}")
    _, _, pad_short, desc = chunks[0]
    ssrc, srlen, sw = (torch.from_numpy(a).to(DEVICE) for a in desc[3:])
    st = engine._dev_store
    tq = max(len(r) for r in rows)
    if tq <= WIDE_SHORT_MIN_TERMS:
        raise AssertionError(f"wide short bucket: {tq} terms a row, want over "
                             f"{WIDE_SHORT_MIN_TERMS}")
    return len(rows), pad_short, tq, (st[4], st[5], ssrc, srlen, sw)


def overcap_batch(index):
    """Phase 3's over-cap batch: ``OVERCAP_QUERIES`` queries of
    ``OVERCAP_TOKENS`` Zipf tokens each, as term ids, and the generator
    that drew them (phase 3 draws on from it)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    return [index.encode_query([f"t{t}" for t in zipf_tokens(rng, OVERCAP_TOKENS) % VOCAB])
            for _ in range(OVERCAP_QUERIES)], rng


def phase_hybrid_kernels(engine, index, results: dict, dma_gather: dict) -> None:
    """The over-cap hybrid's kernels on one batch of Zipf-text queries, on
    the first chunk the engine plans with long terms: the E/O gather of the
    long terms with block weights, the assembly of the short tails
    (weighted, unweighted, and cut at half their pad; then the widest
    bucket with no long term, ``wide_short_bucket``, and one posting a
    row, the grid's floor), the ``k_stop = 1024`` sort of the tails; each
    against its plain version. Then the chunk's full sort and segment
    top-k times."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.ops.sort import sort_pairs, sort_pairs_plain
    from probing_rag_tpu_torch.ops.sparse import (
        postings_assemble, postings_gather, postings_gather_plain,
    )
    from probing_rag_tpu_torch.retrieval.bm25 import _hybrid_rows, _weight_blocks

    qs, rng = overcap_batch(index)
    lists, weights, plan, over = engine._route(qs)
    if not over.all():
        raise AssertionError(f"over-cap batch: {int((~over).sum())} rows under max_pad")
    chunks = engine._fallback_chunks(lists, weights)
    sel, pad_big, pad_short, desc = next(c for c in chunks if c[1] > 0)
    print(f"  over-cap batch: {len(qs)} queries of {OVERCAP_TOKENS} Zipf tokens, slot totals "
          f"{plan[5].min()}-{plan[5].max()}; {engine.last_stats}; hybrid widths "
          f"{engine.last_widths['hybrid']}")
    bstarts, blens, bw, ssrc, srlen, sw = (torch.from_numpy(a).to(DEVICE) for a in desc)
    st = engine._dev_store
    block = engine._store.block
    sentinel = index.n_docs
    m = len(sel)
    wtblk = torch.from_numpy(_weight_blocks(desc[1], desc[2], pad_big, block)).to(DEVICE)
    gargs = (st[0], st[1], bstarts, blens, st[2], st[3], wtblk)
    gkw = dict(pad=pad_big, block=block, sentinel=sentinel)
    run_gather = lambda: postings_gather(*gargs[:4], doc_o=st[2], imp_o=st[3], wtblk=wtblk, **gkw)  # noqa: E731
    got = run_gather()
    err = check_equal(got, postings_gather_plain(*gargs, **gkw), f"postings_gather E/O [{m}, {pad_big}]")
    ms = cuda_ms(run_gather)
    plain_ms = cuda_ms(lambda: postings_gather_plain(*gargs, **gkw))
    real = int((got[0] != sentinel).sum())
    b = bound(real * 8 + m * pad_big * 8, 0, "f32")
    print(f"  postings_gather, E/O form with block weights [{m}, {pad_big}], {real} real postings: "
          f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms")
    results["postings_gather"] = {"max_abs_err": max(err, dma_gather["max_abs_err"]), "ms": ms,
                                  "plain_ms": plain_ms, "library_ms": None, **b}

    aargs = (st[4], st[5], ssrc, srlen, sw)
    results["postings_assemble"] = assemble_case(
        f"weighted [{m}, {pad_short}], {int((desc[4] > 0).sum())} short terms", aargs,
        pad_short, sentinel)
    extra = {"unweighted": assemble_case(f"unweighted [{m}, {pad_short}], the same terms",
                                         aargs[:4] + (None,), pad_short, sentinel),
             "cut": assemble_case(f"weighted [{m}, {pad_short // 2}], the same terms, rows "
                                  "cut at pad", aargs, pad_short // 2, sentinel)}
    rows_w, pad_w, tq_w, wargs = wide_short_bucket(engine, rng)
    extra["wide"] = assemble_case(f"weighted [{rows_w}, {pad_w}], no long term, {tq_w} short "
                                  "terms at most a row", wargs, pad_w, sentinel)
    # the floor of this grid at the first shape: one posting a row, so the
    # launch, the descriptor and compact loads and the stores; and one
    # library kernel writing the doc rows alone
    one = (st[4], st[5], torch.zeros((m, 1), dtype=torch.int32, device=DEVICE),
           torch.ones((m, 1), dtype=torch.int32, device=DEVICE), None)
    extra["floor"] = assemble_case(f"one posting a row [{m}, {pad_short}]", one, pad_short,
                                   sentinel)
    scratch = torch.empty((m, pad_short), dtype=torch.int32, device=DEVICE)
    fill_ms = cuda_ms(lambda: scratch.fill_(sentinel))
    print(f"  fill_ of [{m}, {pad_short}] int32 (half the assembly's writes): {fill_ms:.4f} ms")
    results["postings_assemble"]["wide_shape"] = f"[{rows_w}, {pad_w}]"
    results["postings_assemble"]["fill_ms"] = fill_ms
    for case, r in extra.items():  # the kernels line's extra shapes
        results["postings_assemble"].update(
            {f"{case}_{k}": r[k] for k in ("ms", "plain_ms", "bound_ms")})

    tail = postings_assemble(*aargs, pad=pad_short, sentinel=sentinel)
    sk, sv = sort_pairs(*tail, k_stop=block)
    rk, rv = sort_pairs_plain(*tail, k_stop=block)
    sync()
    if not (torch.equal(sk, rk) and all(torch.equal(a, c) for a, c in zip(
            blockwise_pairs(sk, sv, block), blockwise_pairs(rk, rv, block)))):
        raise AssertionError(f"sort k_stop={block} [{m}, {pad_short}]: blocks differ from plain")
    ms = cuda_ms(lambda: sort_pairs(*tail, k_stop=block))
    plain_ms = cuda_ms(lambda: sort_pairs_plain(*tail, k_stop=block))
    print(f"  sort k_stop={block} [{m}, {pad_short}]: keys equal, pairs equal per block; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")

    def rows():
        return _hybrid_rows(st, bstarts, blens, wtblk, ssrc, srlen, sw, pad_big=pad_big,
                            pad_short=pad_short, sentinel=sentinel, block=block)

    doc, imp, k_start = rows()
    sd, si = sort_pairs(doc, imp, k_start=k_start)
    check_sorted_pairs((sd, si), sort_pairs_plain(doc, imp), f"the chain's sort [{m}, {pad_big}]")
    check_segment(sd, si, K, sentinel, f"the chain's segment top-k [{m}, {pad_big}]")
    sort_ms = cuda_ms(lambda: sort_pairs(doc, imp, k_start=k_start))
    sort_lib = cuda_ms(lambda: torch.sort(doc, dim=1, stable=True))
    sb = sort_bound(m, pad_big, k_start, pad_big)
    seg = segment_times(sd, si, sentinel, f"(the chain's) [{m}, {pad_big}]")
    times = {"rows (gather + assemble + k_stop sort)": cuda_ms(rows),
             f"sort k_start {k_start}": sort_ms, f"segment top-k k={K}": seg["ms"]}
    print(f"  the chunk's hybrid chain [{m}, {pad_big}]: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f"; the sort's bound {sb['bound_ms']:.4f} ms, torch.sort {sort_lib:.4f} ms")
    chain = f"[{m}, {pad_big}]"
    results["bitonic_sort_wide"].update(chain_shape=chain, chain_ms=sort_ms,
                                        chain_library_ms=sort_lib, chain_bound_ms=sb["bound_ms"])
    results["segment_topk"].update(chain_shape=chain, chain_ms=seg["ms"],
                                   chain_plain_ms=seg["plain_ms"], chain_bound_ms=seg["bound_ms"])


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


def recall_at_10(engine, index, queries, sample) -> float:
    """Score-threshold recall@10 of ``engine`` against the exact host oracle
    (bench.py) on the ``sample`` queries."""
    import numpy as np

    rk = 10
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
    return float(np.mean(recalls)) if recalls else 1.0


def phase_bm25(engine, dma_engine, cpu_engine, index, queries, rng) -> None:
    from probing_rag_tpu_torch import kernels

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
    ref = cpu_engine.search_term_ids(queries, k=K + 1)
    assert_same_topk(res, ref, "phase-4 queries")
    print(f"  equal to the plain path (CPU) on all {len(queries)} queries")
    sample = rng.choice(len(queries), size=64, replace=False)
    recall = recall_at_10(engine, index, queries, sample)
    print(f"  recall@10 vs oracle on 64 sampled queries: {recall}")
    if recall != 1.0:
        raise AssertionError(f"recall@10 {recall} != 1.0")

    # the same queries through the "dma" mode, with its own launch counts
    kernels.reset_launches()
    sync()
    t0 = time.time()
    res = dma_engine.search_term_ids(queries, k=K)
    sync()
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    t0 = time.time()
    res = dma_engine.search_term_ids(queries, k=K)
    sync()
    dt2 = time.time() - t0
    print(f"  dma mode, {len(queries)} queries: {dt:.3f}s first pass, {dt2:.3f}s second "
          f"({len(queries) / dt2:.0f} q/s end to end); {dma_engine.last_stats}; row widths "
          f"{dma_engine.last_widths['dma']}; kernel launches (first pass) {launches}")
    if launches["postings_gather"] == 0 or launches["bm25_gather"] or launches["postings_assemble"]:
        raise AssertionError(f"dma mode launched {launches}")
    assert_same_topk(res, ref, "phase-4 queries, dma mode")
    recall = recall_at_10(dma_engine, index, queries, sample)
    print(f"  dma mode: equal to the plain path (CPU) on all {len(queries)} queries; recall@10 "
          f"vs oracle on the 64 sampled queries: {recall}")
    if recall != 1.0:
        raise AssertionError(f"dma mode recall@10 {recall} != 1.0")


def phase_lm_reference() -> float:
    """The port's forward on the card against the same forward on the CPU
    (tiny config, f32, shared parameters): max abs logit difference."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig, forward, init_params

    cfg = dataclasses.replace(GemmaConfig.tiny(), compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
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
    rest, and keeps each call's queries, stats and result."""

    def __init__(self, engine):
        self.engine = engine
        self.seconds = 0.0
        self.calls = []
        self.stats = []
        self.results = []

    def search(self, queries, k=5):
        sync()
        t0 = time.time()
        res = self.engine.search(queries, k=k)
        sync()
        self.seconds += time.time() - t0
        self.calls.append(list(queries))
        self.stats.append(dict(getattr(self.engine, "last_stats", {})))
        self.results.append(res)
        return res


class TextStore:
    """The pipeline's docstore interface over a list of passage texts."""

    def __init__(self, texts):
        self._texts = texts

    def texts(self, indices):
        return [self._texts[i] for i in indices]


def phase_main_path(index, docs_tokens, cpu_engine):
    """``rag-run --retr-method probing`` at Gemma-2B width through the
    pipeline API: random bf16 weights and probers from a seed. Returns the
    kernel launch counts of the probing loop, (params, config, probers,
    tokenizer, docstore) for the dense and quantized paths, and the
    questions."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import StopTables, generate
    from probing_rag_tpu_torch.ops.sort import MAX_SORT_WIDTH
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    err = phase_lm_reference()
    print(f"  tiny f32 forward, card vs CPU: max abs logit diff {err:.3g}")

    lm = gemma_2b_lm(docs_tokens)
    params, cfg, probers, tok, store = lm
    tc = ProberTrainConfig(layers=cfg.probe_layers, positions=("resid_post",))
    engine = BM25Engine(index, device=DEVICE)
    retriever = TimedRetriever(engine)
    questions = loop_questions(index)
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
    print(f"  each search's stats: {retriever.stats}")
    if not any(st["n_fallback"] > 0 for st in retriever.stats[1:]):
        raise AssertionError("no later search of the loop routed a row to the over-cap hybrid")
    missing = [n for n in BM25_KERNELS + ("decode_attention", "prefill_attention") + BLOCK_KERNELS
               if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the BM25 path: {missing}")
    forwards = launches["rope_kv"] // cfg.n_layers
    if (launches["rope_kv"], launches["gated_act"], launches["rms_norm"]) != (
            forwards * cfg.n_layers, forwards * cfg.n_layers, forwards * (2 * cfg.n_layers + 1)):
        raise AssertionError(f"the block's kernels launched {[launches[n] for n in BLOCK_KERNELS]} "
                             f"times: not one rope_kv and gated_act a layer a forward and "
                             f"2 x {cfg.n_layers} + 1 norms a forward")
    if launches["prefill_attention"] % cfg.n_layers:
        raise AssertionError(f"prefill_attention launched {launches['prefill_attention']} times, "
                             f"not {cfg.n_layers} a prefill")

    # the loop's first search (the questions) and last one (whole
    # generations, over-cap rows) again: kernels against the plain path
    refs = {}
    for label, queries in (("first", retriever.calls[0]), ("last", retriever.calls[-1])):
        res = engine.search(queries, k=K)
        stats = engine.last_stats
        refs[label] = cpu_engine.search(queries, k=K + 1)
        assert_same_topk(res, refs[label], f"{label} loop search")
        print(f"  {label} loop search again ({len(queries)} queries, {stats}): "
              f"equal to the plain path (CPU)")
    # the last search through both card routes: the default (rows over 512K
    # slots on the hybrid) and every row on the bitonic kernels
    single = BM25Engine(index, device=DEVICE, max_pad=MAX_SORT_WIDTH)
    last = retriever.calls[-1]
    routes = (("hybrid", engine), ("single path", single))
    secs = {name: [] for name, _ in routes}
    for name, eng in routes:
        assert_same_topk(eng.search(last, k=K), refs["last"], f"last loop search, {name}")
        print(f"  last search, {name} route: equal to the CPU; {eng.last_stats}; row widths "
              f"{eng.last_widths}")
    for name, eng in routes + routes[::-1]:
        sync()
        t0 = time.time()
        eng.search(last, k=K)
        sync()
        secs[name].append(time.time() - t0)
    print("  last search seconds (two runs each, in turns): "
          + "; ".join(f"{n} {', '.join(f'{t:.4f}' for t in ts)}" for n, ts in secs.items()))
    del single

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
    return launches, lm, questions


def gemma_2b_lm(docs_tokens):
    """Phase 5's model: ``GemmaConfig.gemma_2b()`` with random bf16 weights
    and a random resid_post prober stack from ``SEED``, the byte tokenizer
    and a docstore of the corpus's texts. Returns (params, config,
    probers, tokenizer, docstore)."""
    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_params
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig, init_prober_stack

    cfg = GemmaConfig.gemma_2b()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.time()
    params = init_params(cfg, gen, device=DEVICE, dtype=torch.bfloat16)
    n_params = sum(w.numel() for v in params.values()
                   for w in (v.values() if isinstance(v, dict) else [v]))
    tc = ProberTrainConfig(layers=cfg.probe_layers, positions=("resid_post",))
    probers = init_prober_stack(tc, cfg.d_model, gen, device=DEVICE)
    sync()
    allocated = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    print(f"  Gemma-2B width: {n_params / 1e9:.3f}B params (bf16), initialised in "
          f"{time.time() - t0:.1f}s; {allocated / 2**30:.2f} GiB allocated")
    store = TextStore([" ".join(d) for d in docs_tokens])
    return params, cfg, probers, ByteTokenizer(cfg.vocab_size), store


def loop_questions(index):
    """The loop's 16 questions of corpus terms: the even ones hold six of
    the 24 heaviest terms, so their first retrieval's rows are wider than
    32K (the wide sort); the odd ones only mid-frequency terms (narrow
    rows). Later rounds search with whole generations, which are wider
    still."""
    import numpy as np

    lens = index.term_offsets[1:] - index.term_offsets[:-1]
    heavy = np.argsort(lens)[::-1]
    names = {v: k for k, v in index.vocab.items()}
    rng = np.random.default_rng(SEED + 5)
    questions = []
    for i in range(16):
        terms = [names[int(t)] for t in rng.choice(heavy[:24], 6 if i % 2 == 0 else 0, replace=False)]
        terms += [names[int(t)] for t in rng.choice(heavy[1000:20000], 3, replace=False)]
        questions.append("What links " + " and ".join(terms) + "?")
    return questions


def check_topk(got, ref, what: str, rtol: float = 1e-4, atol: float = 1e-3):
    """A kernel's (scores, ids) against its plain version's on the same
    inputs: scores allclose (the sums run in another order), ids equal where
    the plain scores are distinct from their neighbours, and recall@10 of
    the plain ids. Returns (max abs error over finite scores, recall)."""
    import numpy as np

    gv, gi = (t.cpu().numpy() for t in got)
    rv, ri = (t.cpu().numpy() for t in ref)
    if not np.allclose(gv, rv, rtol=rtol, atol=atol):  # +-inf must match exactly
        raise AssertionError(f"{what}: scores differ, max {np.nanmax(np.abs(gv - rv))}")
    fin = np.isfinite(rv)
    err = float(np.abs(gv - rv)[fin].max()) if fin.any() else 0.0
    gap = np.abs(np.diff(np.where(fin, rv, 0.0), axis=1)) > atol
    distinct = np.ones_like(ri, bool)
    distinct[:, 1:] &= gap
    distinct[:, :-1] &= gap
    bad = int((gi[distinct] != ri[distinct]).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} ids differ where the scores are distinct")
    k = min(10, ri.shape[1])
    recall = float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(gi, ri)]))
    if recall != 1.0:
        raise AssertionError(f"{what}: recall@{k} {recall} != 1.0")
    return err, recall


def phase_dense_kernels(results: dict) -> None:
    """The flat dense top-k against its plain version at bench_dense.py's
    shape, the coarse quantizer's and the probing loop's, and at the edges
    of the planner's query tiles; each case prints the regime it ran."""
    import torch

    from probing_rag_tpu_torch.ops import dense as dense_mod
    from probing_rag_tpu_torch.ops.dense import (
        dense_topk, dense_topk_plain, dense_topk_rerank, prepare_dense_store,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    emb = torch.randn((DENSE_N, DENSE_D), generator=gen, device=DEVICE)
    q = torch.randn((DENSE_Q, DENSE_D), generator=gen, device=DEVICE)
    cent = torch.randn((QUANT_NLIST, DENSE_D), generator=gen, device=DEVICE)
    cq = torch.randn((QUANT_Q, DENSE_D), generator=gen, device=DEVICE)
    q_edge = torch.randn((max(EDGE_QS), DENSE_D), generator=gen, device=DEVICE)
    bf16 = torch.bfloat16
    l2_bf16 = prepare_dense_store(emb, metric="l2", store_dtype=bf16)
    ip_bf16 = prepare_dense_store(emb, metric="ip", store_dtype=bf16)
    # (label, queries, store, arguments, the regime the planner must pick)
    cases = [
        ("ip bf16", q, ip_bf16, dict(k=DENSE_K, metric="ip"), "wgmma"),
        ("l2 bf16", q, l2_bf16, dict(k=DENSE_K, metric="l2"), "wgmma"),
        ("l2 int8, rerank pool", q, prepare_dense_store(emb, metric="l2", store_dtype=torch.int8),
         dict(k=32, k_pad=32, metric="l2"), "wgmma"),
        ("ip int8 x int8", q, prepare_dense_store(emb, metric="ip", store_dtype=torch.int8),
         dict(k=DENSE_K, metric="ip", mxu_int8=True), "wgmma"),
        ("l2 f32 coarse quantizer", cq, prepare_dense_store(cent, metric="l2"),
         dict(k=IVF_NPROBE, k_pad=IVF_NPROBE, metric="l2"), "staged"),
        ("l2 f32 coarse quantizer, wide nprobe", cq, prepare_dense_store(cent, metric="l2"),
         dict(k=WIDE_NPROBE, k_pad=WIDE_NPROBE, metric="l2"), "staged"),
        # the probing loop's own traffic: 8 queries over the phase-7 index size
        ("l2 bf16, the loop's shape", q[:N_DENSE_QUESTIONS].contiguous(),
         prepare_dense_store(emb[:N_DOCS], metric="l2", store_dtype=bf16),
         dict(k=K, metric="l2"), "wgmma"),
        # the planner's tile edges: widths 8, 16, 72 and 3 x 88; full tiles of 72
        *[(f"l2 bf16, {nq} queries", q_edge[:nq].contiguous(), l2_bf16,
           dict(k=DENSE_K, metric="l2"), "wgmma") for nq in EDGE_QS],
        # a store length that is no multiple of the 128-row step or a chunk
        (f"ip bf16, n {DENSE_N - RAGGED_N_CUT}", q, ip_bf16,
         dict(k=DENSE_K, metric="ip", n_total=DENSE_N - RAGGED_N_CUT), "wgmma"),
        # the widest lists (the coarse quantizer's nprobe 256), in bf16
        ("l2 bf16, k 256", q, l2_bf16, dict(k=256, k_pad=256, metric="l2"), "wgmma"),
    ]
    # widths that are not a multiple of the kernel's 64-deep step (the
    # CLI's tiny encoder has D = 32); D = 100 has a pitch TMA cannot take
    for d in TAIL_DS:
        te = torch.randn((TAIL_N, d), generator=gen, device=DEVICE)
        tq = torch.randn((TAIL_Q, d), generator=gen, device=DEVICE)
        i8 = torch.int8
        tma = "wgmma" if d * 2 % 16 == 0 else "staged"  # bf16 pitch
        tma8 = "wgmma" if d % 16 == 0 else "staged"  # int8 pitch
        cases += [
            (f"l2 bf16 D={d}", tq, prepare_dense_store(te, metric="l2", store_dtype=bf16),
             dict(k=K, metric="l2"), tma),
            (f"ip int8 D={d}", tq, prepare_dense_store(te, metric="ip", store_dtype=i8),
             dict(k=K, k_pad=32, metric="ip"), tma8),
            (f"l2 f32 D={d}", tq, prepare_dense_store(te, metric="l2"), dict(k=K, metric="l2"),
             "staged"),
            (f"ip int8 x int8 D={d}", tq, prepare_dense_store(te, metric="ip", store_dtype=i8),
             dict(k=K, metric="ip", mxu_int8=True), tma8),
        ]
    max_err = 0.0
    for label, qq, st, kw, regime in cases:
        kw = dict(dict(sq_norms=st.sq_norms, scales=st.scales, n_total=st.n_docs), **kw)
        dense_mod.last_plan = None
        got = dense_topk(qq, st.embeddings, **kw)
        plan = dense_mod.last_plan
        ref = dense_topk_plain(qq, st.embeddings, **kw)
        sync()
        err, recall = check_topk(got, ref, f"dense_topk {label}")
        if label.startswith("ip int8 x int8") and err != 0.0:
            raise AssertionError(f"dense_topk {label}: int8 x int8 differs from plain by {err}")
        if DEVICE == "cuda" and plan.regime != regime:
            raise AssertionError(f"dense_topk {label}: regime {plan.regime}, expected {regime}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda qq=qq, st=st, kw=kw: dense_topk(qq, st.embeddings, **kw))
        plain_ms = cuda_ms(lambda qq=qq, st=st, kw=kw: dense_topk_plain(qq, st.embeddings, **kw))
        nq, d = qq.shape
        n = kw["n_total"]
        shape = f"[{nq} x {n} x {d}]"
        how = "plain" if plan is None else plan.regime if plan.regime == "staged" else (
            f"wgmma: {plan.qtiles} x {plan.qt} queries at width {plan.ntile}, {plan.nchunks} "
            f"chunks, {plan.stages} stages of {plan.boxes}, "
            f"{'resident' if plan.resident else 'streamed'} queries")
        print(f"  dense_topk {label} {shape}, k {kw['k']} ({how}): max abs err {err:.3g}, "
              f"recall@10 {recall}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        elt = st.embeddings.element_size()
        if label == "ip bf16":
            results["dense_topk"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                **bound(n * d * elt + nq * d * 2 + nq * kw["k"] * 8, 2 * nq * n * d, "bf16")}
            # a yardstick, never called by the port: cuBLAS scores, then top-k
            qb = qq.to(bf16)
            yard = cuda_ms(lambda: torch.topk(qb @ st.embeddings.T, kw["k"], dim=1))
            print(f"  yardstick torch.topk(q @ emb.T, {kw['k']}) (two calls, [{nq} x {n}] "
                  f"scores written): {yard:.4f} ms")
            results["dense_topk"]["yardstick_ms"] = yard
        if label == "l2 bf16, the loop's shape":
            lb = bound(n * d * elt + n * 4 + nq * d * 2 + nq * kw["k"] * 8, 2 * nq * n * d, "bf16")
            results["dense_topk"].update(loop_ms=ms, loop_plain_ms=plain_ms,
                                         loop_bound_ms=lb["bound_ms"])
            print(f"  the loop's shape: bound {lb['bound_ms']:.4f} ms ({lb['bound_by']})")
        if label.startswith("l2 int8"):
            rerank_emb = emb.to(bf16)
            rr = cuda_ms(lambda: dense_topk_rerank(
                q, st.embeddings, rerank_emb, k=DENSE_K, metric="l2", sq_norms=st.sq_norms,
                scales=st.scales, n_total=st.n_docs, k_pad=32))
            print(f"  dense_topk_rerank (int8 sweep + bf16 refine, k {DENSE_K}): {rr:.3f} ms")
            del rerank_emb
    results["dense_topk"]["max_abs_err"] = max_err


def clustered_corpus(gen):
    """bench_ivf.py's clustered corpus, drawn on the card: IVF_CLUSTERS
    normal centres, each point a centre plus 0.3 x normal noise."""
    import torch

    centers = torch.randn((IVF_CLUSTERS, DENSE_D), generator=gen, device=DEVICE)
    assign = torch.randint(0, IVF_CLUSTERS, (IVF_N,), generator=gen, device=DEVICE)
    return centers[assign] + 0.3 * torch.randn((IVF_N, DENSE_D), generator=gen, device=DEVICE)


def phase_ivf_kernels(results: dict) -> None:
    """The IVF block top-k against its plain version at bench_ivf.py's
    shape: k-means on the card, then Q = 64 and Q = 8, bf16 and int8."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.ops import ivf as ivf_mod
    from probing_rag_tpu_torch.ops.ivf import QT, ivf_topk, ivf_topk_plain
    from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex, IVFEngine

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    emb = clustered_corpus(gen)
    host = emb.cpu().numpy()
    sync()
    t0 = time.time()
    index = IVFDenseIndex.build(host, nlist=IVF_NLIST, block=IVF_BLOCK, metric="ip",
                                seed=SEED, device=DEVICE)
    print(f"  IVF build over {IVF_N} x {DENSE_D} (k-means on the card, nlist {IVF_NLIST}): "
          f"{time.time() - t0:.1f}s; {index.pad_block} blocks of {IVF_BLOCK}, imbalance "
          f"{index.imbalance_factor():.3f}")
    rng = np.random.default_rng(SEED + 12)
    max_err = 0.0
    for dt in (torch.bfloat16, torch.int8):
        eng = IVFEngine(index, nprobe=IVF_NPROBE, device=DEVICE, store_dtype=dt)
        for nq in IVF_QS:
            picks = torch.from_numpy(rng.choice(IVF_N, nq, replace=False)).to(DEVICE)
            qe = emb[picks] + 0.1 * torch.randn((nq, DENSE_D), generator=gen, device=DEVICE)
            desc = eng.plan(eng.probe_cells(qe.cpu().numpy()))
            t = desc.shape[0]
            qpad = torch.cat([qe, qe[:1].expand(t * QT - nq, -1)]).contiguous()
            dd = torch.from_numpy(desc).to(DEVICE)
            args = (qpad, dd, eng._emb, eng._ids)
            kw = dict(k=DENSE_K, metric="ip", block=IVF_BLOCK, sq_norms=eng._sqn,
                      scales=eng._scales)
            ivf_mod.last_plan = None
            got = ivf_topk(*args, **kw)
            plan = ivf_mod.last_plan
            ref = ivf_topk_plain(*args, **kw)
            sync()
            label = f"ivf_topk {str(dt)[6:]} Q={nq}"
            err, recall = check_topk(got, ref, label)
            if DEVICE == "cuda" and plan.regime != "wgmma":
                raise AssertionError(f"{label}: regime {plan.regime}, expected wgmma")
            max_err = max(max_err, err)
            ms = cuda_ms(lambda args=args, kw=kw: ivf_topk(*args, **kw))
            plain_ms = cuda_ms(lambda args=args, kw=kw: ivf_topk_plain(*args, **kw))
            real = int((desc != index.pad_block).sum())
            rows = real * IVF_BLOCK  # each tile of 8 queries scores its own blocks
            nbytes = rows * (DENSE_D * eng._emb.element_size() + 4) + nq * DENSE_D * 2 \
                + nq * DENSE_K * 8
            how = "plain" if plan is None else (
                f"{plan.regime}: {plan.nsplit} blocks a tile of {plan.per_split} items")
            print(f"  {label} ({how}): [{t} tiles x {desc.shape[1]} descriptors, {real} real "
                  f"blocks, {nbytes / 1e6:.0f} MB read]: max abs err {err:.3g}, recall@10 "
                  f"{recall}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
            bnd = bound(nbytes, 2 * QT * rows * DENSE_D, "bf16")  # int8 rows widen to bf16
            if dt == torch.bfloat16 and nq == IVF_QS[0]:
                results["ivf_topk"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd}
            if dt == torch.bfloat16 and nq == N_DENSE_QUESTIONS:
                results["ivf_topk"].update(loop_ms=ms, loop_plain_ms=plain_ms,
                                           loop_bound_ms=bnd["bound_ms"], loop_mb=nbytes / 1e6)
                print(f"  the loop's Q {nq}: bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        del eng
    # a probe wider than dense_topk's lists (a full score row and a sort)
    # on the card against the same probe on the CPU, then the search it plans
    from probing_rag_tpu_torch.retrieval.ivf import probe_cells_host

    eng = IVFEngine(index, nprobe=WIDEST_NPROBE, device=DEVICE)
    qe = emb[: IVF_QS[1]] + 0.1 * torch.randn((IVF_QS[1], DENSE_D), generator=gen, device=DEVICE)
    qh = qe.cpu().numpy()
    probes = eng.probe_cells(qh)
    cpu = probe_cells_host(qh, eng._cent.cpu(), eng._cent_sqn.cpu(), WIDEST_NPROBE, index.nlist)
    cent = index.centroids.astype(np.float64)
    dist = lambda pr: np.sort(((qh[:, None, :].astype(np.float64) - cent[pr]) ** 2).sum(-1), 1)
    # cells whose distances tie to f32 rounding may swap at the boundary:
    # the probed distances must agree, the cells almost everywhere
    same = float(np.mean(np.sort(probes, 1) == np.sort(cpu, 1)))
    if probes.shape != (IVF_QS[1], WIDEST_NPROBE) or not np.allclose(
            dist(probes), dist(cpu), rtol=1e-5) or same < 0.99:
        raise AssertionError(f"nprobe {WIDEST_NPROBE}: card probe differs from the CPU probe")
    desc = eng.plan(probes)
    qpad = torch.cat([qe, qe[:1].expand(desc.shape[0] * QT - IVF_QS[1], -1)]).contiguous()
    args = (qpad, torch.from_numpy(desc).to(DEVICE), eng._emb, eng._ids)
    kw = dict(k=DENSE_K, metric="ip", block=IVF_BLOCK, sq_norms=eng._sqn, scales=eng._scales)
    err, recall = check_topk(ivf_topk(*args, **kw), ivf_topk_plain(*args, **kw),
                             f"ivf_topk nprobe {WIDEST_NPROBE}")
    max_err = max(max_err, err)
    print(f"  nprobe {WIDEST_NPROBE} (full-row probe): cells {same:.4f} equal to the CPU probe; "
          f"ivf_topk over {int((desc != index.pad_block).sum())} blocks: max abs err {err:.3g}, "
          f"recall@10 {recall}")
    del eng
    results["ivf_topk"]["max_abs_err"] = max_err

    # a depth that is not a multiple of 64 and a block that is not a
    # multiple of 32, with the wide coarse probe: engines on the card
    # against the same engines on the CPU
    regimes = set()
    small = torch.randn((TAIL_IVF_N, TAIL_IVF_D), generator=gen, device=DEVICE)
    tq = (small[:TAIL_Q] + 0.1 * torch.randn((TAIL_Q, TAIL_IVF_D), generator=gen,
                                             device=DEVICE)).cpu().numpy()
    for metric in ("ip", "l2"):
        tix = IVFDenseIndex.build(small.cpu().numpy(), nlist=TAIL_IVF_NLIST, block=TAIL_IVF_BLOCK,
                                  metric=metric, seed=SEED, device=DEVICE)
        for dt in (torch.bfloat16, torch.int8, torch.float32):
            for nprobe in (8, WIDE_NPROBE):
                card = IVFEngine(tix, nprobe=nprobe, device=DEVICE, store_dtype=dt)
                cpu = IVFEngine(tix, nprobe=nprobe, device="cpu", store_dtype=dt)
                ivf_mod.last_plan = None
                assert_same_search(card.search_embeddings(tq, k=DENSE_K),
                                   cpu.search_embeddings(tq, k=DENSE_K),
                                   f"IVF D={TAIL_IVF_D} block {TAIL_IVF_BLOCK} {metric} {dt} "
                                   f"nprobe {nprobe}")
                regimes.add(f"{str(dt)[6:]} {getattr(ivf_mod.last_plan, 'regime', 'plain')}")
    print(f"  IVF engines at D={TAIL_IVF_D}, block {TAIL_IVF_BLOCK}, nlist {TAIL_IVF_NLIST} "
          f"(ip and l2; bf16, int8, f32; nprobe 8 and {min(WIDE_NPROBE, TAIL_IVF_NLIST)}): "
          f"each equal to its CPU engine; regimes {sorted(regimes)}")


def encoder_config():
    from probing_rag_tpu_torch.models.encoder import EncoderConfig

    return EncoderConfig.contriever()


class TimedEncoder:
    """An ``encode_fn`` that sums its wall seconds (synchronised)."""

    def __init__(self, encode):
        self.encode = encode
        self.seconds = 0.0

    def __call__(self, texts):
        sync()
        t0 = time.time()
        out = self.encode(texts)
        self.seconds += time.time() - t0
        return out


def assert_same_search(res, ref, what: str) -> None:
    """An engine's result on the card against the same engine's on the
    CPU: scores allclose, ids equal where the scores are distinct."""
    import numpy as np

    if not np.allclose(res.scores, ref.scores, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{what}: scores differ from the CPU engine")
    gap = np.abs(np.diff(ref.scores, axis=1)) > 1e-3
    distinct = np.ones_like(ref.doc_indices, bool)
    distinct[:, 1:] &= gap
    distinct[:, :-1] &= gap
    bad = int((res.doc_indices[distinct] != ref.doc_indices[distinct]).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} ids differ from the CPU engine where scores are distinct")


def phase_stemming(texts, questions) -> None:
    """The port's Porter stemmer against the committed golden
    (``tests/fixtures/porter_stems.json``, NLTK's stems; NLTK is not needed
    here), in both modes; then a default ``BM25Config()`` index, which
    stems, over the phase-7 text corpus, and one batch of ``questions``
    through it on the card against the same engine on the CPU."""
    from pathlib import Path

    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
    from probing_rag_tpu_torch.retrieval.porter import MODES, PorterStemmer

    golden = json.loads((Path(__file__).resolve().parent / "tests" / "fixtures" /
                         "porter_stems.json").read_text())["stems"]
    for col, mode in enumerate(MODES):
        stemmer = PorterStemmer(mode)
        bad = [(w, v[col], stemmer.stem(w)) for w, v in golden.items() if stemmer.stem(w) != v[col]]
        if bad:
            raise AssertionError(f"Porter stemmer ({mode}) differs from the golden: {bad[:5]}")
    config = BM25Config()
    if not config.stem:
        raise AssertionError("BM25Config() no longer stems")
    t0 = time.time()
    index = BM25Index.build(texts, config)
    build_s = time.time() - t0
    res = BM25Engine(index, device=DEVICE).search(questions, k=K)
    assert_same_topk(res, BM25Engine(index, device="cpu").search(questions, k=K + 1),
                     "stemming index search")
    print(f"  Porter stemmer: {len(golden)} golden words equal in modes {', '.join(MODES)}; "
          f"default BM25Config (stemming) index over {len(texts)} texts: {build_s:.1f}s, "
          f"{index.n_terms} terms; {len(questions)} questions on the card equal to the CPU")


def phase_dense_main_path(docs_tokens, lm) -> dict:
    """``rag-run --dense`` and ``rag-run --dense --dense-ivf`` at Contriever
    and Gemma-2B width through the pipeline API, then the flat loop's first
    and last searches through four engines against the same engines on the
    CPU. Returns the launches of each dense kernel on its own loop: the
    flat loop's ``dense_topk``, the IVF loop's ``ivf_topk``."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.encoder import init_encoder_params, text_encoder
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.retrieval.dense import DenseEngine, DenseIndex
    from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex, IVFEngine

    params, cfg, probers, tok, store = lm
    ecfg = encoder_config()
    eparams = init_encoder_params(ecfg, torch.Generator(device=DEVICE).manual_seed(SEED + 20),
                                  device=DEVICE, dtype=torch.bfloat16)
    encode = TimedEncoder(text_encoder(eparams, ecfg, ByteTokenizer(max(ecfg.vocab_size, 259)),
                                       DEVICE))
    texts = [" ".join(d) for d in docs_tokens]
    sync()
    t0 = time.time()
    index = DenseIndex.build(texts, encode)
    build_s = time.time() - t0
    if index.embeddings.shape != (len(texts), ecfg.d_model) or not np.isfinite(index.embeddings).all():
        raise AssertionError("dense index embeddings are not finite [N, D]")
    print(f"  Contriever-width index of {len(texts)} docs (mean "
          f"{np.mean([len(t) for t in texts]):.0f} bytes, cut to {ecfg.max_positions}): "
          f"{build_s:.1f}s, {len(texts) / build_s:.0f} docs/s")
    t0 = time.time()
    ivf = IVFDenseIndex.build(index.embeddings, metric=index.metric, seed=SEED, device=DEVICE)
    print(f"  IVF over it: nlist {ivf.nlist}, built in {time.time() - t0:.1f}s")

    names = sorted({t for d in docs_tokens[:2000] for t in d})
    rng = np.random.default_rng(SEED + 21)
    questions = ["What links " + " and ".join(rng.choice(names, 3, replace=False)) + "?"
                 for _ in range(N_DENSE_QUESTIONS)]
    rag = RAGConfig(retr_method="probing", threshold=1e6, top_k=K, max_new_tokens=150,
                    batch_size=8)

    def probing_loop(label, engine, path_kernels):
        """One ``rag-run`` probing loop over ``engine``; its own launch
        counts, zeroed just before it and read just after."""
        retriever = TimedRetriever(engine)
        pipe = AdaptiveRAGPipeline(params, cfg, tok, retriever, store, probers, rag)
        encode.seconds = 0.0
        kernels.reset_launches()
        sync()
        t0 = time.time()
        result = pipe.run(questions)
        sync()
        wall = time.time() - t0
        counts = dict(kernels.LAUNCHES)
        print(f"  {label} probing loop over {len(questions)} questions: {wall:.1f}s wall, of "
              f"which search {retriever.seconds:.3f}s ({len(retriever.calls)} calls, "
              f"{sum(map(len, retriever.calls))} queries) including query encoding "
              f"{encode.seconds:.3f}s; retr_count {result.retr_count_list}; kernel launches "
              f"{counts}")
        if result.retr_count_list != [3] * len(questions):
            raise AssertionError(f"{label}: retr_count {result.retr_count_list} != all 3")
        if not all(isinstance(p, str) and p for p in result.pred_list):
            raise AssertionError(f"{label}: empty prediction")
        missing = [n for n in path_kernels if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {label} path: {missing}")
        return counts, retriever.calls

    flat = DenseEngine(index, encode, device=DEVICE)
    flat_counts, calls = probing_loop("dense flat bf16 l2", flat, ("dense_topk",))
    # --dense-ivf: the IVF engine's coarse probe runs dense_topk too
    ivf_counts, _ = probing_loop("dense IVF bf16",
                                 IVFEngine(ivf, encode_fn=encode, device=DEVICE),
                                 ("dense_topk", "ivf_topk"))

    engines = [
        ("flat bf16", flat, DenseEngine(index, device="cpu")),
        ("flat int8 + rerank", DenseEngine(index, device=DEVICE, store_dtype=torch.int8),
         DenseEngine(index, device="cpu", store_dtype=torch.int8)),
        ("IVF bf16", IVFEngine(ivf, device=DEVICE), IVFEngine(ivf, device="cpu")),
        ("IVF int8", IVFEngine(ivf, device=DEVICE, store_dtype=torch.int8),
         IVFEngine(ivf, device="cpu", store_dtype=torch.int8)),
    ]
    for label, queries in (("first", calls[0]), ("last", calls[-1])):
        qemb = encode(queries)
        for name, card, cpu in engines:
            res = card.search_embeddings(qemb, k=K)
            assert_same_search(res, cpu.search_embeddings(qemb, k=K), f"{label} search, {name}")
        print(f"  {label} loop search again ({len(queries)} queries) through "
              f"{', '.join(e[0] for e in engines)}: each equal to its CPU engine")
    phase_stemming(texts, questions)
    return {"dense_topk": flat_counts["dense_topk"], "ivf_topk": ivf_counts["ivf_topk"]}


def mm_operands(gen, m: int, k: int, n: int, transpose_rhs: bool, dt):
    """Seeded operands of matmul_int8: x ~ N(0, 1) in ``dt``, int8 weights
    uniform in [-127, 127], column scales in [0.005, 0.015)."""
    import torch

    x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
    shape = (n, k) if transpose_rhs else (k, n)
    q = torch.randint(-127, 128, shape, generator=gen, device=DEVICE, dtype=torch.int8)
    s = (torch.rand((1, n), generator=gen, device=DEVICE) + 0.5) / 100
    return x, q, s


def mm_check(got, ref, dt, what: str) -> tuple:
    """Holds a matmul_int8 result to its plain version (phase 8's
    tolerance). Returns (max abs err, share of outputs that differ)."""
    import torch

    differ = float((got != ref).float().mean())
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    bf16 = dt == torch.bfloat16
    if not torch.allclose(got, ref, rtol=2**-6 if bf16 else 1e-5, atol=1e-5 * float(ref.abs().max())) \
            or (bf16 and differ > 0.01):
        raise AssertionError(f"matmul_int8 {what}: max abs err {err}, {differ:.4f} of the outputs differ")
    return err, differ


def mm_case(gen, label: str, m: int, k: int, n: int, tr: bool, dt, regime: str,
            yardsticks: bool = False) -> dict:
    """One matmul_int8 case of ``phase_matmul_kernels``: seeded operands,
    the kernel held to its plain version (``mm_check``), the regime the
    planner chose checked against ``regime``, kernel and plain times with
    the bound, and with ``yardsticks`` the library call
    (``torch._weight_int8pack_mm``, where it runs on the card) and cuBLAS on
    bf16 weights. Prints the case's line; returns its numbers."""
    import torch

    from probing_rag_tpu_torch.ops import matmul as mm

    bf16 = torch.bfloat16
    x, q, s = mm_operands(gen, m, k, n, tr, dt)
    mm.last_plan = None
    got = mm.matmul_int8(x, q, s, dt=dt, transpose_rhs=tr)
    plan = mm.last_plan
    ref = mm.matmul_int8_plain(x, q, s, dt=dt, transpose_rhs=tr)
    sync()
    if DEVICE == "cuda" and plan.regime != regime:
        raise AssertionError(f"matmul_int8 {label}: regime {plan.regime}, expected {regime}")
    err, differ = mm_check(got, ref, dt, f"{label} ({plan.regime if plan else 'plain'})")
    del got, ref
    ms = cuda_ms(lambda: mm.matmul_int8(x, q, s, dt=dt, transpose_rhs=tr))
    plain_ms = cuda_ms(lambda: mm.matmul_int8_plain(x, q, s, dt=dt, transpose_rhs=tr))
    b = bound(x.numel() * x.element_size() + q.numel() + n * 4 + m * n * x.element_size(),
              2 * m * n * k, "bf16" if dt == bf16 else "f32")
    how = (f"{plan.regime} (tile {plan.bm} x {plan.bn}, {plan.splits} splits, {plan.grid} "
           f"blocks)") if plan else "plain"
    line = (f"  matmul_int8 {label} [{m} x {k} -> {n}], {how}: max abs err {err:.3g} "
            f"({differ:.4f} of the outputs differ); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
    lib_ms = cublas_ms = None
    if yardsticks:
        # one PyTorch call of the w8a16 function, where it runs on the card
        # ([N, K] weights, bf16 scales); cuBLAS on bf16 weights (a different
        # function: twice the weight bytes)
        qnk = q if tr else q.T.contiguous()
        sb = s.reshape(-1).to(bf16)
        try:
            torch._weight_int8pack_mm(x, qnk, sb)
            sync()
            # at prefill rows a call takes seconds: one timed run after the warm-up
            lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, qnk, sb),
                             reps=1 if m >= 1024 else 5)
            line += f"; torch._weight_int8pack_mm {lib_ms:.4f} ms"
        except (RuntimeError, NotImplementedError) as e:
            line += f"; torch._weight_int8pack_mm: none on this card ({str(e).splitlines()[0][:60]})"
        wb = (q.T if tr else q).to(bf16)
        cublas_ms = cuda_ms(lambda: x @ wb)
        line += f"; cuBLAS bf16-weight matmul {cublas_ms:.4f} ms"
        del qnk, wb
    print(line, flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "cublas_ms": cublas_ms, "regime": plan.regime if plan else None, **b}


def phase_matmul_kernels(results: dict, prefill_m: int) -> None:
    """matmul_int8 against its plain version on the card at every product
    of a Gemma-2B decode step (M = 8, the tied head transposed), at every
    product of the prefill (M = 8 x the padded prompt length), at a ragged
    prefill M (not a multiple of 128) and a transposed [N, K] weight at
    prefill M, at ragged shapes in each regime (wgmma: K past the last
    64-deep step, N not a multiple of the tile or of 8, the 128-wide tile;
    small-M and tail: ragged M, N and K), and in the f32 mode at the tiny
    config's widths. Each case must take the regime listed with it, and
    prints the plan it was launched with (``ops.matmul.last_plan``).
    Tolerance, bf16: the f32 sums run in another order, so a sum may round
    to the neighbouring bf16 value (2^-8 relative) and the scaled product
    rounds once more (up to 2^-7): rtol 2^-6, atol 1e-5 of the largest
    output; and at most 1% of the outputs may differ at all, which holds
    the op order (scaling the f32 sum before rounding it would change many
    more). f32: rtol 1e-5, the same atol. Then the threshold sweep
    (``phase_matmul_threshold``)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"decode {name}", MM_DECODE_M, k, n, False, bf16, "small_m")
             for name, (k, n) in GEMMA_MM.items()]
    cases += [("decode tied head", MM_DECODE_M, *TIED_HEAD, True, bf16, "small_m")]
    cases += [(f"verify {name}", MM_VERIFY_M, k, n, False, bf16, "small_m")
              for name, (k, n) in GEMMA_MM.items()]
    cases += [("verify tied head", MM_VERIFY_M, *TIED_HEAD, True, bf16, "small_m")]
    cases += [(f"prefill {name}", prefill_m, *GEMMA_MM[name], False, bf16, "wgmma")
              for name in GEMMA_MM]
    cases += [("prefill ragged M", prefill_m + 5, *GEMMA_MM["w_gate/w_up"], False, bf16, "wgmma"),
              ("prefill transposed", prefill_m, *GEMMA_MM["w_gate/w_up"], True, bf16, "wgmma")]
    cases += [("ragged K and N, wgmma", 4096, 200, 1008, False, bf16, "wgmma"),
              ("ragged N, transposed, wgmma", 4096, 2048, 1001, True, bf16, "wgmma"),
              ("N 128, wgmma", 4096, 2048, 128, False, bf16, "wgmma"),
              ("ragged M and N", 37, 2048, 1000, False, bf16, "tail"),
              ("ragged M and N, transposed", 37, 2048, 1000, True, bf16, "small_m"),
              ("ragged K", 5, 200, 300, False, bf16, "tail"),
              ("ragged K, transposed", 5, 200, 300, True, bf16, "tail"),
              ("tiny f32 w_gate", 20, 64, 128, False, f32, "f32"),
              ("tiny f32 tied head", 20, 64, 512, True, f32, "f32"),
              ("tiny f32 ragged", 7, 40, 30, False, f32, "f32")]
    max_err = 0.0
    for label, m, k, n, tr, dt, regime in cases:
        r = mm_case(gen, label, m, k, n, tr, dt, regime,
                    yardsticks=label.startswith(("decode", "prefill", "verify")))
        max_err = max(max_err, r["max_abs_err"])
        if label == "decode w_gate/w_up":
            results["matmul_int8"] = {k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}
        if label == "prefill w_gate/w_up":
            prefill = {"prefill_ms": r["ms"], "prefill_bound_ms": r["bound_ms"],
                       "prefill_cublas_bf16_ms": r["cublas_ms"]}
        if label == "verify w_gate/w_up":
            verify = {"verify_ms": r["ms"], "verify_bound_ms": r["bound_ms"],
                      "verify_plain_ms": r["plain_ms"], "verify_library_ms": r["library_ms"],
                      "verify_regime": r["regime"]}
    results["matmul_int8"].update(prefill, **verify, max_abs_err=max_err)
    phase_matmul_threshold(gen)


# the threshold sweep's row counts and products (K, N)
MM_SWEEP_M = (16, 32, 48, 64, 96, 128, 192, 256, 512)
MM_SWEEP_SHAPES = {"wq/wo": GEMMA_MM["wq/wo"], "w_gate/w_up": GEMMA_MM["w_gate/w_up"],
                   "w_down": GEMMA_MM["w_down"]}


def phase_matmul_threshold(gen) -> None:
    """Where the wgmma regime starts (``WGMMA_MIN_M``, ``WGMMA_MIN_TILES``):
    at each M of ``MM_SWEEP_M`` and each product of ``MM_SWEEP_SHAPES``,
    the product run in the small-M regime and in the wgmma regime (the
    thresholds moved for the call), each held to the plain version, with
    their times and the regime the planner picks."""
    import torch

    from probing_rag_tpu_torch.ops import matmul as mm

    bf16 = torch.bfloat16
    keep = mm.WGMMA_MIN_M, mm.WGMMA_MIN_TILES
    try:
        for name, (k, n) in MM_SWEEP_SHAPES.items():
            row = []
            for m in MM_SWEEP_M:
                x, q, s = mm_operands(gen, m, k, n, False, bf16)
                ref = mm.matmul_int8_plain(x, q, s, dt=bf16)
                mm.matmul_int8(x, q, s, dt=bf16)
                picked = mm.last_plan.regime if mm.last_plan else "plain"
                times = {}
                for regime, thresholds in (("small_m", (1 << 40, 0)), ("wgmma", (0, 0))):
                    mm.WGMMA_MIN_M, mm.WGMMA_MIN_TILES = thresholds
                    got = mm.matmul_int8(x, q, s, dt=bf16)
                    sync()
                    if DEVICE == "cuda" and mm.last_plan.regime != regime:
                        raise AssertionError(f"threshold sweep: {mm.last_plan.regime} for {regime}")
                    mm_check(got, ref, bf16, f"threshold sweep {name} M {m} {regime}")
                    times[regime] = cuda_ms(lambda: mm.matmul_int8(x, q, s, dt=bf16), reps=20)
                    mm.WGMMA_MIN_M, mm.WGMMA_MIN_TILES = keep
                row.append(f"M {m} {times['small_m']:.4f} / {times['wgmma']:.4f} ({picked})")
                del x, q, s, ref, got
            print(f"  matmul_int8 threshold sweep {name} [M x {k} -> {n}], ms small-M / wgmma "
                  f"(the planner's pick): {'; '.join(row)}", flush=True)
    finally:
        mm.WGMMA_MIN_M, mm.WGMMA_MIN_TILES = keep


# phase 8's int4 cases: the group of Gemma-2B's and Mistral-7B's int4 trees
# (quantize_lm_params' default: the largest <= 128 dividing every reduction
# dim), Mistral-7B's products as (K, N) and its prefill rows (8 x 1,024)
MM4_GROUP = 128
MISTRAL_MM = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
              "w_down": (14336, 4096)}
MISTRAL_PREFILL_M = 8 * 1024


def mm4_operands(gen, m: int, k: int, n: int, scheme: str, dt, group: int = MM4_GROUP):
    """Seeded operands of matmul_int4: x ~ N(0, 1) in ``dt``, int4 values
    uniform in [-7, 7] packed (``pack_int4``; ``[N, K/2]`` for the channel
    scheme, else ``[K, N/2]``), scales in [0.5, 1.5) (rs) and [0.005, 0.015)
    (s, gs). Returns (x, qp, the scheme's scale keywords)."""
    import torch

    from probing_rag_tpu_torch.ops.attention import pack_int4

    x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
    shape = (n, k) if scheme == "channel" else (k, n)
    qp = pack_int4(torch.randint(-7, 8, shape, generator=gen, device=DEVICE, dtype=torch.int8))
    u = lambda *sh: torch.rand(sh, generator=gen, device=DEVICE)  # noqa: E731
    if scheme == "rank1":
        scales = dict(rs=u(k // group, 1) + 0.5, s=(u(1, n) + 0.5) / 100)
    elif scheme == "grouped":
        scales = dict(gs=(u(k // group, n) + 0.5) / 100)
    else:
        scales = dict(s=(u(n, 1) + 0.5) / 100)
    return x, qp, scales


def mm4_check(got, ref, dt, scheme: str, x, qp, scales: dict, what: str) -> tuple:
    """Holds a matmul_int4 result to its plain version. Rank-1 and channel
    as ``mm_check`` holds matmul_int8 (the same op order, f32 sums in
    another order). Grouped bf16: element by element within
    ``ops/matmul.py::int4_grouped_tolerance`` (a group partial may round to
    its neighbouring bf16 value before it is scaled). f32: rtol 1e-5, atol
    1e-5 of the largest output. Returns (max abs err, share of outputs that
    differ)."""
    import torch

    from probing_rag_tpu_torch.ops.matmul import int4_grouped_tolerance

    if scheme != "grouped" or dt != torch.bfloat16:
        return mm_check(got, ref, dt, what)
    differ = float((got != ref).float().mean())
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    tol = torch.cat([int4_grouped_tolerance(x[i : i + 256], qp, scales["gs"])
                     for i in range(0, x.shape[0], 256)])
    if not bool((diff <= tol).all()):
        raise AssertionError(f"matmul_int4 {what}: max abs err {err}, "
                             f"{int((diff > tol).sum())} outputs past int4_grouped_tolerance")
    return err, differ


def int4pack_ms(x, qp, scheme: str, sc: dict, group: int, ref) -> tuple:
    """``torch._weight_int4pack_mm``'s time on the same product, a
    yardstick the port never calls: the weight as torch's tinygemm layout
    wants it (``[N, K]`` u = q + 8, two to a byte along K, packed by
    ``torch._convert_weight_to_int4pack`` outside the timed call), scales
    and zeros ``[K / G, N, 2]`` bf16 (zero 0: w = (u - 8) scale): grouped's
    gs (G its group), rank-1's rs[g] s[n] (G its group), the channel head's
    s[n] in every group of G = 128. Its scales are rounded to bf16 and it
    sums in its own order, so it is held to the plain result at atol 2^-5 of
    the largest output before it is timed (mean of 5; once after the
    warm-up from 1,024 rows, where a call takes milliseconds to seconds).
    Returns (ms or None, what the line says)."""
    import torch

    from probing_rag_tpu_torch.ops.attention import unpack_int4

    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "torch._weight_int4pack_mm: none in this torch"
    m, k = x.shape
    if scheme == "grouped":
        scale = sc["gs"]
    elif scheme == "rank1":
        scale = sc["rs"].reshape(-1, 1) * sc["s"].reshape(1, -1)
    else:
        group = 128
        if k % group:
            return None, f"torch._weight_int4pack_mm: none (K {k} holds no whole 128-groups)"
        scale = sc["s"].reshape(1, -1).expand(k // group, -1)
    q = unpack_int4(qp)
    u = ((q if scheme == "channel" else q.T).contiguous() + 8).to(torch.uint8)  # [N, K]
    del q
    sz = torch.stack([scale.to(torch.bfloat16), torch.zeros_like(scale, dtype=torch.bfloat16)],
                     -1).contiguous()
    why = "no packing of this torch matched"
    for hi_first in (True, False):
        packed = ((u[:, ::2] << 4) | u[:, 1::2]) if hi_first else (u[:, ::2] | (u[:, 1::2] << 4))
        try:
            w = torch._convert_weight_to_int4pack(packed.contiguous(), 8)
            got = torch._weight_int4pack_mm(x, w, group, sz)
            sync()
        except (RuntimeError, TypeError, NotImplementedError) as e:
            why = str(e).splitlines()[0][:80]
            continue
        scale_out = float(ref.float().abs().max())
        if torch.allclose(got.float(), ref.float(), rtol=0, atol=2**-5 * scale_out):
            ms = cuda_ms(lambda: torch._weight_int4pack_mm(x, w, group, sz),
                         reps=1 if m >= 1024 else 5)
            return ms, f"torch._weight_int4pack_mm {ms:.4f} ms"
        why = "its result differs from the plain version's"
    return None, f"torch._weight_int4pack_mm: none ({why})"


def mm4_case(gen, label: str, m: int, k: int, n: int, scheme: str, dt, regime: str,
             group: int = MM4_GROUP, yardstick: bool = False) -> dict:
    """One matmul_int4 case of ``phase_matmul_int4_kernels``: seeded
    operands, the kernel held to its plain version (``mm4_check``), the
    regime the planner chose checked against ``regime``, kernel and plain
    times with the bound (the packed weight, its scales, x and the output
    each moved once), with ``yardstick`` the library call, and for grouped
    from 1,024 rows the dequantized copy and ``torch.matmul`` that ``_mm``
    runs past ``_INT4_DEQUANT_ROWS`` rows. Prints the case's line; returns
    its numbers."""
    import torch

    from probing_rag_tpu_torch.ops import matmul as mm
    from probing_rag_tpu_torch.ops.attention import unpack_int4

    x, qp, sc = mm4_operands(gen, m, k, n, scheme, dt, group)
    tr = scheme == "channel"
    leaf = {"qp": qp, **sc}
    call = lambda: mm.matmul_int4(x, leaf, dt=dt, scheme=scheme, transpose_rhs=tr)  # noqa: E731
    mm.last_plan = None
    got = call()
    plan = mm.last_plan
    ref = mm.matmul_int4_plain(x, qp, dt=dt, scheme=scheme, transpose_rhs=tr, **sc)
    sync()
    if DEVICE == "cuda" and plan.regime != regime:
        raise AssertionError(f"matmul_int4 {label}: regime {plan.regime}, expected {regime}")
    err, differ = mm4_check(got, ref, dt, scheme, x, qp, sc,
                            f"{label} ({plan.regime if plan else 'plain'})")
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: mm.matmul_int4_plain(x, qp, dt=dt, scheme=scheme,
                                                    transpose_rhs=tr, **sc))
    nbytes = (x.numel() * x.element_size() + qp.numel() + sum(v.numel() * 4 for v in sc.values())
              + m * n * x.element_size())
    b = bound(nbytes, 2 * m * n * k, "bf16" if dt == torch.bfloat16 else "f32")
    how = mm4_plan_text(plan)
    line = (f"  matmul_int4 {label} [{m} x {k} -> {n}] {scheme}"
            f"{f' group {group}' if scheme != 'channel' else ''}, {how}: max abs err {err:.3g} "
            f"({differ:.4f} of the outputs differ); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    lib_ms = dequant_ms = None
    if yardstick:
        lib_ms, said = int4pack_ms(x, qp, scheme, sc, group, ref)
        line += f"; {said}"
    if scheme == "grouped" and m >= 1024:
        kg = sc["gs"].shape[0]

        def dequantized():
            w = unpack_int4(qp).reshape(kg, k // kg, n).to(dt) * sc["gs"][:, None, :].to(dt)
            return x @ w.reshape(k, n)

        dequant_ms = cuda_ms(dequantized)
        line += f"; dequantized copy + torch.matmul {dequant_ms:.4f} ms"
    print(line, flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "dequant_ms": dequant_ms, "regime": plan.regime if plan else None, **b}


def mm4_plan_text(plan) -> str:
    """A matmul_int4 plan as phase 8 prints it: the regime, the row tile and
    the column tile, and then the stream regime's persistent blocks, units a
    block (the most), ring stages, x window steps and the clusters that
    finish split tiles (else the scratch, where tiles split), or the other
    regimes' depth, K splits and blocks."""
    if plan is None:
        return "plain"
    if plan.regime == "stream":
        from probing_rag_tpu_torch.ops.matmul import stream_scratch_fixup

        finish = (f", clusters of {plan.splits}" if plan.splits > 1
                  else ", split tiles through the scratch" if stream_scratch_fixup(plan) else "")
        return (f"stream (row tile {plan.bm}, units of {plan.bn} columns x {plan.bk} deep, "
                f"{plan.grid} blocks of up to {-(-plan.units // plan.grid)} units, ring of "
                f"{plan.stages}, x window of {plan.xsteps} steps{finish})")
    return (f"{plan.regime} (tile {plan.bm} x {plan.bn}, {plan.bk} deep, {plan.splits} splits, "
            f"{plan.grid} blocks)")


def mm4_shared_case(gen, label: str, m: int, k: int, ns, scheme: str) -> dict:
    """One ``matmul_int4`` case of several weights, those of ``ns``, that
    share x in one launch (the regime the planner gives it), each output
    held to its plain version
    (``mm4_check``); kernel and plain times and the bound of all of them."""
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.ops import matmul as mm

    bf16 = torch.bfloat16
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(bf16)
    ws = []
    for n in ns:
        _, qp, sc = mm4_operands(gen, m, k, n, scheme, bf16)
        ws.append({"qp": qp, **sc})
    mm.last_plan = None
    before = kernels.LAUNCHES["matmul_int4"]
    got = mm.matmul_int4(x, ws, dt=bf16, scheme=scheme)
    plan = mm.last_plan
    launched = kernels.LAUNCHES["matmul_int4"] - before
    refs = [mm.matmul_int4_plain(x, w["qp"], dt=bf16, scheme=scheme,
                                 **{key: v for key, v in w.items() if key != "qp"}) for w in ws]
    sync()
    # at 8 rows grouped wq + wk + wv keeps the small-M kernel (ops/matmul.py)
    want = "small_m" if m == 8 and scheme == "grouped" and len(ns) == 3 else "stream"
    if DEVICE == "cuda" and (plan.regime != want or launched != 1):
        raise AssertionError(f"matmul_int4 {label}: regime {plan.regime}, {launched} launches")
    err = 0.0
    for g_, r_, w in zip(got, refs, ws):
        e, _ = mm4_check(g_, r_, bf16, scheme, x, w["qp"], w, f"{label} (shared launch)")
        err = max(err, e)
    ms = cuda_ms(lambda: mm.matmul_int4(x, ws, dt=bf16, scheme=scheme))
    plain_ms = cuda_ms(lambda: [mm.matmul_int4_plain(x, w["qp"], dt=bf16, scheme=scheme, **{
        key: v for key, v in w.items() if key != "qp"}) for w in ws])
    nbytes = x.numel() * 2 + sum(t.numel() * t.element_size() for w in ws for t in w.values()) \
        + m * sum(ns) * 2
    b = bound(nbytes, 2 * m * sum(ns) * k, "bf16")
    how = mm4_plan_text(plan)
    print(f"  matmul_int4 shared {label} [{m} x {k} -> {' + '.join(map(str, ns))}] {scheme}, one "
          f"launch, {how}: max abs err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}


def phase_matmul_int4_kernels(results: dict, prefill_m: int) -> None:
    """matmul_int4 against its plain version on the card: every product of
    a Gemma-2B decode step (M = 8) and verify round (M = 40) in both
    schemes (group 128) and the tied head of an int4 embedding; rank-1 at
    every prefill product (M = 8 x the padded prompt length), at the
    capture forward's M (8 x 1,536) and at a ragged prefill M; grouped at
    its largest kernel M (1,024 rows: wgmma, or small-M for wk/wv's 16
    tiles), at 512 and at a ragged 100 rows; 64 rows in the stream regime
    (its widest row tile); Mistral-7B's widths at decode (both
    schemes) and its rank-1 prefill; ragged M, N and K in each regime; a
    group of 64; f32 at the tiny configs' widths. Each case must take the
    regime listed with it, prints the plan it launched
    (``ops.matmul.last_plan``), its bound, plain time and
    ``torch._weight_int4pack_mm`` (``int4pack_ms``, where it runs) at every
    bf16 shape but the ragged ones, past 1,024 rows only at the w_gate/w_up
    prefill and capture (a call takes up to seconds there); grouped at
    1,024 rows also the dequantized copy's route. Tolerances:
    ``mm4_check``."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    # one weight a launch: every product at decode; at verify the two the
    # shared launches below leave alone (wo, w_down)
    for m, at, names in ((MM_DECODE_M, "decode", GEMMA_MM), (MM_VERIFY_M, "verify",
                                                             ("wq/wo", "w_down"))):
        # at 8 rows wo, wk and wv alone keep the small-M kernel (the
        # stream regime's one-unit shares would wait on the scratch there:
        # ops/matmul.py)
        cases += [(f"{at} {name}", m, *GEMMA_MM[name], scheme, bf16,
                   "small_m" if at == "decode" and name in ("wq/wo", "wk/wv") else "stream",
                   MM4_GROUP)
                  for name in names for scheme in ("rank1", "grouped")]
        cases += [(f"{at} int4 tied head", m, *TIED_HEAD, "channel", bf16, "small_m", 0)]
    cases += [(f"prefill {name}", prefill_m, *GEMMA_MM[name], "rank1", bf16, "wgmma", MM4_GROUP)
              for name in GEMMA_MM]
    cases += [("capture w_gate/w_up", 8 * TRAIN_MAX_LEN, *GEMMA_MM["w_gate/w_up"], "rank1", bf16,
               "wgmma", MM4_GROUP),
              ("capture w_down", 8 * TRAIN_MAX_LEN, *GEMMA_MM["w_down"], "rank1", bf16, "wgmma",
               MM4_GROUP),
              ("prefill ragged M", prefill_m + 5, *GEMMA_MM["w_gate/w_up"], "rank1", bf16, "wgmma",
               MM4_GROUP),
              ("grouped 1024 rows w_gate/w_up", 1024, *GEMMA_MM["w_gate/w_up"], "grouped", bf16,
               "wgmma", MM4_GROUP),
              ("grouped 1024 rows w_down", 1024, *GEMMA_MM["w_down"], "grouped", bf16, "wgmma",
               MM4_GROUP),
              ("grouped 1024 rows wk/wv", 1024, *GEMMA_MM["wk/wv"], "grouped", bf16, "small_m",
               MM4_GROUP),
              ("grouped 512 rows wq/wo", 512, *GEMMA_MM["wq/wo"], "grouped", bf16, "wgmma",
               MM4_GROUP),
              ("grouped ragged 100 rows w_gate/w_up", 100, *GEMMA_MM["w_gate/w_up"], "grouped",
               bf16, "wgmma", MM4_GROUP),
              ("64 rows w_down", 64, *GEMMA_MM["w_down"], "grouped", bf16, "stream", MM4_GROUP),
              ("64 rows w_gate/w_up", 64, *GEMMA_MM["w_gate/w_up"], "rank1", bf16, "stream",
               MM4_GROUP)]
    cases += [(f"Mistral-7B decode {name}", MM_DECODE_M, *MISTRAL_MM[name], scheme, bf16,
               "stream", MM4_GROUP)
              for name in ("w_gate/w_up", "w_down") for scheme in ("rank1", "grouped")]
    cases += [("Mistral-7B prefill w_gate/w_up", MISTRAL_PREFILL_M, *MISTRAL_MM["w_gate/w_up"],
               "rank1", bf16, "wgmma", MM4_GROUP),
              ("ragged K and N, wgmma", 4096, 208, 1056, "rank1", bf16, "wgmma", 16),
              ("ragged M and N", 37, 2048, 1000, "rank1", bf16, "tail", MM4_GROUP),
              ("ragged M and N, grouped", 37, 2048, 1000, "grouped", bf16, "tail", MM4_GROUP),
              ("ragged M and N, tied head", 37, 2048, 1000, "channel", bf16, "small_m", 0),
              ("ragged K", 5, 208, 320, "rank1", bf16, "stream", 16),
              ("ragged K, grouped", 5, 208, 320, "grouped", bf16, "small_m", 16),
              ("ragged K, tied head", 5, 200, 300, "channel", bf16, "tail", 0),
              ("decode group 64 w_gate/w_up", MM_DECODE_M, *GEMMA_MM["w_gate/w_up"], "grouped",
               bf16, "small_m", 64),
              ("tiny f32 rank-1 w_gate", 20, 64, 128, "rank1", f32, "f32", 64),
              ("tiny f32 grouped w_gate", 20, 64, 128, "grouped", f32, "f32", 64),
              ("tiny f32 tied head", 20, 64, 512, "channel", f32, "f32", 0),
              ("tiny f32 ragged", 7, 48, 30, "rank1", f32, "f32", 16)]
    max_err, extra = 0.0, {}
    for label, m, k, n, scheme, dt, regime, group in cases:
        lib = dt == bf16 and "ragged" not in label and (
            m <= 1024 or label in ("prefill w_gate/w_up", "capture w_gate/w_up"))
        r = mm4_case(gen, label, m, k, n, scheme, dt, regime, group, yardstick=lib)
        max_err = max(max_err, r["max_abs_err"])
        key = f"{label} {scheme}"
        if key == "decode w_gate/w_up grouped":
            results["matmul_int4"] = {k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}
        for want, name in (("decode w_gate/w_up rank1", "rank1_decode"),
                           ("verify w_down grouped", "grouped_verify_down"),
                           ("verify w_down rank1", "rank1_verify_down"),
                           ("decode int4 tied head channel", "tied_head"),
                           ("prefill w_gate/w_up rank1", "rank1_prefill"),
                           ("capture w_gate/w_up rank1", "rank1_capture"),
                           ("grouped 1024 rows w_gate/w_up grouped", "grouped_1024")):
            if key == want:
                extra.update({f"{name}_ms": r["ms"], f"{name}_plain_ms": r["plain_ms"],
                              f"{name}_bound_ms": r["bound_ms"]})
                for what in ("library_ms", "dequant_ms"):
                    if r[what] is not None:
                        extra[f"{name}_{what}"] = r[what]
    # a layer's products that share an input, one launch each group
    q, kv = GEMMA_MM["wq/wo"][1], GEMMA_MM["wk/wv"][1]
    for m, at in ((MM_DECODE_M, "decode"), (MM_VERIFY_M, "verify")):
        for scheme in ("rank1", "grouped"):
            for name, k, ns in (("wq + wk + wv", GEMMA_MM["wq/wo"][0], (q, kv, kv)),
                                ("w_gate + w_up", GEMMA_MM["w_gate/w_up"][0],
                                 (GEMMA_MM["w_gate/w_up"][1],) * 2)):
                r = mm4_shared_case(gen, f"{at} {name}", m, k, ns, scheme)
                max_err = max(max_err, r["max_abs_err"])
                extra[f"{scheme}_{at}_{'qkv' if 'wq' in name else 'gate_up'}_ms"] = r["ms"]
    results["matmul_int4"].update(extra, max_abs_err=max_err)


class NoWeightUnpack:
    """While open, ``models/gemma.py``'s ``unpack_int4`` raises on a CUDA
    tensor, except inside a product of a grouped int4 weight past
    ``_INT4_DEQUANT_ROWS`` activation rows (JAX's rule: a transient
    dequantized copy there). Any other int4 product that unpacked its
    weight on the card (or an int4 embedding's lookup, which these runs do
    not have) fails the phase."""

    def __enter__(self):
        import math

        from probing_rag_tpu_torch.models import gemma

        self.saved = gemma.unpack_int4, gemma._mm
        self.allowed = False
        unpack, mm = self.saved

        def guarded_unpack(qp):
            if qp.is_cuda and not self.allowed:
                raise AssertionError(f"unpack_int4 of a {tuple(qp.shape)} int4 weight on the card")
            return unpack(qp)

        def guarded_mm(x, w, dt, *args, **kw):
            keep = self.allowed
            self.allowed = (isinstance(w, dict) and "gs" in w
                            and math.prod(x.shape[:-1]) > gemma._INT4_DEQUANT_ROWS)
            try:
                return mm(x, w, dt, *args, **kw)
            finally:
                self.allowed = keep

        gemma.unpack_int4, gemma._mm = guarded_unpack, guarded_mm
        return self

    def __exit__(self, *exc):
        from probing_rag_tpu_torch.models import gemma

        gemma.unpack_int4, gemma._mm = self.saved
        return False


def phase_int4_mode(label: str, p, cfg, tok, prompts, stops, loop) -> None:
    """After an int4 serving mode's generate calls: its captured decode
    step launches matmul_int4 four times a layer (the products that share
    an input in one launch each: wq + wk + wv, wo, w_gate + w_up, w_down)
    and matmul_int8 once (the tied int8 head), which a ``torch.profiler``
    of one replay confirms by counting the kernel's launches; the same step
    captured anew with one launch a weight (``MAX_SHARED`` 1: 7 a layer),
    its replay's device ms beside the shared step's; then, with
    ``NoWeightUnpack`` open, a speculative generate (verify rounds of 8 x
    (SPEC_K + 1) rows, captured) and one capture forward (8 x
    ``TRAIN_MAX_LEN`` tokens, prober training's), each launching
    matmul_int4, with their seconds."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import generate
    from probing_rag_tpu_torch.models.gemma import _INT4_DEQUANT_ROWS
    from probing_rag_tpu_torch.models.graphs import GRAPHS
    from probing_rag_tpu_torch.models.speculative import SpecConfig
    from probing_rag_tpu_torch.ops import matmul as mm
    from probing_rag_tpu_torch.prober.train import capture_activations

    per_step = loop.graph.launches
    # a layer's int4 products in four launches: wq + wk + wv, wo, w_gate +
    # w_up, w_down
    want = {"matmul_int4": 4 * cfg.n_layers, "matmul_int8": 1}
    if DEVICE == "cuda" and {n: per_step.get(n, 0) for n in want} != want:
        raise AssertionError(f"{label}: a captured step launches {per_step}, expected {want}")
    with torch.inference_mode():
        loop.state.step.zero_()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop.graph.graph.replay()
            sync()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    seen = sum(e.count for e in events if "mm4_" in e.key)
    if events and seen != want["matmul_int4"]:
        raise AssertionError(f"{label}: the profiler saw {seen} matmul_int4 kernels in a replay")
    print(f"  {label}: a captured step launches {per_step}; the profiler "
          f"{f'sees {seen} matmul_int4 kernels' if events else 'saw no device time'} in one "
          f"replay: {step_profile(loop, reps=5, top=8, focus=('mm4_', 'matmul_int8'))}",
          flush=True)
    shared_ms = replay_ms(loop)
    keep, mm.MAX_SHARED = mm.MAX_SHARED, 1
    try:
        GRAPHS.clear()
        with LastLoop() as solo:
            generate(p, cfg, tok, prompts, max_new_tokens=150, stop_tables=stops, kv_int4=True)
        solo_ms = replay_ms(solo.loop)
        solo_launches = solo.loop.graph.launches.get("matmul_int4", 0)
    finally:
        mm.MAX_SHARED = keep
        GRAPHS.clear()
    if DEVICE == "cuda" and solo_launches != 7 * cfg.n_layers:
        raise AssertionError(f"{label}: one launch a weight made {solo_launches} launches a step")
    print(f"  {label}: a replayed step {shared_ms:.3f} device ms with the shared launches "
          f"({want['matmul_int4']} matmul_int4 launches), {solo_ms:.3f} with one launch a weight "
          f"({solo_launches}), captured anew in this call", flush=True)
    kernels.reset_launches()
    with NoWeightUnpack():
        sync()
        t0 = time.time()
        _, res = generate(p, cfg, tok, prompts, max_new_tokens=24, stop_tables=stops,
                          kv_int4=True, spec=SpecConfig(k=SPEC_K))
        sync()
        t_spec = time.time() - t0
        spec_launches = kernels.LAUNCHES["matmul_int4"]
        rng = np.random.default_rng(SEED + 19)
        toks = rng.integers(3, cfg.vocab_size, size=(8, TRAIN_MAX_LEN))
        toks[:, : TRAIN_MAX_LEN // 4] = tok.pad_id  # left pads, as a padded batch has
        sites = [(layer, "resid_post") for layer in cfg.probe_layers]
        capture_activations(p, cfg, toks, sites, tok.pad_id)
        sync()
        t0 = time.time()
        caps = capture_activations(p, cfg, toks, sites, tok.pad_id)
        sync()
        t_cap = time.time() - t0
    if int(res.n_generated.sum()) == 0 or not np.isfinite(res.pooled_captures).all():
        raise AssertionError(f"{label}: speculative decode produced no finite tokens")
    if not bool(torch.isfinite(caps).all()):
        raise AssertionError(f"{label}: the capture forward's activations are not finite")
    cap_launches = kernels.LAUNCHES["matmul_int4"] - spec_launches
    if DEVICE == "cuda" and (spec_launches == 0 or ("rank-1" in label and cap_launches == 0)):
        raise AssertionError(f"{label}: matmul_int4 launched {spec_launches} times by the "
                             f"speculative generate, {cap_launches} by the capture forwards")
    print(f"  {label}: speculative generate (k {SPEC_K}, 24 tokens) {t_spec:.3f}s, matmul_int4 "
          f"launched {spec_launches} times; capture forward (8 x {TRAIN_MAX_LEN}) {t_cap:.3f}s, "
          f"matmul_int4 launched {cap_launches} times by two; no int4 weight unpacked on the "
          f"card outside grouped products past {_INT4_DEQUANT_ROWS} rows", flush=True)


class GcTimes:
    """Seconds the host spent in Python's garbage collections while open,
    and the number of full (generation 2) collections (``gc.callbacks``)."""

    def __enter__(self):
        import gc

        self.seconds, self.full, self.t0 = 0.0, 0, 0.0

        def tick(phase, info):
            if phase == "start":
                self.t0 = time.perf_counter()
            else:
                self.seconds += time.perf_counter() - self.t0
                self.full += info["generation"] == 2

        self.tick = tick
        gc.callbacks.append(tick)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self.tick)
        return False


class GenerateTimes:
    """Times each generate call's prefill and decode loop (``models/
    decode.py``'s ``_prefill_impl`` and ``_decode_loop_impl``, wrapped
    with a sync on each side while the context is open): a loop's seconds
    read as the sum of its rounds. ``rounds``: (prefill rows x length,
    prefill s, tokens generated by the longest row, decode s)."""

    def __enter__(self):
        from probing_rag_tpu_torch.models import decode

        self.rounds, self.saved = [], (decode._prefill_impl, decode._decode_loop_impl)
        prefill, loop = self.saved

        def timed_prefill(params, tokens, *args, **kw):
            sync()
            t0 = time.time()
            out = prefill(params, tokens, *args, **kw)
            sync()
            self.rounds.append([tuple(tokens.shape), time.time() - t0])
            return out

        def timed_loop(*args, **kw):
            t0 = time.time()
            out = loop(*args, **kw)
            sync()
            self.rounds[-1] += [int(out[4].max()), time.time() - t0]
            return out

        decode._prefill_impl, decode._decode_loop_impl = timed_prefill, timed_loop
        return self

    def __exit__(self, *exc):
        from probing_rag_tpu_torch.models import decode

        decode._prefill_impl, decode._decode_loop_impl = self.saved
        return False

    def line(self) -> str:
        return "; ".join(f"{b} x {t}: prefill {p:.3f}s, {n} tokens {d:.3f}s"
                         for (b, t), p, n, d in self.rounds)


def phase_quant_reference() -> dict:
    """Quantized tiny f32 forwards on the card against the same forwards on
    the CPU (shared parameters, quantized on each device; prefill of 6
    tokens into the cache, then 4 single-token steps). The quantized trees
    must be equal (ints) and allclose at 1e-6 (scales). Logits: with int8
    or rank-1 int4 weights over an f32 cache, allclose at 1e-4 (f32, TF32
    off, sums in another order). Where activations or the cache are
    quantized on the fly (w8a8 at every row count, act_int8_rows 1: 24
    rows at prefill, 4 per step; int8 or int4 KV), values that differ in
    their last f32 bits may round to neighbouring steps, so the logits are
    held within 1% (int8) or 5% (int4) of the largest logit. Returns the max abs logit
    difference of each case."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch.models.gemma import (
        GemmaConfig, forward, init_kv_cache, init_params, quantize_lm_params,
    )

    cfg = dataclasses.replace(GemmaConfig.tiny(), compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 10), generator=torch.Generator().manual_seed(2))
    to_card = lambda tree: {k: to_card(v) if isinstance(v, dict) else v.to(DEVICE)  # noqa: E731
                            for k, v in tree.items()}

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    def incremental(p, c, kv_dtype, dev):
        kv = init_kv_cache(c, tokens.shape[0], tokens.shape[1], kv_dtype, device=dev)
        toks = tokens.to(dev)
        logits, kv, _ = forward(p, toks[:, :6], c, kv_cache=kv)
        outs = [logits]
        for i in range(6, tokens.shape[1]):
            step, kv, _ = forward(p, toks[:, i : i + 1], c, kv_cache=kv)
            outs.append(step)
        return torch.cat(outs, dim=1).cpu()

    errs = {}
    f32 = torch.float32
    for label, quant, kv_dtype, act8, rel in (
        ("int8", dict(bits=8), f32, 0, None),
        ("rank-1 int4", dict(bits=4, int4_scheme="rank1"), f32, 0, None),
        ("int8 + int8 KV", dict(bits=8), torch.int8, 0, 0.01),
        ("int8 + w8a8 + int8 KV", dict(bits=8), torch.int8, 1, 0.01),
        ("rank-1 int4 + int4 KV", dict(bits=4, int4_scheme="rank1"), "int4", 0, 0.05),
    ):
        c = dataclasses.replace(cfg, act_int8_rows=act8)
        qcpu = quantize_lm_params(params, **quant)
        qcard = quantize_lm_params(to_card(params), **quant)
        for (name, a), (_, b) in zip(leaves(qcpu), leaves(qcard)):
            b = b.cpu()
            same = torch.equal(a, b) if not a.is_floating_point() else torch.allclose(
                a, b, rtol=1e-6, atol=0)
            if not same:
                raise AssertionError(f"{label}: {name} quantized on the card differs from the CPU")
        ref = incremental(qcpu, c, kv_dtype, "cpu")
        got = incremental(qcard, c, kv_dtype, DEVICE)
        errs[label] = float((got - ref).abs().max())
        tol = dict(rtol=1e-4, atol=1e-4) if rel is None else dict(
            rtol=0.0, atol=rel * float(ref.abs().max()))
        if not torch.allclose(got, ref, **tol):
            raise AssertionError(f"tiny {label} forward on the card differs from the CPU: "
                                 f"{errs[label]}")
    return errs


def gib(nbytes: float) -> float:
    return nbytes / 2**30


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def phase_quantized(lm, index, questions, results: dict) -> dict:
    """``rag-run --quantize int8 --kv-int8`` at Gemma-2B width: phase 5's
    bf16 parameters quantized on the card, the kernel against its plain
    version at the shapes this path gives it, the quantized tiny forwards
    against the CPU, the probing loop over the phase-4 BM25 index with its
    own launch counts, then prefill seconds and decode tokens/s at batch 8
    for four serving modes. Returns the loop's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import StopTables, _pad_batch, generate
    from probing_rag_tpu_torch.models.gemma import quantize_lm_params
    from probing_rag_tpu_torch.models.graphs import CAPTURES, GRAPHS
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    params, cfg, probers, tok, store = lm

    sync()
    t0 = time.time()
    q8 = quantize_lm_params(params, bits=8)
    sync()
    print(f"  quantize_lm_params(bits=8) on the card: {time.time() - t0:.1f}s; int8 tree "
          f"{gib(tree_bytes(q8)):.2f} GiB (bf16 {gib(tree_bytes(params)):.2f} GiB)")

    engine = BM25Engine(index, device=DEVICE)
    retriever = TimedRetriever(engine)
    questions = questions[:N_QUANT_QUESTIONS]
    rag = RAGConfig(retr_method="probing", threshold=1e6, top_k=K, max_new_tokens=150,
                    batch_size=8, kv_int8=True)
    pipe = AdaptiveRAGPipeline(q8, cfg, tok, retriever, store, probers, rag)
    prompts8 = pipe.retrieval_prompts(questions, questions)
    padded_len = _pad_batch([tok.encode(p, add_bos=True) for p in prompts8], tok.pad_id)[0].shape[1]
    phase_matmul_kernels(results, 8 * padded_len)
    torch.cuda.empty_cache()
    phase_matmul_int4_kernels(results, 8 * padded_len)
    torch.cuda.empty_cache()

    for label, err in phase_quant_reference().items():
        print(f"  tiny f32 {label}, card vs CPU: max abs logit diff {err:.3g}")

    retriever.seconds, retriever.calls = 0.0, []
    kernels.reset_launches()
    sync()
    t0 = time.time()
    with GenerateTimes() as rounds:
        result = pipe.run(questions)
    sync()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"  int8 + int8 KV probing loop over {len(questions)} questions: {wall:.1f}s wall, of "
          f"which BM25 search {retriever.seconds:.3f}s ({len(retriever.calls)} calls); "
          f"retr_count {result.retr_count_list}; kernel launches {launches}")
    print(f"  its generate calls: {rounds.line()}", flush=True)
    if result.retr_count_list != [3] * len(questions):
        raise AssertionError(f"quantized loop: retr_count {result.retr_count_list} != all 3")
    if not all(isinstance(p, str) and p for p in result.pred_list):
        raise AssertionError("quantized loop: empty prediction")
    for s in result.gate_scores:
        if s is None or not np.isfinite(s).all():
            raise AssertionError(f"quantized loop: gate scores {s} are not finite")
    missing = [n for n in QUANT_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the quantized path: {missing}")

    # rag-run --quantize int4 --kv-int4 (grouped: the CLI's default scheme),
    # the same loop with its own launch counts
    q4 = quantize_lm_params(params, bits=4)
    pipe4 = AdaptiveRAGPipeline(q4, cfg, tok, retriever, store, probers,
                                dataclasses.replace(rag, kv_int8=False, kv_int4=True))
    GRAPHS.clear()
    retriever.seconds, retriever.calls = 0.0, []
    kernels.reset_launches()
    sync()
    t0 = time.time()
    with GenerateTimes() as rounds:
        result = pipe4.run(questions)
    sync()
    wall = time.time() - t0
    launches4 = dict(kernels.LAUNCHES)
    print(f"  grouped int4 + int4 KV probing loop over {len(questions)} questions: {wall:.1f}s "
          f"wall, of which BM25 search {retriever.seconds:.3f}s ({len(retriever.calls)} calls); "
          f"retr_count {result.retr_count_list}; kernel launches {nonzero(launches4)}")
    print(f"  its generate calls: {rounds.line()}", flush=True)
    if result.retr_count_list != [3] * len(questions):
        raise AssertionError(f"int4 loop: retr_count {result.retr_count_list} != all 3")
    if not all(isinstance(p, str) and p for p in result.pred_list):
        raise AssertionError("int4 loop: empty prediction")
    missing = [n for n in INT4_KERNELS if launches4[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the int4 path: {missing}")
    launches["matmul_int4"] = launches4["matmul_int4"]
    del pipe4
    GRAPHS.clear()

    # prefill seconds and decode tokens/s at batch 8, stops off so that all
    # 150 tokens are generated; peak memory of each mode
    stops = StopTables.disabled(cfg.vocab_size)
    a8 = dataclasses.replace(cfg, act_int8_rows=512)
    modes = [("bf16", lambda: params, cfg, {}),
             ("int8 + int8 KV", lambda: q8, cfg, dict(kv_int8=True)),
             ("int8 + act_int8_rows 512 + int8 KV", lambda: q8, a8, dict(kv_int8=True)),
             ("rank-1 int4 + int4 KV", lambda: quantize_lm_params(params, bits=4, int4_scheme="rank1"),
              cfg, dict(kv_int4=True)),
             ("grouped int4 + int4 KV", lambda: q4, cfg, dict(kv_int4=True))]
    for label, make, c, kv in modes:
        p = make()
        int4 = "int4" in label.split(" + ")[0]
        sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def timed(n, eager=False):
            sync()
            t = time.time()
            _, res = generate(p, c, tok, prompts8, max_new_tokens=n, stop_tables=stops,
                              eager=eager, **kv)
            sync()
            return time.time() - t, res

        # no int4 weight is unpacked on the card by a decode step (the first
        # graphed call captures it) or by rank-1's prefill; grouped prefill
        # rows are past _INT4_DEQUANT_ROWS, where JAX dequantizes too
        guard = NoWeightUnpack() if int4 else contextlib.nullcontext()
        with guard:
            timed(1)
            t1, _ = timed(1)
            with LastLoop() as last:
                timed(150)  # the first graphed call captures the step
        # GRAPHED_CALLS graphed calls, each split into its prefill, its
        # decode loop, the host's garbage collections and the captures it
        # made; the device's time for the 149 steps from one replay
        calls = []
        for _ in range(GRAPHED_CALLS):
            captures = CAPTURES["count"]
            with GenerateTimes() as split, GcTimes() as gc_t:
                t, res = timed(150)
            (_, pre, _, dec), = split.rounds
            calls.append((t, pre, dec, gc_t.seconds, gc_t.full, CAPTURES["count"] - captures))
        step_ms = replay_ms(last.loop)
        t150 = statistics.median(c[0] for c in calls)
        dec150 = statistics.median(c[2] for c in calls)
        t_eager, res_eager = timed(EAGER_TOKENS, eager=True)
        for r, n in ((res, 150), (res_eager, EAGER_TOKENS)):
            if int(r.n_generated.sum()) != 8 * n or not np.isfinite(r.pooled_captures).all():
                raise AssertionError(f"{label}: decode did not produce {n} finite steps per row")
        each = "; ".join(f"{t:.3f}s = prefill {pre:.3f} + decode loop {dec:.3f} + {t - pre - dec:.3f} "
                         f"(gc {g:.3f}s, {full} full; {cap} captures)"
                         for t, pre, dec, g, full, cap in calls)
        # tokens/s from the decode loops' own seconds; the 150-token call
        # less the 1-token call also charges the decode a slower prefill
        print(f"  {label}: prefill {t1:.3f}s (8 x {padded_len} tokens), 150 tokens {t150:.3f}s "
              f"graphed (median of {GRAPHED_CALLS}; decode loop {dec150:.3f}s) -> "
              f"{8 * 149 / dec150:.1f} decode tokens/s (150-token call less 1-token call: "
              f"{8 * 149 / (t150 - t1):.1f}) [{each}]; a replayed step {step_ms:.3f} device ms (149: {0.149 * step_ms:.3f}s) "
              f"-> {8e3 / step_ms:.1f} tokens/s at the device's pace; {EAGER_TOKENS} tokens "
              f"{t_eager:.3f}s eager -> {8 * (EAGER_TOKENS - 1) / (t_eager - t1):.1f}; weights "
              f"{gib(tree_bytes(p)):.2f} GiB, "
              f"peak {gib(torch.cuda.max_memory_allocated()):.2f} GiB "
              f"({gib(torch.cuda.max_memory_allocated() - before):.2f} over the "
              f"{gib(before):.2f} allocated before)", flush=True)
        if int4:
            phase_int4_mode(label, p, c, tok, prompts8, stops, last.loop)
        del p, last
        GRAPHS.clear()
    del q8, q4, pipe, engine
    torch.cuda.empty_cache()
    return launches


class LastLoop:
    """Keeps the decode loop (``models/graphs.py::Loop``) of each generate
    call made while the context is open (``models/decode.py``'s
    ``_decode_loop``, wrapped): its steps, host checks and graph."""

    def __enter__(self):
        from probing_rag_tpu_torch.models import decode

        self.loop, self.saved = None, decode._decode_loop

        def keep(*args, **kw):
            self.loop = self.saved(*args, **kw)
            return self.loop

        decode._decode_loop = keep
        return self

    def __exit__(self, *exc):
        from probing_rag_tpu_torch.models import decode

        decode._decode_loop = self.saved
        return False


def attention_operands(gen, kind: str, t: int, dt, s=None, model: str = "gemma_2b"):
    """Seeded operands of one decode attention case at ``model``'s width
    (``GemmaConfig``'s heads, kv heads and head dim), batch 8: q [8, t, H,
    hd] in ``dt``; one layer's K and V over ``s`` slots (``ATTN_SLOTS`` by
    default) in the cache's format (``kind`` "f32", "bf16", "int8" or
    "int4", from the port's own KV quantizers) with their scales; the
    decode mask of the cursor at the last t slots, rows 0-6 left-padded by
    ``ATTN_PADS`` and row 7 all pad (every slot masked)."""
    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig

    cfg = getattr(GemmaConfig, model)()
    b, h, kvh, hd = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = ATTN_SLOTS if s is None else s
    k, v, scales = cache_layer(gen, kind, b, kvh, s, hd)
    q = torch.randn((b, t, h, hd), generator=gen, device=DEVICE).to(dt)
    slot = torch.arange(s, device=DEVICE)
    pads = torch.tensor(list(ATTN_PADS) + [s], device=DEVICE)
    valid = slot[None, :] >= pads[:, None]  # [B, S]
    causal = slot[None, :] <= (s - t + torch.arange(t, device=DEVICE))[:, None]  # [T, S]
    mask = (valid[:, None, :] & causal[None])[:, None]  # [B, 1, T, S]
    return q, k, v, mask, scales


def cache_layer(gen, kind: str, b: int, kvh: int, s: int, hd: int):
    """One seeded cache layer (K, V ~ N(0, 1), [b, kvh, s, hd]) in the
    cache's format ``kind`` ("f32", "bf16", "int8" or "int4", from the
    port's own KV quantizers) with its scales (None, None for f32 and bf16)."""
    import torch

    from probing_rag_tpu_torch.ops.attention import pack_int4, quant_kv, quant_kv4

    x = torch.randn((2, b, kvh, s, hd), generator=gen, device=DEVICE)
    scales = (None, None)
    if kind == "int8":
        q8, sc = quant_kv(x)
        (k, v), scales = q8, (sc[0, ..., 0], sc[1, ..., 0])
    elif kind == "int4":
        q4, sc = quant_kv4(x)  # sc [2, B, KV, S, G]
        k, v = pack_int4(q4[0]), pack_int4(q4[1])
        merged = sc.transpose(-1, -2).reshape(2, b, -1, s).contiguous()  # the cache's layout
        scales = (merged[0], merged[1])
    else:
        k, v = x.to(torch.float32 if kind == "f32" else torch.bfloat16)
    return k.contiguous(), v.contiguous(), scales


def kv_head_slice(q, k, v, ks, vs, first: int, count: int):
    """kv heads [first, first + count) of a case's operands, as a
    tensor-parallel rank holds them (``gemma._rank_kv_heads``): narrowed
    views of the cache and scales (int4: a scale row per group), and the
    query heads of those kv heads."""
    kvh, h = k.shape[1], q.shape[2]
    g = h // kvh
    rows = ks.shape[1] // kvh if ks is not None else 0
    ks, vs = ((x.narrow(1, first * rows, count * rows) if x is not None else None)
              for x in (ks, vs))
    return (q.narrow(2, first * g, count * g), k.narrow(1, first, count),
            v.narrow(1, first, count), ks, vs)


def tolerance_controls(q, k, v, mask, ks, vs, dt, ref, tol) -> tuple:
    """Two faults held to the bf16 limit ``tol`` around the plain output
    ``ref``: the plain version with its probabilities left unrounded, and
    with one tile (``TILE`` slots from the middle of the cache) dropped from
    the value sum. Returns how many elements of each exceed the limit and
    its worst ratio to it; either being 0 means the check cannot see the
    fault."""
    import torch

    from probing_rag_tpu_torch.ops import attention as at

    b, t, h, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    vd = at.dequant_kv(v, vs, dt).float()
    _, p = at.attn_core(q.reshape(b, t, kvh, h // kvh, hd), at.dequant_kv(k, ks, dt), vd, mask,
                        return_probs=True)
    p = p.reshape(b, kvh, h // kvh, t, s)

    def excess(pp):
        out = torch.einsum("bkgts,bksh->btkgh", pp, vd).reshape(b, t, h * hd)
        ratio = ((out - ref).abs() / tol).nan_to_num(nan=0.0)  # 0 / 0: no error where none may be
        return int((ratio > 1).sum()), float(ratio.max())

    dropped = p.to(dt).float()
    s0 = at.TILE * (s // at.TILE // 2)
    dropped[..., s0:s0 + at.TILE] = 0.0
    return excess(p), excess(dropped)


def attention_case(gen, kind: str, t: int, dt, slots=None, model: str = "gemma_2b",
                   kv_heads=None, timed: bool = True) -> dict:
    """One ``decode_attention`` case: the kernel against its plain version
    on the card (same operands), on ``kv_heads`` (first, count) of the
    cache where given; timed: its plan, kernel / plain ms, the bound and,
    at bf16 compute, ``scaled_dot_product_attention`` on the same inputs
    (an int8 or int4 cache dequantized to bf16 before the timed call) as
    the library yardstick. Tolerance: f32 compute 1e-5 + 1e-5 |ref|
    (sums in another order); bf16 compute ``rounding_tolerance`` element by
    element (a probability may round to the neighbouring bf16 value only
    within 1e-5 of itself of a rounding midpoint, plus 1e-5 of the sum of
    |p v| for the f32 sums), which the two faults of
    ``tolerance_controls`` must exceed. Prints the case's line; returns its
    numbers."""
    import torch
    import torch.nn.functional as F

    from probing_rag_tpu_torch.ops import attention as at

    q, k, v, mask, (ks, vs) = attention_operands(gen, kind, t, dt, slots, model)
    if kv_heads is not None:
        q, k, v, ks, vs = kv_head_slice(q, k, v, ks, vs, *kv_heads)
    at.last_plan = None
    got = at.decode_attention(q, k, v, mask, k_scale=ks, v_scale=vs, dt=dt)
    plan = at.last_plan
    ref = at.decode_attention_plain(q, k, v, mask, k_scale=ks, v_scale=vs, dt=dt)
    sync()
    err = float((got - ref).abs().max())
    if dt == torch.float32:
        tol = 1e-5 + 1e-5 * ref.abs()
        limit = "1e-5 + 1e-5 |ref|"
    else:
        tol = at.rounding_tolerance(q, k, v, mask, k_scale=ks, v_scale=vs, dt=dt)
        (n_un, r_un), (n_drop, r_drop) = tolerance_controls(q, k, v, mask, ks, vs, dt, ref, tol)
        limit = (f"per element, max {float(tol.max()):.3g}, median {float(tol.median()):.3g}; "
                 f"worst err/limit {float(((got - ref).abs() / tol).max()):.3g}; controls over "
                 f"it: unrounded probabilities {n_un} elements (worst {r_un:.3g}x), one tile "
                 f"dropped {n_drop} (worst {r_drop:.3g}x)")
        if n_un == 0 or n_drop == 0:
            raise AssertionError(f"decode_attention {kind} T {t}: the bf16 limit lets a fault "
                                 f"through ({limit})")
    h, hd = q.shape[2], q.shape[3]
    what = (f"decode_attention {model} {kind} cache, {'bf16' if dt == torch.bfloat16 else 'f32'} "
            f"compute, T {t}, [{q.shape[0]} x {h} heads / {k.shape[1]} kv x {k.shape[2]} slots x "
            f"{hd}]" + (f", kv heads {kv_heads[0]}-{sum(kv_heads) - 1} of a slice" if kv_heads
                        else ""))
    if not torch.isfinite(got).all() or not bool(((got - ref).abs() <= tol).all()):
        raise AssertionError(f"{what}: kernel differs from plain by {err} (limit {limit})")
    blocks = plan.nsplit * k.shape[0] * k.shape[1] if plan else 0
    how = f"{plan.nsplit} splits of {plan.tiles_per_split} tiles, {blocks} blocks" if plan else "plain"
    if not timed:
        print(f"  {what}, {how}: max abs err {err:.3g} (limit {limit})", flush=True)
        del got, ref, tol
        return {"max_abs_err": err}
    # row 7 masks every slot: each weighs 1 / S, rounded to the compute type
    w = torch.tensor(1.0 / k.shape[2]).to(dt).float()
    vmean = w * at.dequant_kv(v, vs, dt).float()[7].sum(dim=1)  # [KV, hd]
    kvh = vmean.shape[0]
    pad_row = float((got[7].reshape(t, kvh, -1, vmean.shape[1]) - vmean[:, None]).abs().max())
    del got, ref, tol
    ms = cuda_ms(lambda: at.decode_attention(q, k, v, mask, k_scale=ks, v_scale=vs, dt=dt))
    plain_ms = cuda_ms(lambda: at.decode_attention_plain(q, k, v, mask, k_scale=ks, v_scale=vs,
                                                         dt=dt))
    b, s = q.shape[0], k.shape[2]
    cache_bytes = sum(x.numel() * x.element_size() for x in (k, v, ks, vs) if x is not None)
    nbytes = cache_bytes + q.numel() * q.element_size() + mask.numel() + b * t * h * hd * 4
    bnd = bound(nbytes, 4 * b * h * t * s * hd, "f32" if dt == torch.float32 else "bf16")
    lib_ms = None
    line = ""
    if kind in ("bf16", "int8", "int4") and dt == torch.bfloat16:
        # one PyTorch call of the same function on a bf16 cache; an int8 or
        # int4 cache dequantized to bf16 first, outside the timed call
        qh = q.transpose(1, 2)
        kd, vd = (k, v) if kind == "bf16" else (at.dequant_kv(k, ks, dt), at.dequant_kv(v, vs, dt))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask, enable_gqa=True)

        try:
            sdpa()
            sync()
            lib_ms = cuda_ms(sdpa)
            line = f"; scaled_dot_product_attention {lib_ms:.4f} ms"
        except (RuntimeError, TypeError) as e:
            line = f"; scaled_dot_product_attention: none ({str(e).splitlines()[0][:60]})"
    print(f"  {what}, {how}: max abs err {err:.3g} (limit {limit}); pad row (all slots masked) "
          f"vs v summed at weight 1 / S {pad_row:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; cache "
          f"{cache_bytes / 1e6:.1f} MB){line}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bnd}


def phase_attention_kernels(results: dict) -> None:
    """``decode_attention`` against its plain version at phase 9's shape
    for the f32 (T 1), bf16, int8 and int4 caches at T 1 and ``SPEC_K`` +
    1, each with left-pad rows and an all-pad row, timed, then the bf16 T 1
    case over a cache ``ATTN_LONG`` times longer. Untimed checks: f32
    compute over the int8 and int4 caches and at T ``SPEC_K`` + 1; at
    Mistral-7B's shape (G 4, head dim 128) the int8 and int4 caches at T 1
    and ``SPEC_K`` + 1 in bf16 and f32, and the same on kv heads 2-3 of 8
    (one rank of four under tensor parallelism). The kernels line takes
    the bf16 T 1 case (a bf16 decode step's layer) and the others' times."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    bf16, f32 = torch.bfloat16, torch.float32
    verify = SPEC_K + 1
    cases = [("f32", 1, f32)] + [(kind, t, bf16) for kind in ("bf16", "int8", "int4")
                                 for t in (1, verify)]
    out = {}
    for kind, t, dt in cases:
        out[(kind, t)] = attention_case(gen, kind, t, dt)
    main = out[("bf16", 1)]
    long = attention_case(gen, "bf16", 1, bf16, ATTN_LONG * ATTN_SLOTS)
    checks = [attention_case(gen, kind, t, f32, timed=False)
              for kind, t in (("int8", 1), ("int4", 1), ("f32", verify), ("int8", verify),
                              ("int4", verify))]
    checks += [attention_case(gen, kind, t, dt, model="mistral_7b", kv_heads=heads, timed=False)
               for heads in (None, (2, 2)) for kind in ("int8", "int4") for t in (1, verify)
               for dt in (bf16, f32)]
    results["decode_attention"] = {
        **main, "max_abs_err": max(r["max_abs_err"] for r in [*out.values(), *checks]),
        **{f"long_cache_{key}": long[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "shape": f"[8 x 8 x {ATTN_SLOTS} x 256] bf16 cache, T 1",
        **{f"{kind}_t{t}_{key}": r[key] for (kind, t), r in out.items() if (kind, t) != ("bf16", 1)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }


def prefill_operands(gen, kind: str, t: int, cache: bool, model: str = "gemma_2b"):
    """Seeded operands of one prefill attention case at ``model``'s width,
    batch 8: q [8, t, H, hd] bf16, one layer's K and V in the cache's format
    ``kind`` with their scales, and the structured mask (qpos, kpos, valid).
    ``cache``: the retrieval round's prefill, t prompt slots of which rows
    0-6 are left-padded by ``ATTN_PADS`` (scaled to t) and row 7 is all pad,
    then ``GEN_TOKENS`` slots for the decode (valid, not yet attendable);
    qpos = kpos = the slot (the cursor at 0), as ``forward`` masks a cache.
    Else the capture forward's no-cache shape: S = t, left pads likewise,
    positions ``cumsum(valid) - 1`` clamped at 0 for both qpos and kpos (a
    pad row attends the first real token, after it in the buffer)."""
    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig

    cfg = getattr(GemmaConfig, model)()
    b, h, kvh, hd = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = t + GEN_TOKENS if cache else t
    k, v, scales = cache_layer(gen, kind, b, kvh, s, hd)
    q = torch.randn((b, t, h, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
    pads = torch.tensor([p * t // ATTN_PROMPT for p in ATTN_PADS] + [t], device=DEVICE)
    tok = torch.arange(t, device=DEVICE)
    prompt_valid = tok[None, :] >= pads[:, None]  # [B, t]
    if cache:
        valid = torch.cat([prompt_valid, torch.ones((b, s - t), dtype=torch.bool,
                                                    device=DEVICE)], dim=1)
        qpos = tok[None, :].expand(b, t)
        kpos = torch.arange(s, device=DEVICE)[None, :].expand(b, s)
    else:
        valid = prompt_valid
        qpos = kpos = torch.clamp(torch.cumsum(valid.long(), dim=-1) - 1, min=0)
    return q, k, v, (qpos, kpos, valid), scales


def prefill_case(gen, label: str, kind: str, t: int, cache: bool, model: str = "gemma_2b",
                 kv_heads=None) -> dict:
    """One ``prefill_attention`` case: the kernel against its plain version
    on the card (same operands; on ``kv_heads`` (first, count) of the cache
    where given), held element by element to ``rounding_tolerance`` (which
    the two faults of ``tolerance_controls`` must exceed); a second launch
    on the same operands bit-equal to the first (a fixed summation order);
    rows with no attendable slot (left pads of the cache path, the all-pad
    row) against v summed at weight bf16(1 / S); the plan it launched
    (``ops/attention.py::plan_prefill_attention``); kernel / plain ms,
    ``scaled_dot_product_attention`` on the same bf16 operands (the cache
    dequantized first) and bool mask as the library yardstick, and the
    bound from the attended (row, slot) pairs. Prints the case's line;
    returns its numbers."""
    import torch
    import torch.nn.functional as F

    from probing_rag_tpu_torch.ops import attention as at

    bf16 = torch.bfloat16
    q, k, v, (qpos, kpos, valid), (ks, vs) = prefill_operands(gen, kind, t, cache, model)
    if kv_heads is not None:
        q, k, v, ks, vs = kv_head_slice(q, k, v, ks, vs, *kv_heads)
    at.last_prefill_plan = None
    got = at.prefill_attention(q, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs, dt=bf16)
    plan = at.last_prefill_plan
    again = at.prefill_attention(q, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs, dt=bf16)
    ref = at.prefill_attention_plain(q, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs, dt=bf16)
    mask = at.structured_mask(qpos, kpos, valid)
    sync()
    bit_equal = torch.equal(got, again)
    del again
    err = float((got - ref).abs().max())
    tol = at.rounding_tolerance(q, k, v, mask, k_scale=ks, v_scale=vs, dt=bf16)
    ratio = float(((got - ref).abs() / tol).nan_to_num(nan=0.0).max())
    ok = bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= tol).all())
    b, _, h, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    # rows with no attendable slot: bf16(1 / S) v over all S slots
    dead = ~mask[:, 0].any(dim=-1)  # [B, T]
    w = torch.tensor(1.0 / s).to(bf16).float()
    vmean = w * at.dequant_kv(v, vs, bf16).float().sum(dim=2)  # [B, KV, hd]
    want = vmean[:, None, :, None, :].expand(b, t, kvh, h // kvh, hd).reshape(b, t, h * hd)
    dead_err = float((got - want).abs()[dead].max()) if bool(dead.any()) else 0.0
    what = (f"prefill_attention {label}: {model} {kind} cache, [{b} x {t} positions x {h} heads / "
            f"{kvh} kv x {s} slots x {hd}]")
    tol_max, tol_med = float(tol.max()), float(tol.median())
    del tol
    (n_un, r_un), (n_drop, r_drop) = tolerance_controls(q, k, v, mask, ks, vs, bf16, ref,
                                                        at.rounding_tolerance(
                                                            q, k, v, mask, k_scale=ks,
                                                            v_scale=vs, dt=bf16))
    limit = (f"per element, max {tol_max:.3g}, median {tol_med:.3g}; worst err/limit "
             f"{ratio:.3g}; controls over it: unrounded probabilities {n_un} elements (worst "
             f"{r_un:.3g}x), one tile dropped {n_drop} (worst {r_drop:.3g}x)")
    if not ok:
        raise AssertionError(f"{what}: kernel differs from plain by {err} ({limit})")
    if not bit_equal:
        raise AssertionError(f"{what}: two launches on the same operands differ")
    if n_un == 0 or n_drop == 0:
        raise AssertionError(f"{what}: the bf16 limit lets a fault through ({limit})")
    if dead_err > 1e-5 * float(want.abs().max()) + 1e-6:
        raise AssertionError(f"{what}: rows with no attendable slot differ from the mean of v "
                             f"by {dead_err}")
    del got, ref, want
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: at.prefill_attention(q, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs,
                                              dt=bf16))
    plain_ms = cuda_ms(lambda: at.prefill_attention_plain(q, k, v, qpos, kpos, valid,
                                                          k_scale=ks, v_scale=vs, dt=bf16),
                       reps=2)
    torch.cuda.empty_cache()
    pairs = int(mask.sum())  # attended (position, slot) pairs; each meets the G heads
    ops = 4.0 * hd * pairs * (h // kvh) * kvh
    nbytes = (sum(x.numel() * x.element_size() for x in (q, k, v, ks, vs, qpos, kpos, valid)
                  if x is not None) + b * t * h * hd * 4)
    bnd = bound(nbytes, ops, "bf16")
    qh, kd, vd = q.transpose(1, 2), at.dequant_kv(k, ks, bf16), at.dequant_kv(v, vs, bf16)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask, enable_gqa=True)

    try:
        sdpa()
        sync()
        lib_ms = cuda_ms(sdpa)
        line = f"scaled_dot_product_attention {lib_ms:.4f} ms"
    except (RuntimeError, TypeError) as e:
        lib_ms, line = None, f"scaled_dot_product_attention: none ({str(e).splitlines()[0][:60]})"
    print(f"  {what}: max abs err {err:.3g} (limit {limit}); two launches bit-equal; "
          f"{int(dead.sum())} rows with no attendable slot vs v summed at weight 1 / S "
          f"{dead_err:.3g}; plan: tile {plan.tile} slots, ring {plan.stages} stages, raw ring "
          f"{plan.raw_stages} x {plan.raw_slots} slots, {plan.positions} positions a block, "
          f"{plan.smem} B shared; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {line}, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {pairs} attended pairs a head, "
          f"{ops:.3g} operations, {nbytes / 1e6:.1f} MB)", flush=True)
    del q, k, v, ks, vs, qh, kd, vd, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bnd}


def phase_prefill_kernels(results: dict) -> None:
    """``prefill_attention`` against its plain version (``prefill_case``):
    the retrieval round's prefill at Gemma-2B width (8 x ``PREFILL_T``
    prompt tokens into ``PREFILL_T`` + ``GEN_TOKENS`` slots, left pads and
    an all-pad row) over bf16, int8 and int4 caches; the capture forward's
    no-cache shape (8 x ``TRAIN_MAX_LEN``, positions-style pads); Mistral-7B's
    (32 heads / 8 kv x 128) at ``PREFILL_MISTRAL_T`` over an int8 cache,
    whole and on kv heads 2-3 (a tensor-parallel rank's slice). The kernels
    line takes the bf16 prefill case and the others' times. First, ptxas's
    report of each ``prefill_attn`` instantiation (registers and spills,
    which ptxas gives a kernel, not a role) beside the plan's setmaxnreg
    budgets of its consumer and producer warpgroups."""
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.ops import attention as at

    kinds = {0: torch.bfloat16, 1: torch.float32, 2: torch.int8, 3: torch.uint8}
    names = {0: "bf16", 1: "f32", 2: "int8", 3: "int4"}
    for u in sorted(kernels.ptxas_usage("prefill_attnI"), key=lambda u: u["template"]):
        kind, hd = u["template"][:2]
        plan = at.plan_prefill_attention(kinds[kind], hd, 1)
        print(f"  ptxas prefill_attn<{names[kind]}, hd {hd}>: {u['registers']} registers a thread "
              f"at launch, spills {u['spill_stores']} B stored / {u['spill_loads']} B loaded; "
              f"setmaxnreg consumers {plan.consumer_regs}, producer {plan.producer_regs}"
              + (f"; {'; '.join(u['warnings'])}" if u["warnings"] else ""), flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    out = {
        "prefill bf16": prefill_case(gen, "retrieval prefill", "bf16", PREFILL_T, True),
        "prefill int8": prefill_case(gen, "retrieval prefill", "int8", PREFILL_T, True),
        "prefill int4": prefill_case(gen, "retrieval prefill", "int4", PREFILL_T, True),
        "capture": prefill_case(gen, "capture forward", "bf16", TRAIN_MAX_LEN, False),
        "mistral": prefill_case(gen, "prefill", "int8", PREFILL_MISTRAL_T, True, "mistral_7b"),
        "mistral slice": prefill_case(gen, "prefill", "int8", PREFILL_MISTRAL_T, True,
                                      "mistral_7b", (2, 2)),
    }
    main = out["prefill bf16"]
    results["prefill_attention"] = {
        **main, "max_abs_err": max(r["max_abs_err"] for r in out.values()),
        "shape": f"[8 x {PREFILL_T} x 8 x {PREFILL_T + GEN_TOKENS} x 256] bf16 cache",
        **{f"{name.replace(' ', '_')}_{key}": r[key] for name, r in out.items()
           if name != "prefill bf16" for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }


class PlainAttention:
    """Routes the LM's decode and prefill attention to their plain versions
    while open (a step captured inside captures the plain ops); the graph
    cache is cleared on the way in and out, so that no step captured with
    the other routing is replayed."""

    def __enter__(self):
        from probing_rag_tpu_torch.models import gemma
        from probing_rag_tpu_torch.models.graphs import GRAPHS
        from probing_rag_tpu_torch.ops import attention as at

        GRAPHS.clear()
        self.saved = gemma.decode_attention, gemma.prefill_attention
        gemma.decode_attention = at.decode_attention_plain
        gemma.prefill_attention = at.prefill_attention_plain
        return self

    def __exit__(self, *exc):
        from probing_rag_tpu_torch.models import gemma
        from probing_rag_tpu_torch.models.graphs import GRAPHS

        gemma.decode_attention, gemma.prefill_attention = self.saved
        GRAPHS.clear()
        return False


class PlainBlock:
    """Routes the LM block's norm, RoPE / cache write and gated activation
    to their plain versions (``ops/block.py``'s ``*_plain``) while open (a
    step captured inside captures the plain ops); the graph cache is
    cleared on the way in and out, as ``PlainAttention`` clears it."""

    def __enter__(self):
        from probing_rag_tpu_torch.models import gemma
        from probing_rag_tpu_torch.models.graphs import GRAPHS
        from probing_rag_tpu_torch.ops import block as bk

        GRAPHS.clear()
        self.saved = gemma.add_rms_norm, gemma.rope_qk_cache, gemma.gated_act
        gemma.add_rms_norm = bk.add_rms_norm_plain
        gemma.rope_qk_cache = bk.rope_qk_cache_plain
        gemma.gated_act = bk.gated_act_plain
        return self

    def __exit__(self, *exc):
        from probing_rag_tpu_torch.models import gemma
        from probing_rag_tpu_torch.models.graphs import GRAPHS

        gemma.add_rms_norm, gemma.rope_qk_cache, gemma.gated_act = self.saved
        GRAPHS.clear()
        return False


# phase 9a: the block's elementwise kernels at the main path's shapes: rows
# of a decode step (batch 8), a verify round (8 x 5), the retrieval round's
# prefill (8 x PREFILL_T) and the capture forward (8 x TRAIN_MAX_LEN); the
# decode cursor near the end of the retrieval round's cache
BLOCK_ROWS = {"decode": 8, "verify": 8 * (SPEC_K + 1), "prefill": 8 * PREFILL_T,
              "capture": 8 * 1536}
BLOCK_DECODE_POS = 3800
# the first designs of rms_norm.cu (a warp a row in a grid-stride loop),
# rope_kv.cu (a block a token) and gated_act.cu (a grid-stride loop of
# 16-byte vectors, 256-thread blocks; timed applying it in place to one
# buffer, its values drifting toward 0 over the repeats) at the timed
# cases, ms (this phase on an NVIDIA H100 80GB HBM3, 700.00 W), printed in
# brackets beside this run's times; cases they were not timed at have none
FIRST_DESIGN_MS = {
    "rms_norm prefill gemma_2b": 0.2860, "rms_norm decode gemma_2b": 0.0063,
    "rms_norm capture gemma_2b": 0.1230, "rms_norm prefill mistral_7b": 0.1939,
    "rope_kv prefill gemma_2b bf16": 0.1604, "rope_kv decode gemma_2b bf16": 0.0047,
    "rope_kv decode gemma_2b int8": 0.0049, "rope_kv decode gemma_2b int4": 0.0059,
    "rope_kv prefill gemma_2b int8": 0.2256, "rope_kv capture gemma_2b none": 0.0690,
    "gated_act prefill gemma_2b": 1.0177, "gated_act decode gemma_2b": 0.0033,
    "gated_act capture gemma_2b": 0.4271, "gated_act prefill mistral_7b": 0.2535,
}
BLOCK_MODELS = {  # d_model, heads, kv heads, head dim, d_ff, activation, plus_one
    "gemma_2b": (2048, 8, 1, 256, 16_384, "gelu", True),
    "mistral_7b": (4096, 32, 8, 128, 14_336, "silu", False),
    "tiny": (64, 2, 1, 32, 128, "gelu", True),
    "tiny_mistral": (64, 4, 2, 16, 128, "silu", False),
}


def held(what: str, got, ref, tol, controls: dict) -> tuple:
    """``got`` against ``ref`` element by element within ``tol``, and each
    fault of ``controls`` (name -> tensor) over it somewhere. Returns (max
    abs err, elements not bit-equal, the line's text)."""
    import torch

    diff = (got.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    unequal = int((got.float() != ref.float()).sum())
    if not bool(torch.isfinite(got.float()).all()) or bool((diff > tol).any()):
        raise AssertionError(f"{what}: kernel differs from plain by {err} "
                             f"({int((diff > tol).sum())} elements over the bound)")
    over = {name: int(((c.float() - ref.float()).abs() > tol).sum())
            for name, c in controls.items()}
    if any(n == 0 for n in over.values()):
        raise AssertionError(f"{what}: the bound lets a fault through ({over})")
    text = (f"max abs err {err:.3g}, {unequal} of {diff.numel()} not bit-equal (bound per "
            f"element, max {float(tol.max()):.3g}, {100 * float((tol == 0).float().mean()):.1f}% "
            f"zero); controls over it: " + ", ".join(f"{k} {v}" for k, v in over.items()))
    return err, unequal, text


def norm_case(gen, label: str, rows: int, model: str, dt, delta=True, timed=False) -> dict:
    """``add_rms_norm`` against its plain version on [rows, D] of
    ``model``: the residual bit-equal, ``normed`` within
    ``ops/block.py::norm_tolerance``, which a dropped (or added) ``1 + w``
    and a skipped residual add exceed. ``delta`` False: the first layer's
    norm (no add)."""
    import torch
    import torch.nn.functional as F

    from probing_rag_tpu_torch.ops import block as bk

    d, plus_one = BLOCK_MODELS[model][0], BLOCK_MODELS[model][6]
    x = 3 * torch.randn((rows, d), generator=gen, device=DEVICE)
    dl = torch.randn((rows, d), generator=gen, device=DEVICE).to(dt) if delta else None
    w = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dt)
    resid, normed = bk.add_rms_norm(x, w, 1e-6, plus_one, delta=dl, dt=dt)
    ref_resid, ref = bk.add_rms_norm_plain(x, w, 1e-6, plus_one, delta=dl, dt=dt)
    sync()
    if not torch.equal(resid, ref_resid):
        raise AssertionError(f"rms_norm {label}: the residual add is not bit-equal")
    tol = bk.norm_tolerance(ref_resid, w, 1e-6, plus_one, dt)
    controls = {"1 + w flipped": bk.rms_norm(ref_resid, w, 1e-6, not plus_one).to(dt)}
    if delta:
        controls["add skipped"] = bk.rms_norm(x, w, 1e-6, plus_one).to(dt)
    what = (f"rms_norm {label} {model} [{rows} x {d}] {str(dt)[6:]}"
            f"{' + ' + str(dl.dtype)[6:] + ' delta' if delta else ', no delta'}")
    err, _, text = held(what, normed, ref, tol, controls)
    out = {"max_abs_err": err}
    if timed:
        ms = cuda_ms(lambda: bk.add_rms_norm(x, w, 1e-6, plus_one, delta=dl, dt=dt))
        plain_ms = cuda_ms(lambda: bk.add_rms_norm_plain(x, w, 1e-6, plus_one, delta=dl, dt=dt))
        es = torch.empty((), dtype=dt).element_size()
        nbytes = rows * d * (4 + es) + (rows * d * (dl.element_size() + 4) if delta else 0) + d * es
        bnd = bound(nbytes, 4 * rows * d, "f32")
        lib_ms = None
        if hasattr(F, "rms_norm"):  # a yardstick only: the norm of the summed f32 residual
            scale = ((1.0 + w.float()) if plus_one else w.float()).contiguous()
            lib_ms = cuda_ms(lambda: F.rms_norm(ref_resid, (d,), weight=scale, eps=1e-6))
        out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bnd)
        lib_bytes = rows * d * (4 + es) + d * 4  # F.rms_norm: the summed input in, normed out
        text += (f"; kernel {ms:.4f} ms{was(f'rms_norm {label} {model}')}, plain "
                 f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                 f"{nbytes / 1e6:.1f} MB; {bnd['bound_ms'] / ms:.0%} of it)"
                 + (f", F.rms_norm {lib_ms:.4f} ms (its own bound "
                    f"{lib_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms: no delta read, no resid write)"
                    if lib_ms is not None else "")
                 + plan_text("rms_norm"))
    print(f"  {what}: {text}", flush=True)
    return out


def plan_text(kernel: str) -> str:
    """The last launch's plan of a block kernel (none on the CPU)."""
    from probing_rag_tpu_torch.ops import block as bk

    plan = bk.last_plan[kernel]
    return f"; plan {dict(plan._asdict())}" if plan is not None else ""


def was(key: str, how: str = "") -> str:
    """The first design's time of a timed case, in brackets, with how it
    was timed (empty if it had none)."""
    if key not in FIRST_DESIGN_MS:
        return ""
    return f" [first design {FIRST_DESIGN_MS[key]:.4f}{', ' + how if how else ''}]"


def rope_case(gen, label: str, model: str, t: int, kind: str, dt, timed=False) -> dict:
    """``rope_qk_cache`` against its plain version at batch 8 for
    ``model``'s heads: ``kind`` "none" (the no-cache forward: k and v as new
    [B, KV, T, hd]) or a cache of that type (bf16, f32, int8, int4; layer 1
    of 2) at cursor 0 for a prefill (T > 5) and ``BLOCK_DECODE_POS`` for a
    decode step or verify round, positions left-padded (row 7 by all but
    its last token). q within ``rope_tolerance`` (the kernel and the plain
    ops call the same cosf, sinf and powf: expected bit-equal), a position
    off by one over it; v's cache rows and scales bit-equal; k's bit-equal
    where q is, else within one step of the stored type."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_kv_cache
    from probing_rag_tpu_torch.ops import attention as at
    from probing_rag_tpu_torch.ops import block as bk

    _, h, kvh, hd = BLOCK_MODELS[model][:4]
    b, theta = 8, 10_000.0
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dt)
               for shape in ((b, t, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
    pads = torch.tensor([0, 1, 3, 7, 30, 300, 1000, 10_000], device=DEVICE)
    cursor = 0 if t > SPEC_K + 1 or kind == "none" else BLOCK_DECODE_POS
    slots = cursor + torch.arange(t, device=DEVICE)
    positions = (slots[None, :] - pads[:, None]).clamp(min=0)
    cache = ref_cache = None
    if kind != "none":
        cfg = dataclasses.replace(GemmaConfig.tiny(), n_layers=2, n_heads=h, n_kv_heads=kvh,
                                  head_dim=hd)
        s = ATTN_SLOTS if t <= SPEC_K + 1 else t + GEN_TOKENS
        store = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
                 "int4": "int4"}[kind]
        kv = init_kv_cache(cfg, b, s, store, device=DEVICE)
        kv_ref = {name: x.clone() for name, x in kv.items()}
        pos = torch.tensor(cursor, device=DEVICE)
        cache, ref_cache = (kv, 1, pos), (kv_ref, 1, pos)
    got = bk.rope_qk_cache(q.clone(), k, v, positions, theta, cache=cache)
    ref = bk.rope_qk_cache_plain(q.clone(), k, v, positions, theta, cache=ref_cache)
    sync()
    what = (f"rope_kv {label} {model} [8 x {t} x {h} / {kvh} x {hd}] {str(dt)[6:]}, "
            + ("no cache" if kind == "none" else f"{kind} cache, cursor {cursor}"))
    tol = bk.rope_tolerance(q, positions, theta)
    err, unequal, text = held(what, got[0], ref[0], tol,
                              {"position + 1": bk.rope(q, positions + 1, theta)})
    q_equal = unequal == 0
    for i, name in ((2, "v"), (4, "v scale")):
        if (ref[i] is None) != (got[i] is None) or (ref[i] is not None
                                                     and not torch.equal(got[i], ref[i])):
            raise AssertionError(f"{what}: {name} differs from plain")
    k_unequal = 0
    for i, name in ((1, "k"), (3, "k scale")):
        if ref[i] is None:
            continue
        if got[i].shape != ref[i].shape or got[i].dtype != ref[i].dtype:
            raise AssertionError(f"{what}: {name} {got[i].dtype} {tuple(got[i].shape)} against "
                                 f"{ref[i].dtype} {tuple(ref[i].shape)}")
        k_unequal += int((got[i] != ref[i]).sum())
    if k_unequal and q_equal:
        raise AssertionError(f"{what}: k differs from plain in {k_unequal} places, q does not")
    if k_unequal:  # another libm: the rotated keys within one step of the stored type
        kd = at.dequant_kv(got[1], got[3], torch.float32)
        rd = at.dequant_kv(ref[1], ref[3], torch.float32)
        step = (rd.abs() * 2.0 ** -7 if ref[1].dtype == torch.bfloat16 else
                rd.abs() * 2.0 ** -22 if ref[1].dtype == torch.float32 else
                at.dequant_kv(torch.ones_like(ref[1]) if ref[1].dtype == torch.int8
                              else torch.full_like(ref[1], 0x99), ref[3], torch.float32))
        if bool(((kd - rd).abs() > step * 1.0001).any()):
            raise AssertionError(f"{what}: k beyond one step of the stored type")
    text += f"; v, v scales bit-equal; k and k scales {k_unequal} elements not bit-equal"
    out = {"max_abs_err": err}
    if timed:
        qt = q.clone()
        ms = cuda_ms(lambda: bk.rope_qk_cache(qt, k, v, positions, theta, cache=cache))
        plain_ms = cuda_ms(lambda: bk.rope_qk_cache_plain(q, k, v, positions, theta,
                                                          cache=ref_cache))
        es = q.element_size()
        row = {"none": hd * es, "bf16": hd * 2, "f32": hd * 4, "int8": hd + 4,
               "int4": hd // 2 + 4 * (hd // at.kv4_group(hd))}[kind]
        nbytes = b * t * (2 * h * hd * es + 2 * kvh * hd * es + 2 * kvh * row + 8)
        bnd = bound(nbytes, 6 * b * t * (h + kvh) * hd // 2, "f32")
        out.update(ms=ms, plain_ms=plain_ms, library_ms=None, **bnd)
        text += (f"; kernel {ms:.4f} ms{was(f'rope_kv {label} {model} {kind}')}, plain "
                 f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                 f"{nbytes / 1e6:.1f} MB; {bnd['bound_ms'] / ms:.0%} of it)" + plan_text("rope_kv"))
    print(f"  {what}: {text}", flush=True)
    return out


def gated_case(gen, label: str, rows: int, model: str, dt, timed=False, f=None) -> dict:
    """``gated_act`` against its plain version on [rows, d_ff] of
    ``model`` (or [rows, f]): within ``ops/block.py::gated_tolerance``
    (bit-equal at bf16 where act lies clear of a rounding midpoint), which
    the activation left unrounded before the product (bf16) or gate and up
    swapped exceed; the count of elements not bit-equal and the plan
    printed. Timed: beside the plain version, the byte bound and the
    same-bytes add ``torch.add(gate, up, out=gate)`` (these reads and
    writes with no arithmetic to speak of: the card's floor for this
    traffic at this size, launch latency included)."""
    import torch
    import torch.nn.functional as F

    from probing_rag_tpu_torch.ops import block as bk

    f, act = f or BLOCK_MODELS[model][4], BLOCK_MODELS[model][5]
    g = (2 * torch.randn((rows, f), generator=gen, device=DEVICE)).to(dt)
    u = torch.randn((rows, f), generator=gen, device=DEVICE).to(dt)
    got = bk.gated_act(g.clone(), u, act)
    ref = bk.gated_act_plain(g, u, act)
    sync()
    tol = bk.gated_tolerance(g, u, act)
    fn = (lambda x: F.gelu(x, approximate="tanh")) if act == "gelu" else F.silu
    controls = {"gate and up swapped": bk.gated_act_plain(u, g, act)}
    if dt == torch.bfloat16:
        controls["act unrounded"] = (fn(g.float()) * u.float()).to(dt)
    what = f"gated_act {label} {model} [{rows} x {f}] {act} {str(dt)[6:]}"
    err, unequal, text = held(what, got, ref, tol, controls)
    del tol, controls
    out = {"max_abs_err": err, "not_bit_equal": unequal}
    text += plan_text("gated_act")
    if timed:  # each launch on a fresh copy of gate: in place, repeats drift its values to 0
        fresh = [g.clone() for _ in range(6)]
        ms = cuda_ms(lambda: bk.gated_act(fresh.pop(), u, act), reps=5)
        plain_ms = cuda_ms(lambda: bk.gated_act_plain(g, u, act))
        gt = g.clone()
        add_ms = cuda_ms(lambda: torch.add(gt, u, out=gt))
        nbytes = 3 * rows * f * g.element_size()
        bnd = bound(nbytes, 12 * rows * f, "f32")
        out.update(ms=ms, plain_ms=plain_ms, library_ms=None, same_bytes_add_ms=add_ms, **bnd)
        text += (f"; kernel {ms:.4f} ms{was(f'gated_act {label} {model}', 'in place')}, plain "
                 f"{plain_ms:.4f} ms, same-bytes add {add_ms:.4f} ms ({ms / add_ms:.2f}x), bound "
                 f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, {nbytes / 1e6:.1f} MB; "
                 f"{bnd['bound_ms'] / ms:.0%} of it)")
    print(f"  {what}: {text}", flush=True)
    return out


EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(rounds: int = 4) -> dict:
    """The card's launch floor at ``gated_act``'s decode plan (Gemma-2B's
    [8 x 16,384] bf16): an empty kernel of the plan's geometry, built here,
    timed by ``cuda_ms``, then 18 launches of it in a captured CUDA graph
    (a decode step's 18 a replay) beside 18 ``gated_act`` launches and 18
    same-bytes ``torch.add`` in graphs of their own, on 18 buffers each,
    out of place (gate stays what it was), in turns over ``rounds``. The
    smallest replay over 18, in ms a launch."""
    import ctypes

    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.graphs import StepGraph
    from probing_rag_tpu_torch.ops import block as bk

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = kernels.BUILD_DIR / "empty_kernel.cu", kernels.BUILD_DIR / "empty_kernel.so"
    src.write_text(EMPTY_KERNEL_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    empty_lib = ctypes.CDLL(str(so))
    empty_lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib = kernels.library()
    rows, f = BLOCK_ROWS["decode"], BLOCK_MODELS["gemma_2b"][4]
    plan = bk.plan_act(rows * f, torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def empty():
        kernels.check(empty_lib.empty_launch(plan.blocks, plan.threads, stream()), "empty kernel")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    bufs = [[torch.randn((rows, f), generator=gen, device="cuda").bfloat16() for _ in range(3)]
            for _ in range(18)]

    def act(g, u, o):
        kernels.check(lib.gated_act(g.data_ptr(), u.data_ptr(), o.data_ptr(), 0,
                                    bk.ACTIVATIONS["gelu"], g.numel(), *plan, stream()),
                      "gated_act")

    def add(g, u, o):
        torch.add(g, u, out=o)

    def eighteen(fn):  # a decode step's 18 launches, one a buffer
        def step():
            for buf in bufs:
                fn(*buf)
        return StepGraph(step, lambda: None, lambda saved: None)

    empty_ms = cuda_ms(empty, reps=20)
    graphs = {"empty kernel": eighteen(lambda *buf: empty()), "gated_act": eighteen(act),
              "same-bytes add": eighteen(add)}
    ms = {name: [] for name in graphs}
    for r in range(rounds):
        for name in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            ms[name].append(cuda_ms(graphs[name].replay, reps=20) / 18)
    out = {"empty_cuda_ms": empty_ms, **{f"{k.replace(' ', '_').replace('-', '_')}_graph": min(v)
                                         for k, v in ms.items()}}
    print(f"  launch floor at gated_act's decode plan {dict(plan._asdict())}: an empty kernel "
          f"{empty_ms * 1e3:.2f} us a launch by cuda_ms; 18 in a captured graph, us a launch "
          f"(min of {rounds} x 20 replays): " + ", ".join(
              f"{name} {min(v) * 1e3:.2f}" for name, v in ms.items()), flush=True)
    del bufs, graphs
    return out


def phase_block_kernels(results: dict) -> None:
    """The block's three kernels against their plain versions on the card,
    bf16 and f32, at Gemma-2B's decode step, verify round, prefill and
    capture rows (the norm at D 2048 with and without a delta, RoPE with
    the cache write into bf16, int8 and int4 caches of ``ATTN_SLOTS`` slots
    at cursor ``BLOCK_DECODE_POS`` and at a prefill's cursor 0, the
    no-cache layout, the gated gelu at d_ff 16,384), at Mistral-7B's widths
    (D 4096 without ``1 + w``, 32 / 8 heads x 128, silu at 14,336) and at
    the tiny configs'. Prefill cases are timed beside the plain version and
    the byte bound; the decode step's too. The kernels line takes the
    prefill shape (bf16 cache for rope_kv)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = BLOCK_ROWS
    norm = {
        "prefill": norm_case(gen, "prefill", rows["prefill"], "gemma_2b", bf16, timed=True),
        "decode": norm_case(gen, "decode", rows["decode"], "gemma_2b", bf16, timed=True),
        "capture": norm_case(gen, "capture", rows["capture"], "gemma_2b", bf16, timed=True),
        "mistral prefill": norm_case(gen, "prefill", 8 * PREFILL_MISTRAL_T, "mistral_7b", bf16,
                                     timed=True),
        "verify": norm_case(gen, "verify", rows["verify"], "gemma_2b", bf16, timed=True),
        "mistral decode": norm_case(gen, "decode", rows["decode"], "mistral_7b", bf16,
                                    timed=True),
    }
    checks = [norm_case(gen, "first layer", rows["prefill"], "gemma_2b", bf16, delta=False),
              norm_case(gen, "decode", rows["decode"], "gemma_2b", f32),
              norm_case(gen, "prefill", 8 * 64, "tiny", bf16),
              norm_case(gen, "prefill", 8 * 64, "tiny_mistral", f32)]
    results["rms_norm"] = {
        **norm["prefill"], "max_abs_err": max(r["max_abs_err"] for r in [*norm.values(), *checks]),
        "shape": f"[{rows['prefill']} x 2048] f32 + bf16 delta -> bf16",
        **{f"{k.replace(' ', '_')}_{key}": r[key] for k, r in norm.items() if k != "prefill"
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    rope = {
        "prefill": rope_case(gen, "prefill", "gemma_2b", PREFILL_T, "bf16", bf16, timed=True),
        "decode": rope_case(gen, "decode", "gemma_2b", 1, "bf16", bf16, timed=True),
        "decode int8": rope_case(gen, "decode", "gemma_2b", 1, "int8", bf16, timed=True),
        "decode int4": rope_case(gen, "decode", "gemma_2b", 1, "int4", bf16, timed=True),
        "prefill int8": rope_case(gen, "prefill", "gemma_2b", PREFILL_T, "int8", bf16, timed=True),
        "capture": rope_case(gen, "capture", "gemma_2b", 1536, "none", bf16, timed=True),
    }
    checks = [rope_case(gen, "prefill", "gemma_2b", PREFILL_T, "int4", bf16),
              *(rope_case(gen, "verify", "gemma_2b", SPEC_K + 1, kind, bf16)
                for kind in ("bf16", "int8", "int4")),
              *(rope_case(gen, "decode", "gemma_2b", 1, kind, f32)
                for kind in ("f32", "bf16", "int8", "int4")),
              rope_case(gen, "no-cache", "gemma_2b", 64, "none", f32),
              *(rope_case(gen, "decode", "mistral_7b", t, kind, dt)
                for t in (1, SPEC_K + 1) for kind in ("int8", "int4") for dt in (bf16, f32)),
              rope_case(gen, "prefill", "mistral_7b", PREFILL_MISTRAL_T, "none", bf16),
              *(rope_case(gen, "prefill", model, 64, kind, dt)
                for model in ("tiny", "tiny_mistral") for kind in ("none", "int8", "int4")
                for dt in (bf16, f32))]
    results["rope_kv"] = {
        **rope["prefill"], "max_abs_err": max(r["max_abs_err"] for r in [*rope.values(), *checks]),
        "shape": f"q [8 x {PREFILL_T} x 8 x 256], k and v into a bf16 cache of "
                 f"{PREFILL_T + GEN_TOKENS} slots",
        **{f"{k.replace(' ', '_')}_{key}": r[key] for k, r in rope.items() if k != "prefill"
           for key in ("ms", "plain_ms", "bound_ms")},
    }
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    gated = {
        "prefill": gated_case(gen, "prefill", rows["prefill"], "gemma_2b", bf16, timed=True),
        "decode": gated_case(gen, "decode", rows["decode"], "gemma_2b", bf16, timed=True),
        "capture": gated_case(gen, "capture", rows["capture"], "gemma_2b", bf16, timed=True),
        "mistral prefill": gated_case(gen, "prefill", 8 * PREFILL_MISTRAL_T, "mistral_7b", bf16,
                                      timed=True),
        "verify": gated_case(gen, "verify", rows["verify"], "gemma_2b", bf16, timed=True),
        "mistral decode": gated_case(gen, "decode", rows["decode"], "mistral_7b", bf16,
                                     timed=True),
    }
    checks = [gated_case(gen, "verify", rows["verify"], "mistral_7b", bf16),
              gated_case(gen, "decode", rows["decode"], "gemma_2b", f32),
              gated_case(gen, "decode", rows["decode"], "mistral_7b", f32),
              gated_case(gen, "capture", rows["capture"], "gemma_2b", f32),
              gated_case(gen, "prefill", 8 * 64, "tiny", bf16),
              gated_case(gen, "prefill", 8 * 64, "tiny_mistral", f32),
              # n not a multiple of the vector, small and prefill-sized
              gated_case(gen, "ragged", 8 * 64 + 3, "tiny", bf16, f=125),
              gated_case(gen, "ragged", 8 * 64 + 3, "tiny_mistral", f32, f=125),
              gated_case(gen, "ragged", 257, "gemma_2b", bf16, f=16_383),
              gated_case(gen, "ragged", 257, "mistral_7b", f32, f=14_335)]
    every = [*gated.values(), *checks]
    results["gated_act"] = {
        **gated["prefill"],
        "max_abs_err": max(r["max_abs_err"] for r in every),
        "not_bit_equal": sum(r["not_bit_equal"] for r in every),
        "shape": f"[{rows['prefill']} x 16384] gelu bf16",
        **{f"{k.replace(' ', '_')}_{key}": r[key] for k, r in gated.items() if k != "prefill"
           for key in ("ms", "plain_ms", "bound_ms", "same_bytes_add_ms")},
    }
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        results["gated_act"]["launch_floor_ms"] = launch_floor()


def device_profile(fn, reps: int = 1, top: int = 8, focus=()) -> str:
    """Where ``fn()`` spends its device time: ``torch.profiler`` over one
    call of ``fn`` (``reps`` runs of what it times), the kernels' device
    milliseconds a run by name (the kernels' own events: an op that
    launches a kernel carries its time too), the largest ``top``, the
    total and the kernel launches a run; with ``focus`` (a name or several),
    first for each the kernels whose name holds it, their ms and share of
    the total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.self_device_time_total / reps / 1e3, e.key) for e in events), reverse=True)
    if not rows:
        return "the profiler saw no device time"
    total = sum(ms for ms, _ in rows)
    launches = sum(e.count for e in events) / reps
    head = ""
    for name in ((focus,) if isinstance(focus, str) else focus):
        hit = sum(ms for ms, key in rows if name in key)
        head += f"{name} {hit:.3f} ms, {100 * hit / total:.1f}% of the device time; "
    return head + (f"{total:.3f} ms in {launches:.0f} launches of {len(rows)} kernels; " + "; ".join(
        f"{name[:60]} {ms:.3f}" for ms, name in rows[:top]))


def replay_ms(loop, reps: int = 20) -> float:
    """Device milliseconds of one replay of ``loop``'s captured step
    (``cuda_ms``, the raw graph: these launches count nowhere), its step
    counter reset first so that every replay writes inside its buffers."""
    import torch

    with torch.inference_mode():  # the loop's buffers are inference tensors
        loop.state.step.zero_()
        return cuda_ms(loop.graph.graph.replay, reps=reps)


# the kernels whose share of a bf16 prefill phase 9 prints first
PREFILL_FOCUS = ("prefill_attn", "gated_act")


def step_profile(loop, reps: int = 5, top: int = 8, focus=()) -> str:
    """Where one replay of ``loop``'s captured step spends its device time:
    ``device_profile`` over ``reps`` raw replays, in ms a step."""
    import torch

    def replays():
        for _ in range(reps):
            loop.graph.graph.replay()

    with torch.inference_mode():
        loop.state.step.zero_()
        return device_profile(replays, reps, top, focus)


def phase_generation(lm, index, questions, results: dict) -> dict:
    """Generation as the JAX package runs it, at Gemma-2B width on phase 5's
    bf16 weights, batch 8, the retrieval-round prompts, ``GEN_TOKENS`` new
    tokens with stops off: decode attention's kernel against its plain
    version (``phase_attention_kernels``); the graphed decode against the
    eager step (bf16, and int8 weights + int8 KV, whose matmul_int8
    launches must be 127 a step plus the prefill's, and decode_attention's
    one a layer a step), and against the graphed step with plain attention
    (bf16: where a row parts, within ``ATTN_DRIFT``; f32: equal tokens);
    speculative decode (k = ``SPEC_K``) against
    greedy in f32 and bf16 with the prompt and oracle drafters, seeded
    sampling, and the probing loop with ``spec_k`` over the phase-4 BM25
    index. Returns that loop's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import StopTables, _pad_batch, generate
    from probing_rag_tpu_torch.models.gemma import CaptureSpec, quantize_lm_params
    from probing_rag_tpu_torch.models.graphs import GRAPHS
    from probing_rag_tpu_torch.models.sampling import SamplingConfig
    from probing_rag_tpu_torch.models.speculative import decode_speculative
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    phase_attention_kernels(results)
    phase_prefill_kernels(results)
    params, cfg, probers, tok, store = lm
    engine = BM25Engine(index, device=DEVICE)
    questions = questions[:N_QUANT_QUESTIONS]
    prompts8 = AdaptiveRAGPipeline(params, cfg, tok, engine, store, probers,
                                   RAGConfig(top_k=K)).retrieval_prompts(questions, questions)
    stops = StopTables.disabled(cfg.vocab_size)
    n, steps_max = GEN_TOKENS, GEN_TOKENS - 1

    def run(p, c, max_new=n, **kw):
        with LastLoop() as spy:
            sync()
            t0 = time.time()
            _, res = generate(p, c, tok, prompts8, max_new_tokens=max_new, stop_tables=stops, **kw)
            sync()
        return time.time() - t0, res, spy.loop

    def same(a, b, what):
        for name in ("tokens", "token_valid", "n_generated", "n_pooled"):
            if not np.array_equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{what}: {name} differ")

    def prefill(p, c, **kw):  # a 1-token call: the prefill; seconds and peak GiB
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t, _, _ = run(p, c, 1, **kw)
        return t, (torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0)

    tokens, valid = _pad_batch([tok.encode(q, add_bos=True) for q in prompts8], tok.pad_id)
    print(f"  batch 8, prompts padded to {tokens.shape[1]} tokens, {n} new tokens, stops off")
    t_prefill = {}
    graphed = {}
    q8 = quantize_lm_params(params, bits=8)
    for label, p, kv in (("bf16", params, {}), ("int8 + int8 KV", q8, dict(kv_int8=True))):
        GRAPHS.clear()
        run(p, cfg, 1, **kv)
        kernels.reset_launches()
        t1, peak1 = prefill(p, cfg, **kv)
        prefill_mm = kernels.LAUNCHES["matmul_int8"]
        if kernels.LAUNCHES["prefill_attention"] != cfg.n_layers:
            raise AssertionError(f"{label}: the prefill launched prefill_attention "
                                 f"{kernels.LAUNCHES['prefill_attention']} times, not "
                                 f"{cfg.n_layers}")
        t_first, _, _ = run(p, cfg, **kv)  # captures the step
        kernels.reset_launches()
        t_graph, res_g, loop = run(p, cfg, **kv)
        mm = kernels.LAUNCHES["matmul_int8"]
        attn = kernels.LAUNCHES["decode_attention"]
        block = [kernels.LAUNCHES[name] for name in BLOCK_KERNELS]
        t_eager, res_e, eloop = run(p, cfg, eager=True, **kv)
        same(res_g, res_e, f"{label}: graph vs eager")
        if loop.steps != steps_max or int(res_g.n_generated.sum()) != 8 * n:
            raise AssertionError(f"{label}: {loop.steps} steps, {res_g.n_generated} generated")
        pooled_diff = float(np.abs(res_g.pooled_captures - res_e.pooled_captures).max())
        if not np.array_equal(res_g.pooled_captures, res_e.pooled_captures):
            raise AssertionError(f"{label}: pooled captures of graph and eager differ by "
                                 f"{pooled_diff}")
        per_step = 7 * cfg.n_layers + 1  # seven products a layer and the head: 127 at Gemma-2B
        if kv and mm != prefill_mm + per_step * loop.steps:
            raise AssertionError(f"{label}: matmul_int8 launched {mm} times, not the prefill's "
                                 f"{prefill_mm} + {per_step} x {loop.steps}")
        if attn != cfg.n_layers * loop.steps:  # the prefill (T 3,712) runs prefill_attention
            raise AssertionError(f"{label}: decode_attention launched {attn} times, not "
                                 f"{cfg.n_layers} x {loop.steps}")
        forwards = loop.steps + 1  # the steps and the prefill
        if block != [(2 * cfg.n_layers + 1) * forwards, cfg.n_layers * forwards,
                     cfg.n_layers * forwards]:
            raise AssertionError(f"{label}: rms_norm, rope_kv, gated_act launched {block} times, "
                                 f"not (37, 18, 18) x {forwards} forwards")
        step_ms = replay_ms(loop)
        wall_g = (t_graph - t1) / loop.steps * 1e3
        wall_e = (t_eager - t1) / eloop.steps * 1e3
        print(f"  {label}: graph equals eager (tokens, validity, counts; pooled captures bit-equal, "
              f"max abs diff {pooled_diff:.3g}); capture {t_first - t_graph:.3f}s; {loop.checks} "
              f"host checks (graph), {eloop.checks} (eager) for {loop.steps} steps; prefill "
              f"{t1:.3f}s; decode {8 * loop.steps / (t_graph - t1):.1f} tokens/s graphed, "
              f"{8 * eloop.steps / (t_eager - t1):.1f} eager; step wall {wall_g:.2f} ms graphed, "
              f"{wall_e:.2f} ms eager, device {step_ms:.3f} ms (one replay; the plain-op "
              f"attention step before the kernel, H100 700 W: bf16 8.92 ms wall, 901 tokens/s); "
              f"matmul_int8 launches {mm} (prefill {prefill_mm}), decode_attention {attn}",
              flush=True)
        print(f"  {label} step, device time by kernel (torch.profiler, ms a step): "
              f"{step_profile(loop, focus=('rms_norm', 'rope_kv', 'gated_act'))}", flush=True)
        t_prefill[label] = t1
        graphed[label] = res_g
        if label == "bf16":
            print(f"  bf16 prefill (8 x {tokens.shape[1]} tokens), device time by kernel "
                  f"(torch.profiler, ms): "
                  f"{device_profile(lambda: run(p, cfg, 1, **kv), focus=PREFILL_FOCUS)}",
                  flush=True)
        with PlainAttention():
            run(p, cfg, 1, **kv)
            t1_plain, peak_plain = prefill(p, cfg, **kv)
            if label == "bf16":
                print(f"  bf16 prefill with plain attention, device time by kernel "
                      f"(torch.profiler, ms): {device_profile(lambda: run(p, cfg, 1, **kv))}",
                      flush=True)
            t_plain, res_p, ploop = run(p, cfg, **kv)
            plain_ms = replay_ms(ploop)
        print(f"  {label} prefill (8 x {tokens.shape[1]} tokens, a 1-token generate call): "
              f"{t1:.3f}s, peak {peak1:.2f} GiB with prefill_attention; {t1_plain:.3f}s, peak "
              f"{peak_plain:.2f} GiB with plain attention", flush=True)
        rows = int((res_p.tokens == res_g.tokens).all(axis=1).sum())
        gaps = decode_gaps(p, cfg, tok, prompts8, res_g.tokens, res_p.tokens)
        if gaps and max(gaps) > ATTN_DRIFT:
            raise AssertionError(f"{label}: decode with the attention kernel parts from plain "
                                 f"attention at logit gaps {gaps} (limit {ATTN_DRIFT})")
        print(f"  {label}, graphed step with plain attention: {rows} of 8 rows equal to the "
              f"kernel's (parting rows' logit gaps {[round(g, 5) for g in gaps]}, limit "
              f"{ATTN_DRIFT}); step wall {(t_plain - t1) / ploop.steps * 1e3:.2f} ms, device "
              f"{plain_ms:.3f} ms, {8 * ploop.steps / (t_plain - t1):.1f} tokens/s", flush=True)
        # the same step, prefill and decode with the block's plain ops
        with PlainBlock():
            run(p, cfg, 1, **kv)
            t1_pb, peak_pb = prefill(p, cfg, **kv)
            if label == "bf16":
                print(f"  bf16 prefill with the plain block, device time by kernel "
                      f"(torch.profiler, ms): {device_profile(lambda: run(p, cfg, 1, **kv))}",
                      flush=True)
            t_pb, res_pb, pbloop = run(p, cfg, **kv)
            pb_ms = replay_ms(pbloop)
            print(f"  {label} step with the plain block, device time by kernel (torch.profiler, "
                  f"ms a step): {step_profile(pbloop)}", flush=True)
        rows = int((res_pb.tokens == res_g.tokens).all(axis=1).sum())
        gaps = decode_gaps(p, cfg, tok, prompts8, res_g.tokens, res_pb.tokens)
        if gaps and max(gaps) > ATTN_DRIFT:
            raise AssertionError(f"{label}: decode with the block's kernels parts from the plain "
                                 f"block at logit gaps {gaps} (limit {ATTN_DRIFT})")
        print(f"  {label}, the block's kernels against its plain ops in the same call: prefill "
              f"{t1:.3f}s, peak {peak1:.2f} GiB with the kernels; {t1_pb:.3f}s, peak "
              f"{peak_pb:.2f} GiB plain; graphed step device {step_ms:.3f} ms with the kernels, "
              f"{pb_ms:.3f} ms plain; decode {8 * loop.steps / (t_graph - t1):.1f} tokens/s with "
              f"the kernels, {8 * pbloop.steps / (t_pb - t1_pb):.1f} plain; {rows} of 8 rows "
              f"equal (parting rows' logit gaps {[round(g, 5) for g in gaps]}, limit "
              f"{ATTN_DRIFT})", flush=True)
    del q8
    GRAPHS.clear()
    torch.cuda.empty_cache()

    # speculative decode: exact against greedy in f32; rows equal in bf16
    stop_t = tuple(torch.from_numpy(a).to(DEVICE) for a in
                   (stops.contains_dbl_nl, stops.ends_nl, stops.starts_nl))
    prompt_t = torch.from_numpy(tokens).long().to(DEVICE)
    valid_t = torch.from_numpy(valid).to(DEVICE)

    def spec(p, c, drafter="prompt", oracle=None):
        sync()
        t0 = time.time()
        out = decode_speculative(p, prompt_t, valid_t, stop_t, oracle, cfg=c,
                                 capture=CaptureSpec.for_probing(c), max_new_tokens=n,
                                 eos_id=tok.eos_id, k=SPEC_K, drafter=drafter)
        sync()
        return time.time() - t0, [o.cpu().numpy() if torch.is_tensor(o) else o for o in out]

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    p32, c32 = to_f32(params), dataclasses.replace(cfg, compute_dtype=torch.float32)
    run(p32, c32, 1)
    t1_32, _, _ = run(p32, c32, 1)
    t_g32, res32, _ = run(p32, c32)
    with PlainAttention():
        run(p32, c32, 1)
        _, res32_plain, _ = run(p32, c32)
    same(res32, res32_plain, "f32 graphed decode, attention kernel vs plain")
    with PlainBlock():
        run(p32, c32, 1)
        _, res32_pb, _ = run(p32, c32)
    same(res32, res32_pb, "f32 graphed decode, the block's kernels vs its plain ops")
    print(f"  f32 graphed decode of {n} tokens with the block's kernels equals the step with its "
          f"plain ops (tokens, validity, counts; pooled max abs diff "
          f"{float(np.abs(res32.pooled_captures - res32_pb.pooled_captures).max()):.3g})",
          flush=True)
    print(f"  f32 graphed decode of {n} tokens with the attention kernel equals the step with "
          f"plain attention (tokens, validity, counts; pooled max abs diff "
          f"{float(np.abs(res32.pooled_captures - res32_plain.pooled_captures).max()):.3g})",
          flush=True)
    t_s32, out32 = spec(p32, c32)
    t_s32, out32 = spec(p32, c32)  # the second call replays the captured round
    for i, name in enumerate(("tokens", "token_valid", "pooled_captures", "n_pooled",
                              "n_generated")):
        ref = getattr(res32, name)
        if name == "pooled_captures":
            diff32 = float(np.abs(out32[i] - ref).max())
        elif not np.array_equal(out32[i].astype(ref.dtype), ref):
            raise AssertionError(f"f32 speculative decode: {name} differ from greedy")
    rounds32 = out32[5]["rounds"]
    print(f"  f32 (weights {gib(tree_bytes(p32)):.2f} GiB): speculative k {SPEC_K} equals graphed "
          f"greedy (tokens, validity, counts; pooled max abs diff {diff32:.3g}); {rounds32} rounds, "
          f"{(n - 1) / rounds32:.3f} tokens a forward; {8 * (n - 1) / (t_s32 - t1_32):.1f} tokens/s "
          f"against greedy's {8 * (n - 1) / (t_g32 - t1_32):.1f}", flush=True)
    # the oracle drafter on greedy's own tokens: acceptance 1, the ceiling
    oracle32 = torch.from_numpy(res32.tokens).long().to(DEVICE)
    spec(p32, c32, "oracle", oracle32)
    t_o32, orc32 = spec(p32, c32, "oracle", oracle32)
    if not np.array_equal(orc32[0].astype(np.int32), res32.tokens):
        raise AssertionError("f32 speculative decode, oracle drafter: tokens differ from greedy")
    rounds = orc32[5]["rounds"]
    print(f"  f32 speculative k {SPEC_K}, oracle drafter (greedy's tokens): equals greedy; "
          f"{rounds} rounds, {(n - 1) / rounds:.3f} tokens a forward; "
          f"{8 * (n - 1) / (t_o32 - t1_32):.1f} tokens/s", flush=True)
    del p32
    GRAPHS.clear()
    torch.cuda.empty_cache()

    greedy = graphed["bf16"]
    t1 = t_prefill["bf16"]
    oracle = torch.from_numpy(greedy.tokens).long().to(DEVICE)
    for drafter, orc in (("prompt", None), ("oracle", oracle)):
        spec(params, cfg, drafter, orc)
        t_s, out = spec(params, cfg, drafter, orc)
        rows = (out[0].astype(np.int32) == greedy.tokens).all(axis=1)
        differ = np.argwhere(out[0].astype(np.int32) != greedy.tokens)
        first = int(differ[:, 1].min()) if len(differ) else None
        rounds = out[5]["rounds"]
        print(f"  bf16 speculative k {SPEC_K}, {drafter} drafter: {int(rows.sum())} of 8 rows equal "
              f"to graphed greedy (first differing position {first}); {rounds} rounds, "
              f"{(n - 1) / rounds:.3f} tokens a forward; {8 * (n - 1) / (t_s - t1):.1f} tokens/s",
              flush=True)
    GRAPHS.clear()

    # seeded sampling: repeats under one seed, graphed equals eager
    sampling = SamplingConfig(do_sample=True, top_k=40, top_p=0.9, temperature=0.7,
                              freq_penalty=0.5)
    _, a, _ = run(params, cfg, sampling=sampling, seed=3)
    t_b, b, _ = run(params, cfg, sampling=sampling, seed=3)
    _, e, _ = run(params, cfg, sampling=sampling, seed=3, eager=True)
    _, other, _ = run(params, cfg, sampling=sampling, seed=4)
    same(a, b, "sampled decode, one seed twice")
    same(a, e, "sampled decode, graph vs eager")
    if np.array_equal(a.tokens, other.tokens):
        raise AssertionError("sampled decode: seeds 3 and 4 gave the same tokens")
    print(f"  sampled (top_k 40, top_p 0.9, temperature 0.7, freq_penalty 0.5): seed 3 twice and "
          f"eager equal, seed 4 differs; {8 * (n - 1) / (t_b - t1):.1f} tokens/s graphed",
          flush=True)
    GRAPHS.clear()
    torch.cuda.empty_cache()

    # the probing loop with speculative decode
    retriever = TimedRetriever(engine)
    rag = RAGConfig(retr_method="probing", threshold=1e6, top_k=K, max_new_tokens=150,
                    batch_size=8, spec_k=SPEC_K)
    pipe = AdaptiveRAGPipeline(params, cfg, tok, retriever, store, probers, rag)
    kernels.reset_launches()
    sync()
    t0 = time.time()
    result = pipe.run(questions)
    sync()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"  spec_k {SPEC_K} probing loop over {len(questions)} questions: {wall:.1f}s wall, of "
          f"which BM25 search {retriever.seconds:.3f}s ({len(retriever.calls)} calls); retr_count "
          f"{result.retr_count_list}; kernel launches {launches}", flush=True)
    if result.retr_count_list != [3] * len(questions):
        raise AssertionError(f"spec loop: retr_count {result.retr_count_list} != all 3")
    missing = [name for name in BM25_KERNELS + ("decode_attention", "prefill_attention")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the spec loop's path: {missing}")
    GRAPHS.clear()
    torch.cuda.empty_cache()
    return launches


# phase 10: the JAX package's separable prober task (its tests/test_prober.py)
# at Gemma-2B width: 24 + 24 examples, the default 12 sites, max_len 1536,
# batch 8, 2 epochs, that test's learning rate
TRAIN_EACH, TRAIN_LR, TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_MAX_LEN = 24, 3e-3, 2, 8, 1536
NO_ANSWER = "zzyzx"  # a gold answer that no generation holds
# the kernels dataset-make's searches launch (the questions' rows stay
# under max_pad: no over-cap hybrid)
DATASET_KERNELS = ("bm25_gather", "bitonic_sort", "bitonic_sort_wide", "segment_topk")


def separable_examples():
    """The JAX prober test's examples whose label is readable from the
    text, alternating labels."""
    from probing_rag_tpu_torch.prober.train import ProberExample

    pos = [ProberExample("question alpha", "yes yes yes yes", 1) for _ in range(TRAIN_EACH)]
    neg = [ProberExample("question beta", "no no no no no", 0) for _ in range(TRAIN_EACH)]
    return [x for pair in zip(pos, neg) for x in pair]


def tree_to(tree, device):
    return {m: {k: v.detach().to(device).clone() for k, v in sub.items()} for m, sub in tree.items()}


def phase_prober_training(lm, index, questions, results: dict) -> dict:
    """The paper's phases 2 and 3 and the offline evaluation at Gemma-2B
    width on phase 5's bf16 weights, byte tokenizer and the phase-4 BM25
    index, through the functions the CLI's ``dataset-make``,
    ``prober-train``, ``prober-eval`` and ``rag-run --probers`` call:

    - dataset-make: ``extract_cot_dataset`` over the 16 loop questions in
      ``none`` and ``simple`` mode (graphed decode, 150 tokens; simple mode
      searches through the BM25 kernels, each launched). With random
      weights no gold answer is right by chance, so the golds come from a
      first ``none`` run: the even questions take the last word of their
      own answer block (greedy decode repeats it, so their ``none`` rows
      are labelled 1), the odd ones a word no block holds (0); the
      ``none`` labels must be exactly that alternation, which holds the
      row-to-label alignment. The rows are saved, loaded back (equal) and
      merged by ``balance_and_merge``.
    - ``train_probers`` on the separable task at the default 12 sites,
      max_len 1536, batch 8, 2 epochs, lr 3e-3: the best site's dev
      accuracy must exceed 0.9. The trained stack is held against its own
      init (the stack the seed draws) on the dev rows: every site's
      parameters moved by more than lr, the epoch-mean training loss fell,
      the dev loss fell on the mean over sites, and at least one site that
      the init held at or below 0.9 ends above 0.9. Printed: the capture forward's seconds a batch, the prober
      step's ms, examples/s, peak memory, the per-epoch losses, and the
      init's and the trained stack's dev accuracy and loss by site.
    - one train step (dropout off) on one batch's captures, on the card
      and on the CPU in f32 from the same init: per-site losses rtol 1e-4;
      gradients rtol 1e-3, atol 1e-5 of each leaf's largest; updated
      parameters all within 2 lr (Adam's first step is g / (|g| + 1e-8):
      an element whose gradient is near zero may step either way) and all
      but 0.01% within 1e-5.
    - the trained stack saved with ``save_pytree``, read back by the CLI's
      ``_load_probers`` (the gate's resid_post rows, equal), gating one
      probing-loop batch of 8 at threshold 0; ``prober_offline_eval`` over
      the balanced rows, its logits against the same logits on the CPU
      from the card's pooled captures (rtol 1e-4, atol 1e-4).
    - the capture forward with int8 weights (``--quantize int8``):
      matmul_int8 launched 7 times a layer plus the head's, and the kernel
      at the capture's product [8 x 1536 x 2048 -> 16384] against its
      plain version, its bound and ``torch._weight_int8pack_mm``.

    Returns each part's kernel launch counts."""
    import tempfile
    from dataclasses import astuple
    from pathlib import Path

    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.cli.main import _load_probers, build_parser
    from probing_rag_tpu_torch.eval.analysis import prober_offline_eval
    from probing_rag_tpu_torch.eval.evaluator import extract_answer
    from probing_rag_tpu_torch.eval.metrics import normalize_answer
    from probing_rag_tpu_torch.models.gemma import quantize_lm_params
    from probing_rag_tpu_torch.pipeline.dataset_builder import (
        balance_and_merge, extract_cot_dataset, load_rows, save_rows)
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.prober import train as ptrain
    from probing_rag_tpu_torch.prober.gate import prober_ensemble_logits
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.utils.checkpoint import save_pytree

    params, cfg, _, tok, store = lm
    engine = BM25Engine(index, device=DEVICE)
    launches = {}

    def pipeline(method, probers=None, threshold=0.0):
        return AdaptiveRAGPipeline(params, cfg, tok, engine, store, probers, RAGConfig(
            retr_method=method, threshold=threshold, top_k=K, max_new_tokens=150, batch_size=8))

    def timed(fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        return out, time.time() - t0

    # dataset-make
    first, t_first = timed(lambda: pipeline("none").run(questions))
    golds = []
    for i, pred in enumerate(first.pred_list):
        words = normalize_answer(extract_answer(pred)[0]).split()
        golds.append([words[-1]] if i % 2 == 0 and words else [NO_ANSWER])
    kernels.reset_launches()
    rows, t_rows = timed(lambda: {m: extract_cot_dataset(pipeline(m), questions, golds, "nq")
                                  for m in ("none", "simple")})
    launches["dataset-make"] = dict(kernels.LAUNCHES)
    labels = {m: [r.acc for r in rs] for m, rs in rows.items()}
    print(f"  dataset-make over {len(questions)} questions: golds from a first none run "
          f"{t_first:.1f}s, none + simple rows {t_rows:.1f}s; labels {labels}; kernel "
          f"launches {launches['dataset-make']}", flush=True)
    want = [1 if i % 2 == 0 else 0 for i in range(len(questions))]
    if labels["none"] != want:
        raise AssertionError(f"none rows' labels {labels['none']} != {want}")
    missing = [n for n in DATASET_KERNELS if launches["dataset-make"][n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by dataset-make's searches: {missing}")
    with tempfile.TemporaryDirectory() as d:
        loaded = []
        for m, rs in rows.items():
            save_rows(rs, Path(d) / f"rows_{m}.csv")
            loaded.append(load_rows(Path(d) / f"rows_{m}.csv"))
            if [astuple(r) for r in loaded[-1]] != [astuple(r) for r in rs]:
                raise AssertionError(f"{m} rows changed through save_rows / load_rows")
    examples = balance_and_merge(loaded, seed=SEED)
    n_pos = sum(e.label for e in examples)
    print(f"  rows saved and loaded back equal; balance_and_merge: {len(examples)} examples, "
          f"{n_pos} labelled 1, {len(examples) - n_pos} labelled 0")
    if not 0 < n_pos < len(examples):
        raise AssertionError("the balanced rows do not hold both labels")

    # prober-train on the separable task
    tc = ptrain.ProberTrainConfig(layers=cfg.probe_layers, lr=TRAIN_LR, epochs=TRAIN_EPOCHS,
                                  batch_size=TRAIN_BATCH, max_len=TRAIN_MAX_LEN)
    train = separable_examples()
    dev = train[:16]
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the process's first torch.optim optimizer imports torch._dynamo: a
    # one-off, timed apart from the loop
    _, t_opt = timed(lambda: ptrain.make_optimizer(tc, ptrain.init_prober_stack(
        tc, 8, torch.Generator(device=DEVICE), device=DEVICE)))
    (stacked, history), t_train = timed(lambda: ptrain.train_probers(params, cfg, tok, train, dev, tc))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    dev_acc = [h["dev_acc"] for h in history if "dev_acc" in h]
    epoch_loss = [float(np.mean([h["losses"] for h in history if "losses" in h and h["epoch"] == e]))
                  for e in range(tc.epochs)]
    n_steps = sum("losses" in h for h in history)
    tokens, labels8, pred_lens = ptrain.tensorize_examples(train[:TRAIN_BATCH], tok, tc.max_len)
    capture = lambda p: ptrain.capture_activations(p, cfg, tokens, tc.sites, tok.pad_id)
    kernels.reset_launches()
    caps = capture(params)
    sync()
    if kernels.LAUNCHES["prefill_attention"] != cfg.n_layers:
        raise AssertionError(f"the capture forward launched prefill_attention "
                             f"{kernels.LAUNCHES['prefill_attention']} times, not {cfg.n_layers}")
    block = {name: kernels.LAUNCHES[name] for name in BLOCK_KERNELS}
    if list(block.values()) != [2 * cfg.n_layers + 1, cfg.n_layers, cfg.n_layers]:
        raise AssertionError(f"the capture forward launched the block's kernels {block} times")
    launches["capture"] = {"prefill_attention": cfg.n_layers, **block}
    capture_s = cuda_ms(lambda: capture(params), reps=3) / 1e3
    with PlainAttention():
        caps_plain = capture(params)
        capture_plain_s = cuda_ms(lambda: capture(params), reps=3) / 1e3
    cap_rel = float((caps - caps_plain).norm() / caps_plain.norm())
    with PlainBlock():
        caps_plain = capture(params)
        capture_block_s = cuda_ms(lambda: capture(params), reps=3) / 1e3
    cap_rel_block = float((caps - caps_plain).norm() / caps_plain.norm())
    del caps_plain
    lab = torch.as_tensor(labels8, dtype=torch.int64, device=DEVICE)
    pl = torch.as_tensor(pred_lens, dtype=torch.int64, device=DEVICE)
    scratch = tree_to(stacked, DEVICE)
    scratch_state = ptrain.make_optimizer(tc, scratch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    step_ms = cuda_ms(lambda: ptrain.prober_train_step(scratch, scratch_state, caps, lab, pl, gen,
                                                       tc=tc))
    print(f"  train_probers: {len(tc.sites)} sites, {len(train)} examples x {tc.epochs} epochs "
          f"({n_steps} steps of {tc.batch_size}, max_len {tc.max_len}) + dev {len(dev)} each "
          f"epoch: {t_train:.1f}s (after the first make_optimizer's {t_opt:.1f}s), "
          f"{len(train) * tc.epochs / t_train:.1f} training examples/s; "
          f"capture forward [{tc.batch_size} x {tc.max_len}] -> [{len(tc.sites)}, "
          f"{tc.batch_size}, {tc.max_len}, {cfg.d_model}] f32 {capture_s:.3f}s a batch through "
          f"prefill_attention ({cfg.n_layers} launches) and the block's kernels ({block}), "
          f"{capture_plain_s:.3f}s with plain attention (captures' relative difference "
          f"{cap_rel:.3g}), {capture_block_s:.3f}s with the block's plain ops (relative "
          f"difference {cap_rel_block:.3g}); prober "
          f"step {step_ms:.3f} ms; peak {peak / 2**30:.2f} GiB; mean loss by epoch "
          f"{[round(l, 4) for l in epoch_loss]}; dev accuracy by epoch {dev_acc}", flush=True)
    if max(dev_acc[-1]) <= 0.9:
        raise AssertionError(f"probers failed to fit the separable task: {dev_acc[-1]}")
    del scratch, scratch_state

    # the trained stack against its own init on the dev rows
    init0 = ptrain.init_prober_stack(tc, cfg.d_model, torch.Generator(device=DEVICE).manual_seed(
        tc.seed), device=DEVICE)
    moved = torch.stack([(a - b).abs().flatten(1).amax(1) for a, b in
                         zip(ptrain.stack_leaves(stacked), ptrain.stack_leaves(init0))]).amax(0)
    scores = {"init": [0, 0], "trained": [0, 0]}
    dev_batches = range(0, len(dev), tc.batch_size)
    for start in dev_batches:
        tk, lb, pls = ptrain.tensorize_examples(dev[start:start + tc.batch_size], tok, tc.max_len)
        c = ptrain.capture_activations(params, cfg, tk, tc.sites, tok.pad_id)
        lb, pls = (torch.as_tensor(x, dtype=torch.int64, device=DEVICE) for x in (lb, pls))
        for name, stack in (("init", init0), ("trained", stacked)):
            n_right, loss = ptrain.prober_eval_step(stack, c, lb, pls, tc=tc)
            scores[name] = [scores[name][0] + n_right, scores[name][1] + loss]
    acc0, acc1 = ((scores[k][0] / len(dev)).cpu().numpy() for k in ("init", "trained"))
    loss0, loss1 = ((scores[k][1] / len(dev_batches)).cpu().numpy() for k in ("init", "trained"))
    print(f"  trained stack vs its init on the {len(dev)} dev rows, by site: accuracy "
          f"{acc0.round(3).tolist()} -> {acc1.round(3).tolist()}; loss "
          f"{loss0.astype(float).round(4).tolist()} -> {loss1.astype(float).round(4).tolist()}; "
          f"parameters moved at most {moved.double().cpu().numpy().round(5).tolist()} "
          f"(lr {tc.lr})", flush=True)
    if not bool((moved > tc.lr).all()):
        raise AssertionError(f"train_probers left a site's parameters within lr of the init: {moved}")
    if not epoch_loss[-1] < epoch_loss[0]:
        raise AssertionError(f"the epoch-mean training loss did not fall: {epoch_loss}")
    if not loss1.mean() < loss0.mean():
        raise AssertionError(f"the mean dev loss did not fall with training: {loss0} -> {loss1}")
    if not ((acc0 <= 0.9) & (acc1 > 0.9)).any():
        raise AssertionError(f"training fit no site the init did not: {acc0} -> {acc1}")
    del init0, c

    # one train step on the card against the same step on the CPU
    init = ptrain.init_prober_stack(tc, cfg.d_model, gen, device=DEVICE)
    init_cpu = tree_to(init, "cpu")
    caps_cpu = caps.cpu()
    card_losses, card_grads = ptrain.site_losses_and_grads(init, caps, lab, pl, None, tc)
    cpu_losses, cpu_grads = ptrain.site_losses_and_grads(init_cpu, caps_cpu, lab.cpu(), pl.cpu(),
                                                         None, tc)
    card, _, step_losses = ptrain.prober_train_step(init, ptrain.make_optimizer(tc, init), caps,
                                                    lab, pl, None, tc=tc)
    cpu, _, _ = ptrain.prober_train_step(init_cpu, ptrain.make_optimizer(tc, init_cpu), caps_cpu,
                                         lab.cpu(), pl.cpu(), None, tc=tc)
    loss_err = float(((card_losses.cpu() - cpu_losses) / cpu_losses).abs().max())
    if not torch.allclose(card_losses.cpu(), cpu_losses, rtol=1e-4, atol=0) \
            or not torch.allclose(step_losses, card_losses, rtol=1e-6, atol=0):
        raise AssertionError(f"train step losses, card {card_losses} vs CPU {cpu_losses}")
    grad_err = 0.0
    for g_card, g_cpu in zip(card_grads, cpu_grads):
        scale = float(g_cpu.abs().max())
        grad_err = max(grad_err, float((g_card.cpu() - g_cpu).abs().max()) / max(scale, 1e-30))
        if not torch.allclose(g_card.cpu(), g_cpu, rtol=1e-3, atol=1e-5 * scale):
            raise AssertionError("train step gradients differ between the card and the CPU")
    diff = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                      zip(ptrain.stack_leaves(card), ptrain.stack_leaves(cpu))])
    off = float((diff > 1e-5).float().mean())
    if float(diff.max()) > 2 * tc.lr or off > 1e-4:
        raise AssertionError(f"updated params: max diff {float(diff.max())}, {off} over 1e-5")
    print(f"  one train step, card vs CPU (f32, dropout off): losses max rel diff "
          f"{loss_err:.3g}, gradients max diff {grad_err:.3g} of each leaf's largest, updated "
          f"params max abs diff {float(diff.max()):.3g} ({off:.2e} of {diff.numel()} over 1e-5)",
          flush=True)
    del init, init_cpu, caps_cpu, card, cpu, card_grads, cpu_grads

    # the trained stack through the CLI's reader, gating one loop batch
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "probers"
        save_pytree(path, stacked, meta={"sites": [list(s) for s in tc.sites],
                                         "method": tc.method, "model_id": "google/gemma-2b"})
        args = build_parser().parse_args(["rag-run", "--dataset", "nq", "--index", d,
                                          "--probers", str(path), "--device", DEVICE])
        gate = _load_probers(args, cfg)
    for m, sub in gate.items():
        for k, v in sub.items():
            if not torch.equal(v, stacked[m][k][1::2]):
                raise AssertionError(f"_load_probers {m}/{k} is not the checkpoint's resid_post rows")
    kernels.reset_launches()
    res, t_loop = timed(lambda: pipeline("probing", gate).run(questions[:8]))
    launches["probing batch"] = dict(kernels.LAUNCHES)
    for sc in res.gate_scores:
        if sc is None or not np.isfinite(sc).all() or abs(float(sc.sum()) - len(gate["fc1"]["w"])) > 1e-3:
            raise AssertionError(f"trained gate scores {sc} are not softmax sums")
    print(f"  trained stack saved, read by the CLI's _load_probers (resid_post rows equal), "
          f"gating 8 questions at threshold 0: {t_loop:.1f}s, retr_count {res.retr_count_list}, "
          f"kernel launches {launches['probing batch']}", flush=True)

    # prober-eval over the balanced rows, against the CPU
    offline, t_eval = timed(lambda: prober_offline_eval(params, cfg, tok, examples, stacked, tc,
                                                        collect_logits=True))
    stack_cpu = tree_to(stacked, "cpu")
    ref = []
    for start in range(0, len(examples), 8):
        tk, _, pls = ptrain.tensorize_examples(examples[start:start + 8], tok, tc.max_len)
        c = ptrain.capture_activations(params, cfg, tk, tc.sites, tok.pad_id)
        pooled = ptrain.pool_sum_answer_tokens(c, torch.as_tensor(pls, device=DEVICE))
        ref.append(prober_ensemble_logits(stack_cpu, pooled.cpu()).numpy().transpose(1, 0, 2))
    ref = np.concatenate(ref)
    if offline.logits.shape != ref.shape or not np.allclose(offline.logits, ref, rtol=1e-4, atol=1e-4):
        raise AssertionError("prober_offline_eval's logits differ from the CPU's")
    print(f"  prober_offline_eval over {offline.n_examples} rows: {t_eval:.1f}s; site accuracy "
          f"{np.round(offline.site_accuracy, 3).tolist()}; logits vs the CPU max abs diff "
          f"{float(np.abs(offline.logits - ref).max()):.3g}", flush=True)

    # the capture forward with int8 weights
    q8, t_q = timed(lambda: quantize_lm_params(params, bits=8))
    kernels.reset_launches()
    caps8 = capture(q8)
    sync()
    launches["capture int8"] = dict(kernels.LAUNCHES)
    n_mm = launches["capture int8"]["matmul_int8"]
    if n_mm != 7 * cfg.n_layers + 1:
        raise AssertionError(f"int8 capture forward launched matmul_int8 {n_mm} times")
    rel = float((caps8 - caps).norm() / caps.norm())
    capture8_s = cuda_ms(lambda: capture(q8), reps=3) / 1e3
    del caps8, caps, q8
    r = mm_case(torch.Generator(device=DEVICE).manual_seed(SEED + 41), "capture w_gate/w_up",
                TRAIN_BATCH * TRAIN_MAX_LEN, *GEMMA_MM["w_gate/w_up"], False, torch.bfloat16,
                "wgmma", yardsticks=True)
    results.setdefault("matmul_int8", {}).update(
        capture_ms=r["ms"], capture_plain_ms=r["plain_ms"], capture_bound_ms=r["bound_ms"],
        capture_library_ms=r["library_ms"], capture_launches=n_mm)
    print(f"  int8 capture forward (quantized in {t_q:.1f}s): matmul_int8 launched {n_mm} times, "
          f"{capture8_s:.3f}s a batch (bf16 {capture_s:.3f}s); captures' relative difference "
          f"from bf16 {rel:.3g}", flush=True)
    return launches


# phase 11: bench_baselines.py's setup (MAX_NEW 64, its demo), 8 questions
# of four Zipf terms; the tiny f32 model's card-vs-CPU runs take 2 questions
BASE_MAX_NEW = 64
BASE_QUESTIONS = 8
BASE_DEMO = "Question: t1 t2?\nAnswer: t3.\n\n"
TINY_CORPUS = [
    "paris is the capital of france",
    "berlin is the capital city of germany",
    "george washington was the first president of the united states",
]
TINY_QUESTIONS = ["capital of france?", "who was the first president?"]
# drift of the bf16 trace from the same forward with the weights upcast to
# f32, per word, as a share of the f32 values' largest magnitude
TRACE_DRIFT = {"attention": 0.05, "entropy": 0.01, "logprob": 0.01}
# parity chain artifacts, as tests/test_cli_parity.py lists them
PARITY_FILES = ("index_nq/bm25/manifest.json", "index_trivia/docstore.json", "rows_simple.csv",
                "rows_none.csv", "result/runs.jsonl", "report/report.md")


class ZipfWordTokenizer:
    """Whole words over the full Gemma vocabulary, after bench_e2e.py's
    HashWordTokenizer: the corpus's terms ``t0``..``t{VOCAB - 1}`` are ids
    3.., any other word hashes above them, and an id decodes to ``"
    t{(id - 3) % VOCAB}"``, so a random model's generations are corpus
    terms that re-enter retrieval, a word to a token."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.bos_id = 1
        self.eos_id = self.pad_id = 2  # pad = eos, as the reference sets it

    def encode(self, text: str, add_bos: bool = False):
        import zlib

        ids = []
        for w in text.split():
            if w[:1] == "t" and w[1:].isdigit() and int(w[1:]) < VOCAB:
                ids.append(3 + int(w[1:]))
            else:
                ids.append(3 + VOCAB + zlib.crc32(w.encode()) % (self.vocab_size - 3 - VOCAB))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        return "".join(f" t{(i - 3) % VOCAB}" for i in ids if i >= 3)

    def token_strings(self):
        return [""] * self.vocab_size  # no paragraph stop


def baseline_methods():
    """(label, class, constructor keywords) of the four retrieval
    baselines, as the reference runs them."""
    from probing_rag_tpu_torch.pipeline import baselines as tb

    return (("dragin", tb.DraginRAG, {}), ("flare", tb.FlareRAG, {}),
            ("fix-length", tb.FixLengthRAG, dict(method="fix-length-retrieval")),
            ("fix-sentence", tb.FixLengthRAG, dict(method="fix-sentence")))


def captures_since(before: dict) -> tuple:
    from probing_rag_tpu_torch.models import graphs

    return (int(graphs.CAPTURES["count"] - before["count"]),
            graphs.CAPTURES["seconds"] - before["seconds"])


def stacked_results(results, k: int):
    """One search result over every call's rows."""
    import numpy as np
    from types import SimpleNamespace

    return SimpleNamespace(scores=np.concatenate([r.scores[:, :k] for r in results]),
                           doc_indices=np.concatenate([r.doc_indices[:, :k] for r in results]))


def phase_baselines_at_width(lm, index) -> None:
    """The comparison baselines at Gemma-2B width on phase 5's bf16 weights
    over the phase-4 BM25 index, with the word tokenizer: DRAGIN, FLARE,
    fix-length and fix-sentence at batch 1 (one query at a time, as the
    reference runs them) over the same 8 questions, then the LLM
    classifier gate on them at batch 8. Per method: queries/s, retrieval
    calls per query, generate calls, tokens, hallucination triggers, graph
    captures and their seconds, the BM25 kernels' launches and peak GiB.
    Holds that every method retrieved, that each search launched one
    segment top-k (and one bitonic gather when it was not routed to the
    over-cap hybrid), and that every query searched gives the CPU
    engine's top-k. Then one trace at width: the bf16 ``forward_with_attn``
    probs (rows sum to 1, nothing above the diagonal) and the per-word
    attention, entropy and logprob against the same trace with the
    weights upcast to f32, within ``TRACE_DRIFT``."""
    import dataclasses

    import numpy as np
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models import graphs
    from probing_rag_tpu_torch.pipeline import baselines as tb
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    params, cfg, _, _, store = lm
    tok = ZipfWordTokenizer(cfg.vocab_size)
    engine = BM25Engine(index, device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    qz = zipf_tokens(rng, BASE_QUESTIONS * 4).reshape(BASE_QUESTIONS, 4) % VOCAB
    questions = [" ".join(f"t{t}" for t in row) for row in qz]
    bc = tb.BaselineConfig(generate_max_length=BASE_MAX_NEW)
    searched = []
    for label, cls, kw in baseline_methods():
        retriever = TimedRetriever(engine)
        rag = cls(params, cfg, tok, retriever, store, bc, **kw)
        caps0 = dict(graphs.CAPTURES)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        sync()
        t0 = time.time()
        for q in questions:
            rag.inference(q, BASE_DEMO, f"Question: {q}\nAnswer:")
        sync()
        wall = time.time() - t0
        launches = {n: kernels.LAUNCHES[n] for n in BM25_KERNELS}
        n_cap, cap_s = captures_since(caps0)
        c = rag.counter
        n = len(questions)
        peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0
        print(f"  {label}: {n / wall:.3f} queries/s ({wall:.2f}s for {n}, batch 1); retrieval "
              f"calls {c.retrieve} ({c.retrieve / n:.2f} a query), generate calls {c.generate}, "
              f"tokens {c.token}, sentences {c.sentence}, hallucination triggers "
              f"{c.hallucinated}; graph captures {n_cap} in {cap_s:.3f}s "
              f"({cap_s / wall:.1%} of the wall); BM25 search {retriever.seconds:.3f}s; "
              f"launches {launches}; peak {peak:.2f} GiB")
        bitonic = sum(1 for st in retriever.stats if st["n_fallback"] == 0)
        if c.retrieve == 0 or len(retriever.calls) != c.retrieve:
            raise AssertionError(f"{label}: {c.retrieve} retrievals, {len(retriever.calls)} searches")
        if launches["segment_topk"] != c.retrieve or launches["bm25_gather"] != bitonic:
            raise AssertionError(f"{label}: launches {launches} do not match {c.retrieve} searches "
                                 f"({bitonic} on the bitonic path)")
        searched.append((label, retriever))
        del rag

    gate = tb.LLMClassifierGate(params, cfg, tok)
    caps0 = dict(graphs.CAPTURES)
    sync()
    t0 = time.time()
    needs = gate.needs_retrieval(questions)
    sync()
    wall = time.time() - t0
    n_cap, cap_s = captures_since(caps0)
    if len(needs) != len(questions) or not all(isinstance(b, bool) for b in needs):
        raise AssertionError(f"LLM gate gave {needs}")
    print(f"  llm gate: {len(questions) / wall:.3f} queries/s ({wall:.2f}s, batch 8, 4 new "
          f"tokens); retrieval wanted for {sum(needs)} of {len(questions)}; graph captures "
          f"{n_cap} in {cap_s:.3f}s")

    cpu_engine = BM25Engine(index, device="cpu")
    for label, retriever in searched:
        queries = [q for call in retriever.calls for q in call]
        ref = cpu_engine.search(queries, k=K + 1)
        assert_same_topk(stacked_results(retriever.results, K), ref,
                         f"{label}'s searches against the CPU engine")
        widths = [len(q.split()) for q in queries]
        print(f"  {label}: {len(queries)} searches ({min(widths)}-{max(widths)} words, "
              f"{sum(st['n_fallback'] for st in retriever.stats)} over-cap) equal to the CPU engine")
    del cpu_engine

    # one trace at width: the bf16 forward against the same forward upcast to f32
    prompt = BASE_DEMO + f"Question: {questions[0]}\nAnswer:"
    _, res = tb._generate_one(params, cfg, tok, prompt, BASE_MAX_NEW)
    gen_ids = [int(t) for t in res.tokens[0, : int(res.n_generated[0])]]
    ids, valid = tb._ids_tensor(params, gen_ids)
    _, _, _, probs = tb.forward_with_attn(params, ids, valid, cfg)
    p = probs[0].cpu().numpy()
    row_err = float(np.abs(p.sum(-1) - 1.0).max())
    above = float(np.triu(p, 1).max())
    if row_err > 1e-4 or above != 0.0:
        raise AssertionError(f"trace probs: rows sum to 1 within {row_err}, {above} above the diagonal")
    got = tb.trace_ids(params, cfg, tok, gen_ids)
    p32 = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    want = tb.trace_ids(p32, dataclasses.replace(cfg, compute_dtype=torch.float32), tok, gen_ids)
    del p32
    if got[0] != want[0]:
        raise AssertionError("trace words differ between bf16 and f32")
    drift = {}
    for (name, bound), g, w in zip(TRACE_DRIFT.items(), got[1:], want[1:]):
        g, w = np.asarray(g), np.asarray(w)
        drift[name] = float(np.abs(g - w).max() / np.abs(w).max())
        if not drift[name] <= bound:
            raise AssertionError(f"trace {name} drifts {drift[name]:.3g} of its largest, over {bound}")
    print(f"  trace of {len(gen_ids)} tokens at width: probs [{p.shape[0]}, {p.shape[1]}, "
          f"{p.shape[2]}] f32, rows sum to 1 within {row_err:.2g}, zero above the diagonal; bf16 vs "
          f"f32 weights, largest drift as a share of the largest value: "
          + ", ".join(f"{k} {v:.3g} (bound {TRACE_DRIFT[k]})" for k, v in drift.items())
          + f"; entropy {np.mean(want[2]):.3f}, logprob {np.mean(want[3]):.3f} on the mean")


def run_tiny_baselines(params, cfg, device):
    """Each method over ``TINY_QUESTIONS`` and the gate, with the tiny
    model on ``device``: ([(answers, counters)] per method, gate)."""
    import dataclasses

    from probing_rag_tpu_torch.data.corpus import DocStore
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.pipeline import baselines as tb
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

    index = BM25Index.build(TINY_CORPUS, BM25Config(stem=False, remove_stopwords=False))
    engine, store = BM25Engine(index, device=device), DocStore.from_texts(TINY_CORPUS)
    tok = ByteTokenizer(cfg.vocab_size)
    fields = {"dragin": dict(hallucination_threshold=0.5), "flare": dict(flare_threshold=0.99)}
    out = []
    for label, cls, kw in baseline_methods():
        bc = tb.BaselineConfig(generate_max_length=16, max_rounds=2, **fields.get(label, {}))
        answers, counters = [], []
        for q in TINY_QUESTIONS:
            rag = cls(params, cfg, tok, engine, store, bc, **kw)
            answers.append(rag.inference(q, "demo\n", f"Question: {q}"))
            counters.append(dataclasses.asdict(rag.counter))
        out.append((label, answers, counters))
    gate = tb.LLMClassifierGate(params, cfg, tok, max_new_tokens=2).needs_retrieval(TINY_QUESTIONS)
    return out, gate


def phase_tiny_baselines() -> None:
    """Each baseline on the tiny f32 model (the CPU tests' setup: byte
    tokenizer, three-sentence corpus), on the card and on the CPU: answer
    texts and counters equal, the gate's decisions too."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_params

    cfg = dataclasses.replace(GemmaConfig.tiny(), compute_dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    card = {k: ({n: w.to(DEVICE) for n, w in v.items()} if isinstance(v, dict) else v.to(DEVICE))
            for k, v in cpu.items()}
    got, got_gate = run_tiny_baselines(card, cfg, DEVICE)
    want, want_gate = run_tiny_baselines(cpu, cfg, "cpu")
    for (label, answers, counters), (_, w_answers, w_counters) in zip(got, want):
        if answers != w_answers or counters != w_counters:
            raise AssertionError(f"tiny {label} on the card {answers} {counters} != CPU "
                                 f"{w_answers} {w_counters}")
    if got_gate != want_gate:
        raise AssertionError(f"tiny LLM gate on the card {got_gate} != CPU {want_gate}")
    print("  tiny f32 model, card vs CPU: answers and counters equal for "
          + "; ".join(f"{label} (retrieve {[c['retrieve'] for c in counters]})"
                      for label, _, counters in got) + f"; gate {got_gate}")


def phase_cli_chain() -> None:
    """``parity`` (tiny model, fixture corpus, ``--device``), ``rag-sweep``
    over its index at thresholds -1e6 and 1e6, and ``analyze --report``
    without figures, through the CLI's ``main``: every artifact of the
    parity drill, the BM25 kernels launched, and the two thresholds giving
    the lowest and the highest mean retrieval steps."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.cli.main import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "parity"
        kernels.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli(["parity", "--device", DEVICE, "--workdir", str(work), "--datasets", "nq,trivia",
                 "--steps-limit", "4", "--max-new-tokens", "8", "--batch-size", "2",
                 "--epochs", "1"])
        parity_s = time.time() - t0
        launches = {n: kernels.LAUNCHES[n] for n in BM25_KERNELS}
        missing = [f for f in PARITY_FILES if not (work / f).exists()]
        if missing or not any((work / "probers").glob("probers*")):
            raise AssertionError(f"parity left no {missing or 'probers'}")
        if "parity drill complete" not in out.getvalue():
            raise AssertionError("parity did not complete")
        if not all(launches[n] for n in ("bm25_gather", "segment_topk")):
            raise AssertionError(f"parity launched {launches}")
        print(f"  parity --device {DEVICE}: {parity_s:.1f}s, every artifact there; BM25 "
              f"launches {launches}")

        sweep = ["rag-sweep", "--device", DEVICE, "--dataset", "nq", "--fixture-qa",
                 str(work / "qa.json"), "--index", str(work / "index_nq"), "--max-new-tokens",
                 "8", "--batch-size", "2", "--probers", str(work / "probers" / "probers"),
                 "--thresholds=-1e6,0,1e6"]
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli(sweep)
        rows = [line.split() for line in out.getvalue().strip().splitlines()[1:]]
        steps = {float(r[0]): float(r[5]) for r in rows}
        if sorted(steps) != [-1e6, 0.0, 1e6] or steps[-1e6] != min(steps.values()) \
                or steps[1e6] != max(steps.values()) or steps[-1e6] == steps[1e6]:
            raise AssertionError(f"rag-sweep avg_steps {steps}")
        print(f"  rag-sweep: {time.time() - t0:.1f}s, avg_steps by threshold {steps}")

        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli(["analyze", "--runs", str(work / "result" / "runs.jsonl"),
                 "--report", str(Path(tmp) / "report")])
        report = (Path(tmp) / "report" / "report.md").read_text()
        if "| probing | nq |" not in report or "report ->" not in out.getvalue():
            raise AssertionError("analyze --report wrote no run table")
        print(f"  analyze --report (no figures): report.md of {len(report.splitlines())} lines")


def phase_quantized_init() -> None:
    """``init_quantized_lm_params`` at Gemma-2B width on the card: bit-equal
    to ``quantize_lm_params(init_params(...))`` from the same seed, the
    peak of each way, and one generate call on it launching
    ``matmul_int8``."""
    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import generate
    from probing_rag_tpu_torch.models.gemma import (
        GemmaConfig, init_params, init_quantized_lm_params, param_count, quantize_lm_params)

    cfg = GemmaConfig.gemma_2b()

    def peak_of(fn):
        sync()
        base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        tree = fn()
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if DEVICE == "cuda" else 0.0
        return tree, peak, time.time() - t0

    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    ref, ref_peak, ref_s = peak_of(lambda: quantize_lm_params(
        init_params(cfg, gen(), device=DEVICE, dtype=torch.bfloat16)))
    got, got_peak, got_s = peak_of(lambda: init_quantized_lm_params(cfg, gen(), device=DEVICE))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    ref_leaves = dict(leaves(ref))
    got_leaves = dict(leaves(got))
    if list(got_leaves) != list(ref_leaves):
        raise AssertionError(f"leaves {list(got_leaves)} != {list(ref_leaves)}")
    for name, r in ref_leaves.items():
        if got_leaves[name].dtype != r.dtype or not torch.equal(got_leaves[name], r):
            raise AssertionError(f"init_quantized_lm_params {name} differs from quantize-of-init")
    del ref, ref_leaves
    n_bytes = sum(v.numel() * v.element_size() for v in got_leaves.values())
    print(f"  init_quantized_lm_params (int8, {param_count(got) / 1e9:.3f}B elements, "
          f"{n_bytes / 2**30:.2f} GiB) bit-equal to quantize_lm_params(init_params(bf16)); peak "
          f"{got_peak:.2f} GiB in {got_s:.1f}s, against {ref_peak:.2f} GiB in {ref_s:.1f}s")
    kernels.reset_launches()
    tok = ZipfWordTokenizer(cfg.vocab_size)
    texts, res = generate(got, cfg, tok, [BASE_DEMO + "Question: t200 t300?\nAnswer:"],
                          max_new_tokens=8)
    launches = kernels.LAUNCHES["matmul_int8"]
    if launches == 0 or int(res.n_generated[0]) == 0:
        raise AssertionError(f"generate on init_quantized weights: {launches} matmul_int8 launches")
    print(f"  generate on those weights: {int(res.n_generated[0])} tokens, matmul_int8 "
          f"launched {launches} times")


def phase_baselines(lm, index) -> None:
    """Phase 11: the baselines at width, on the tiny model against the CPU,
    the CLI chain and the quantized init."""
    phase_baselines_at_width(lm, index)
    phase_tiny_baselines()
    phase_cli_chain()
    phase_quantized_init()


# ---------------------------------------------------------------- phase 12
# the sharded paths and tensor parallelism, ranks sharing the one card over
# gloo: they show that the sharded answers equal the single-device ones on
# the card, through its kernels, at full size; they say nothing of scaling
PAR_MESH = (2, 2)  # four ranks: the retrieval shards
PAR_K = 10
PAR_DENSE_SEED, PAR_IVF_SEED, PAR_TOKENS_SEED = SEED + 40, SEED + 41, SEED + 42
TP_MESH = (1, 2)  # two ranks: tp 2
TP_BATCH, TP_SEQ, TP_DECODE = 8, 512, 32
# the TP forward's logit drift from the unsharded forward, and the bf16
# decode's logit gap where its tokens part, as a share of the largest logit
TP_DRIFT = 0.05
NO_SCALING = "ranks sharing one card: no scaling"


def nonzero(counts: dict) -> dict:
    """The kernels a run launched, with their counts."""
    return {name: n for name, n in counts.items() if n}


def launched(counts: dict, names, what: str) -> None:
    missing = [n for n in names if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")


def phase_native(index, docs_tokens, queries) -> None:
    """The C++ index builder over phase 7's texts (original Porter mode)
    against the numpy build, then the native ``QueryEncoder`` over the
    phase-4 queries rendered as text feeding ``BM25Engine.search_term_ids``
    on the card, against the analyzer path."""
    import numpy as np

    from probing_rag_tpu_torch import kernels, native
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

    t0 = time.time()
    so = native.build()
    print(f"  g++ build of {native.SRC.name}: {so.name} in {time.time() - t0:.1f}s")
    texts = [" ".join(d) for d in docs_tokens]
    cfg = BM25Config(stemmer_mode="original")
    t0 = time.time()
    nat = BM25Index.build_native(texts, cfg)
    nat_s = time.time() - t0
    t0 = time.time()
    ref = BM25Index.build(texts, cfg)
    ref_s = time.time() - t0
    if nat.vocab != ref.vocab:
        raise AssertionError("native build: vocab differs from the numpy build")
    for name in ("term_offsets", "postings_doc", "doc_lens"):
        if not np.array_equal(getattr(nat, name), getattr(ref, name)):
            raise AssertionError(f"native build: {name} differs from the numpy build")
    if not np.allclose(nat.postings_impact, ref.postings_impact, rtol=1e-6, atol=0):
        raise AssertionError("native build: impacts differ from the numpy build")
    print(f"  build_native over {len(texts)} texts (original mode): {nat_s:.2f}s, "
          f"{len(texts) / nat_s:.0f} docs/s; numpy build {ref_s:.2f}s, {len(texts) / ref_s:.0f} "
          f"docs/s; equal ({nat.n_terms} terms, {nat.nnz} postings)")
    names = {v: k for k, v in index.vocab.items()}
    qtexts = [" ".join(names[int(t)] for t in q) for q in queries]
    enc = native.QueryEncoder(nat.vocab)
    t0 = time.time()
    ids = enc.encode(qtexts)
    enc_s = time.time() - t0
    analyzer = cfg.analyzer()
    t0 = time.time()
    ids_py = [nat.encode_query(analyzer(q)) for q in qtexts]
    py_s = time.time() - t0
    if any(not np.array_equal(a, b) for a, b in zip(ids, ids_py)):
        raise AssertionError("QueryEncoder ids differ from the analyzer path")
    engine = BM25Engine(nat, device=DEVICE)
    kernels.reset_launches()
    res = engine.search_term_ids(ids, k=K)
    counts = dict(kernels.LAUNCHES)
    ref_res = engine.search(qtexts, k=K)
    if not (np.array_equal(res.doc_indices, ref_res.doc_indices)
            and np.array_equal(res.scores, ref_res.scores)):
        raise AssertionError("QueryEncoder search differs from the analyzer path's")
    launched(counts, ("bm25_gather", "segment_topk"), "QueryEncoder search")
    print(f"  QueryEncoder over {len(qtexts)} queries: {enc_s * 1e3:.1f} ms "
          f"({len(qtexts) / enc_s:.0f} q/s), analyzer path {py_s * 1e3:.1f} ms; ids equal; "
          f"BM25Engine.search_term_ids on the card equal to search(); launches {nonzero(counts)}")


def dense_corpus(dev):
    """Phase 12's flat store, drawn on the card from its seed (every rank
    draws the same)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(PAR_DENSE_SEED)
    return torch.randn((DENSE_N, DENSE_D), generator=gen, device=dev)


DENSE_STORES = (("ip bf16", "ip", "bf16"), ("l2 bf16", "l2", "bf16"), ("ip int8", "ip", "int8"))


def dense_store(rows, metric: str, kind: str):
    import torch

    from probing_rag_tpu_torch.ops.dense import prepare_dense_store

    if kind == "int8":
        return prepare_dense_store(rows, metric=metric, store_dtype=torch.int8)
    return prepare_dense_store(rows.to(torch.bfloat16), metric=metric, store_dtype=torch.bfloat16)


def rank_sync(dev) -> None:
    """``torch.cuda.synchronize`` on a rank's card (a rank reads its device
    from ``run_ranks``, not from ``DEVICE``)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_device() -> str:
    """Where phase 12's gloo ranks run: all on the one card."""
    return "cuda:0" if DEVICE == "cuda" else "cpu"


def _par_retrieval_rank(rank, world, dev, tmp, queries, overcap, dense_q, ivf_q):
    """One rank of the four: its BM25 shard (phase 4's queries, then phase
    3's over-cap batch), its flat dense rows, its IVF cells. Returns the
    merged results, seconds and this rank's kernel launches per search."""
    from pathlib import Path

    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.parallel import ShardedBM25Engine, ShardedIVFEngine, make_mesh
    from probing_rag_tpu_torch.parallel.mesh import mesh_shard
    from probing_rag_tpu_torch.parallel.sharded_dense import shard_rows, sharded_dense_topk
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index
    from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex

    mesh = make_mesh(PAR_MESH, dev.type)
    shard, n_shards = mesh_shard(mesh)
    out = {"shard": shard}

    def timed(fn):
        kernels.reset_launches()
        rank_sync(dev)
        t0 = time.time()
        res = fn()
        rank_sync(dev)
        return res, time.time() - t0, dict(kernels.LAUNCHES)

    index = BM25Index.load(Path(tmp) / "bm25")
    eng, out["bm25_init_s"], _ = timed(lambda: ShardedBM25Engine(index, mesh, device=dev))
    for name, qs, k in (("bm25", queries, PAR_K), ("overcap", overcap, K)):
        res, s, counts = timed(lambda: eng.search_term_ids(qs, k=k))
        out[name] = (res.doc_indices, res.scores, dict(eng.last_stats), s, counts)
    del eng, index

    emb = dense_corpus(dev)
    offs, counts = shard_rows(DENSE_N, n_shards)
    rows = emb[int(offs[shard]): int(offs[shard] + counts[shard])].clone()
    del emb
    q = torch.from_numpy(dense_q).to(dev)
    for name, metric, kind in DENSE_STORES:
        store = dense_store(rows, metric, kind)
        (v, i), s, launches = timed(lambda: sharded_dense_topk(
            q, store, k=PAR_K, offset=int(offs[shard]), metric=metric))
        out["dense", name] = (v.cpu().numpy(), i.cpu().numpy(), s, launches)
    del rows, store

    ivf = IVFDenseIndex.load(Path(tmp) / "ivf")
    eng, out["ivf_init_s"], _ = timed(lambda: ShardedIVFEngine(ivf, mesh, nprobe=IVF_NPROBE,
                                                               device=dev))
    del ivf
    res, s, launches = timed(lambda: eng.search_embeddings(ivf_q, k=PAR_K))
    out["ivf"] = (res.doc_indices, res.scores, s, launches)
    return out


def phase_par_retrieval(index, queries) -> None:
    """Sharded BM25, flat dense and IVF over four ranks on the card (mesh
    (2, 2), gloo), each against the single engine on the card."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from probing_rag_tpu_torch.ops.dense import dense_topk
    from probing_rag_tpu_torch.parallel import run_ranks
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index
    from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex, IVFEngine

    overcap, _ = overcap_batch(index)
    rng = np.random.default_rng(PAR_TOKENS_SEED)
    dense_q = rng.standard_normal((DENSE_Q, DENSE_D)).astype(np.float32)
    world = PAR_MESH[0] * PAR_MESH[1]
    with tempfile.TemporaryDirectory(prefix="phase12") as tmp:
        t0 = time.time()
        index.save(Path(tmp) / "bm25")
        gen = torch.Generator(device=DEVICE).manual_seed(PAR_IVF_SEED)
        corpus = clustered_corpus(gen)
        ivf = IVFDenseIndex.build(corpus.cpu().numpy(), nlist=IVF_NLIST, block=IVF_BLOCK,
                                  metric="ip", seed=SEED, device=DEVICE)
        ivf_q = (corpus[:QUANT_Q] + 0.1 * torch.randn((QUANT_Q, DENSE_D), generator=gen,
                                                      device=DEVICE)).cpu().numpy()
        del corpus
        ivf.save(Path(tmp) / "ivf")
        print(f"  set-up: BM25 index and IVF (nlist {IVF_NLIST}, {ivf.pad_block} blocks) "
              f"built and saved for the ranks in {time.time() - t0:.1f}s")
        t0 = time.time()
        ranks = run_ranks(_par_retrieval_rank, world, "gloo", rank_device(), tmp, queries,
                          overcap, dense_q, ivf_q)
        print(f"  {world} ranks (mesh {PAR_MESH}, gloo, all on cuda:0; {NO_SCALING}): "
              f"spawned, built their shards and searched in {time.time() - t0:.1f}s")

    def agree(key):
        for r in ranks[1:]:
            for a, b in zip(ranks[0][key][:2], r[key][:2]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"sharded {key}: ranks disagree")
        return ranks[0][key]

    class Result:
        def __init__(self, ids, scores):
            self.doc_indices, self.scores = ids, scores

    single = BM25Engine(index, device=DEVICE)
    for key, qs, k, path_kernels in (
            ("bm25", queries, PAR_K, ("bm25_gather", "segment_topk")),
            ("overcap", overcap, K, ("postings_gather", "postings_assemble", "segment_topk"))):
        ids, scores, stats, _, _ = agree(key)
        sync()
        t0 = time.time()
        ref = single.search_term_ids(qs, k=k + 1)
        sync()
        single_s = time.time() - t0
        want_fallback = len(qs) if key == "overcap" else 0
        if stats["n_fallback"] != want_fallback:
            raise AssertionError(f"sharded {key}: {stats} (want n_fallback {want_fallback})")
        if key == "bm25" or single.last_stats["n_trimmed"] == stats["n_trimmed"] == 0:
            assert_same_topk(Result(ids, scores), ref, f"sharded {key}")
            how = "equal to the single engine on the card"
        else:
            # the single engine trims rows over FALLBACK_MAX_PAD real postings
            # of the whole index; a shard holds a quarter of each term's, so
            # the sharded rows keep more terms (JAX test_sharding.py:623-652)
            if stats["n_trimmed"]:
                raise AssertionError(f"sharded {key}: trimmed {stats}")
            assert_oracle_topk(ids, scores, index, qs, f"sharded {key}")
            how = ("untrimmed, equal to the exact oracle (the single engine trims these rows "
                   "to its cap)")
        line = (f"  sharded BM25 {key}: {len(qs)} queries, k {k}, {stats}; {how} (single "
                f"engine {single_s:.2f}s, {single.last_stats})")
        if key == "bm25":
            sample = np.random.default_rng(SEED + 43).choice(len(qs), 256, replace=False)
            recalls = []
            for row in sample:
                oracle = index.score_all(qs[row])
                denom = min(PAR_K, int((oracle > 0).sum()))
                if denom:
                    thresh = np.partition(oracle, -denom)[-denom]
                    d = ids[row][ids[row] >= 0]
                    recalls.append(min(int((oracle[d] >= thresh - 1e-3).sum()), denom) / denom)
            recall = float(np.mean(recalls))
            if recall != 1.0:
                raise AssertionError(f"sharded BM25 recall@10 {recall} != 1.0")
            line += f"; recall@10 against the oracle on 256 queries {recall}"
        print(line)
        for r in ranks:
            launched(r[key][4], path_kernels, f"sharded {key}, rank {r['shard']}")
            print(f"    rank {r['shard']}: {r[key][3]:.2f}s, launches {nonzero(r[key][4])}")
    del single

    emb = dense_corpus(DEVICE)
    q = torch.from_numpy(dense_q).to(DEVICE)
    for name, metric, kind in DENSE_STORES:
        store = dense_store(emb, metric, kind)
        v, i, _, _ = agree(("dense", name))
        ref = dense_topk(q, store.embeddings, k=PAR_K, metric=metric, sq_norms=store.sq_norms,
                         scales=store.scales, k_pad=16)
        err, _ = check_topk((torch.from_numpy(v), torch.from_numpy(i)), ref,
                            f"sharded dense {name}")
        print(f"  sharded flat dense {name}: {DENSE_N} x {DENSE_D}, {DENSE_Q} queries, k "
              f"{PAR_K}; equal to the single dense_topk on the card (max abs err {err:.3g}, "
              f"recall@10 1.0)")
        for r in ranks:
            launched(r["dense", name][3], ("dense_topk",), f"sharded dense {name}")
            print(f"    rank {r['shard']}: {r['dense', name][2]:.3f}s, launches "
                  f"{nonzero(r['dense', name][3])}")
    del emb, store

    ids, scores, _, _ = agree("ivf")
    ref = IVFEngine(ivf, nprobe=IVF_NPROBE, device=DEVICE).search_embeddings(ivf_q, k=PAR_K)
    err, _ = check_topk((torch.from_numpy(scores), torch.from_numpy(ids)),
                        (torch.from_numpy(ref.scores), torch.from_numpy(ref.doc_indices)),
                        "sharded IVF")
    print(f"  sharded IVF: {IVF_N} x {DENSE_D}, nlist {IVF_NLIST}, nprobe {IVF_NPROBE}, Q "
          f"{QUANT_Q}, k {PAR_K}; equal to the single IVFEngine on the card (max abs err "
          f"{err:.3g})")
    for r in ranks:
        launched(r["ivf"][3], ("ivf_topk", "dense_topk"), "sharded IVF")
        print(f"    rank {r['shard']}: init {r['ivf_init_s']:.1f}s, search {r['ivf'][2]:.3f}s, "
              f"launches {nonzero(r['ivf'][3])}")


def assert_oracle_topk(ids, scores, index, queries, what: str) -> None:
    """BM25 (ids, scores) [Q, k] against the exact host oracle: the top-k
    score multiset, and each returned doc's own oracle score (ties order
    freely), at the f32-against-f64 tolerance (ROADMAP caveats)."""
    import numpy as np

    for row, q in enumerate(queries):
        oracle = index.score_all(q)
        top = np.sort(oracle)[::-1][: scores.shape[1]]
        hit = ids[row] >= 0
        if not (np.allclose(scores[row][hit], top[: hit.sum()], rtol=1e-4, atol=5e-4)
                and np.allclose(oracle[ids[row][hit]], scores[row][hit], rtol=1e-4, atol=5e-4)):
            raise AssertionError(f"{what}: row {row} differs from the oracle")


def tp_inputs(index):
    """The TP forward's tokens [TP_BATCH, TP_SEQ] and the decode's prompts."""
    import numpy as np

    tokens = np.random.default_rng(PAR_TOKENS_SEED).integers(0, 256_000, (TP_BATCH, TP_SEQ))
    return tokens, loop_questions(index)[:TP_BATCH]


def _par_tp_rank(rank, world, dev, tokens, prompts):
    """One rank of tp 2 at Gemma-2B width (phase 5's weights, sharded): the
    forward on [8, 512] tokens in bf16 and with int8 weights (head on the
    last position), and a 32-token eager decode in f32 (weights and
    products) and in bf16."""
    import dataclasses

    import torch

    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.decode import generate
    from probing_rag_tpu_torch.models.gemma import (
        CaptureSpec, GemmaConfig, forward, init_params, quantize_lm_params,
    )
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.parallel import make_mesh, shard_lm_params

    mesh = make_mesh(TP_MESH, dev.type)
    group = mesh.get_group("tp")
    cfg = GemmaConfig.gemma_2b()
    capture = CaptureSpec.for_probing(cfg)
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=torch.bfloat16)
    trees = {"bf16": shard_lm_params(full, mesh)}
    trees["int8"] = shard_lm_params(quantize_lm_params(full), mesh)
    del full
    out = {}
    tok = torch.from_numpy(tokens).to(dev)
    with torch.inference_mode():
        for name, params in trees.items():
            kernels.reset_launches()
            rank_sync(dev)
            t0 = time.time()
            logits, _, caps = forward(params, tok, cfg, capture=capture, logits_last_only=True,
                                      tp=group)
            rank_sync(dev)
            out[name] = (logits[:, -1].cpu().numpy(), caps[:, :, -1].cpu().numpy(),
                         time.time() - t0, dict(kernels.LAUNCHES))
    f32 = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    trees["f32"] = shard_lm_params(f32, mesh)
    del f32, trees["int8"]
    cfgs = {"f32": dataclasses.replace(cfg, compute_dtype=torch.float32), "bf16": cfg}
    for name in ("f32", "bf16"):
        rank_sync(dev)
        t0 = time.time()
        _, res = generate(trees[name], cfgs[name], ByteTokenizer(cfg.vocab_size), prompts,
                          max_new_tokens=TP_DECODE, capture=capture, paragraph_stop=False,
                          eager=True, tp=group)
        out["decode", name] = (res.tokens, res.n_generated, res.pooled_captures,
                               time.time() - t0)
    return out


def _par_nccl_rank(rank, world, dev, prompts):
    """NCCL at world size 1: the graphed decode step at tp 1 (its
    all-reduces captured in the graph) against the unsharded graphed step."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.models import graphs
    from probing_rag_tpu_torch.models.decode import generate
    from probing_rag_tpu_torch.models.gemma import CaptureSpec, GemmaConfig, init_params
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.parallel import make_mesh, shard_lm_params

    mesh = make_mesh((1, 1), "cuda")
    cfg = GemmaConfig.gemma_2b()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                         dtype=torch.bfloat16)
    kw = dict(max_new_tokens=TP_DECODE, capture=CaptureSpec.for_probing(cfg),
              paragraph_stop=False)
    tok = ByteTokenizer(cfg.vocab_size)
    _, ref = generate(params, cfg, tok, prompts, **kw)
    before = graphs.CAPTURES["count"]
    _, got = generate(shard_lm_params(params, mesh), cfg, tok, prompts,
                      tp=mesh.get_group("tp"), **kw)
    return {"captures": graphs.CAPTURES["count"] - before,
            "equal": {n: bool(np.array_equal(getattr(ref, n), getattr(got, n)))
                      for n in ("tokens", "token_valid", "pooled_captures", "n_generated")}}


def phase_par_tp(index, lm_params) -> None:
    """TP at Gemma-2B width over two ranks on the card (gloo) against the
    unsharded forward and decode on the card; matmul_int8 at the sharded
    shapes against its plain version; then NCCL at world size 1."""
    import dataclasses

    import numpy as np
    import torch

    from probing_rag_tpu_torch.models.decode import generate
    from probing_rag_tpu_torch.models.gemma import (
        CaptureSpec, GemmaConfig, forward, init_params, quantize_lm_params,
    )
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
    from probing_rag_tpu_torch.ops import matmul as mm
    from probing_rag_tpu_torch.parallel import run_ranks

    cfg = GemmaConfig.gemma_2b()
    capture = CaptureSpec.for_probing(cfg)
    tokens, prompts = tp_inputs(index)
    world = TP_MESH[0] * TP_MESH[1]
    t0 = time.time()
    ranks = run_ranks(_par_tp_rank, world, "gloo", rank_device(), tokens, prompts)
    print(f"  TP: {world} ranks (mesh {TP_MESH}, gloo, all on cuda:0; {NO_SCALING}) in "
          f"{time.time() - t0:.1f}s")
    for name in ("bf16", "int8", ("decode", "f32"), ("decode", "bf16")):
        for r in ranks[1:]:
            for a, b in zip(ranks[0][name], r[name]):
                if isinstance(a, np.ndarray) and not np.array_equal(a, b):
                    raise AssertionError(f"TP {name}: ranks disagree")

    tok = torch.from_numpy(tokens).to(DEVICE)
    trees = {"bf16": lm_params, "int8": quantize_lm_params(lm_params)}
    with torch.inference_mode():
        for name, params in trees.items():
            logits, _, caps = forward(params, tok, cfg, capture=capture, logits_last_only=True)
            ref, ref_caps = logits[:, -1].cpu().numpy(), caps[:, :, -1].cpu().numpy()
            got, got_caps, s, counts = ranks[0][name]
            scale = float(np.abs(ref).max())
            drift = float(np.abs(got - ref).max()) / scale
            cap_drift = float(np.abs(got_caps - ref_caps).max() / np.abs(ref_caps).max())
            agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
            if not np.isfinite(got).all() or drift > TP_DRIFT:
                raise AssertionError(f"TP forward {name}: logit drift {drift} > {TP_DRIFT}")
            if name == "int8":
                launched(counts, ("matmul_int8",), "TP int8 forward")
            print(f"  TP forward {name} [{TP_BATCH} x {TP_SEQ}]: {s:.2f}s on rank 0; logit "
                  f"drift {drift:.3g} of the largest logit {scale:.3g} (limit {TP_DRIFT}), "
                  f"captures {cap_drift:.3g} of the largest, last-token argmax agreement "
                  f"{agree}; rank launches {[nonzero(r[name][3]) for r in ranks]}")
    del trees
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 44)
    m = TP_BATCH * TP_SEQ
    for label, k, n in (("wq", 2048, 1024), ("wo", 1024, 2048), ("w_gate/w_up", 2048, 8192),
                        ("w_down", 8192, 2048)):
        x, q, s = mm_operands(gen, m, k, n, False, torch.bfloat16)
        mm.last_plan = None
        got = mm.matmul_int8(x, q, s, dt=torch.bfloat16)
        plan = mm.last_plan
        err, differ = mm_check(got, mm.matmul_int8_plain(x, q, s, dt=torch.bfloat16),
                               torch.bfloat16, f"TP {label}")
        ms = cuda_ms(lambda: mm.matmul_int8(x, q, s, dt=torch.bfloat16))
        b = bound(x.numel() * 2 + q.numel() + n * 4 + m * n * 2, 2 * m * n * k, "bf16")
        print(f"  matmul_int8 at the tp-2 shape {label} [{m} x {k} -> {n}], "
              f"{plan.regime if plan else 'plain'}: max "
              f"abs err {err:.3g} ({differ:.4f} of the outputs differ); {ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        del x, q, s, got

    tokz = ByteTokenizer(cfg.vocab_size)
    kw = dict(max_new_tokens=TP_DECODE, capture=capture, paragraph_stop=False, eager=True)
    f32 = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    cfgs = {"f32": dataclasses.replace(cfg, compute_dtype=torch.float32), "bf16": cfg}
    for name, params in (("f32", f32), ("bf16", lm_params)):
        sync()
        t0 = time.time()
        _, ref = generate(params, cfgs[name], tokz, prompts, **kw)
        ref_s = time.time() - t0
        tokens_tp, n_gen, pooled, tp_s = ranks[0]["decode", name]
        same_rows = (tokens_tp == ref.tokens).all(axis=1)
        pooled_err = float(np.abs(pooled - ref.pooled_captures).max())
        line = (f"  TP eager decode {name}, {TP_DECODE} tokens x {TP_BATCH}: {tp_s:.1f}s on "
                f"rank 0 against {ref_s:.1f}s unsharded; rows equal {int(same_rows.sum())}/"
                f"{TP_BATCH}, pooled captures max abs diff {pooled_err:.3g}")
        if name == "f32":
            if not same_rows.all() or not np.array_equal(n_gen, ref.n_generated):
                raise AssertionError("TP f32 decode tokens differ from the unsharded decode")
        else:
            gaps = decode_gaps(params, cfg, tokz, prompts, tokens_tp, ref.tokens)
            if gaps and max(gaps) > TP_DRIFT:
                raise AssertionError(f"TP bf16 decode parts where the logit gap is {max(gaps)}")
            line += (f"; where rows part, the unsharded logit gap between the two tokens is "
                     f"at most {max(gaps, default=0.0):.3g} of the largest logit (limit "
                     f"{TP_DRIFT})")
        print(line)
    del f32
    torch.cuda.empty_cache()

    t0 = time.time()
    nccl = run_ranks(_par_nccl_rank, 1, "nccl", "cuda", prompts)[0]
    if not all(nccl["equal"].values()) or nccl["captures"] < 1:
        raise AssertionError(f"NCCL tp 1 graphed decode: {nccl}")
    print(f"  NCCL, world size 1: the graphed TP decode step (tp 1, {nccl['captures']} "
          f"capture with its all-reduces inside) bit-equal to the unsharded graphed step "
          f"({nccl['equal']}); {time.time() - t0:.1f}s")


def decode_gaps(params, cfg, tokz, prompts, got, ref) -> list:
    """For each row where the TP tokens ``got`` part from the unsharded
    ``ref``: the unsharded forward (no cache) on the prompt and the common
    prefix, and the gap between its logits for the two tokens at the first
    parting step, as a share of its largest logit."""
    import numpy as np
    import torch

    from probing_rag_tpu_torch.models.gemma import forward

    gaps = []
    for row in np.nonzero((got != ref).any(axis=1))[0]:
        step = int(np.argmax(got[row] != ref[row]))
        seq = tokz.encode(prompts[row], add_bos=True) + [int(t) for t in ref[row, :step]]
        with torch.inference_mode():
            logits = forward(params, torch.tensor([seq], device=DEVICE), cfg,
                             logits_last_only=True)[0][0, -1]
        gap = float(logits[int(ref[row, step])] - logits[int(got[row, step])])
        gaps.append(abs(gap) / float(logits.abs().max()))
    return gaps


def phase_parallel(index, docs_tokens, queries, lm_params) -> None:
    """Phase 12: the native builder, then the sharded retrieval engines and
    TP, each part with its seconds."""
    import torch

    for label, fn in (("native", lambda: phase_native(index, docs_tokens, queries)),
                      ("sharded retrieval", lambda: phase_par_retrieval(index, queries)),
                      ("tensor parallelism", lambda: phase_par_tp(index, lm_params))):
        t0 = time.time()
        fn()
        torch.cuda.empty_cache()
        print(f"  [12] {label}: {time.time() - t0:.1f}s")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--matmul", action="store_true",
                    help="only phases 1, 2 and the matmul_int8 and matmul_int4 cases of phase 8")
    ap.add_argument("--quantized", action="store_true",
                    help="only phases 1, 2 and phase 8 (over the phase-4 index and phase 5's model)")
    ap.add_argument("--train", action="store_true",
                    help="only phases 1, 2 and phase 10 (over the phase-4 index and phase 5's model)")
    ap.add_argument("--baselines", action="store_true",
                    help="only phases 1, 2 and phase 11 (over the phase-4 index and phase 5's model)")
    ap.add_argument("--parallel", action="store_true",
                    help="only phases 1, 2 and phase 12 (over the phase-4 index and phase 5's weights)")
    ap.add_argument("--attention", action="store_true",
                    help="only phases 1, 2 and phase 9's decode and prefill attention cases")
    ap.add_argument("--block", action="store_true",
                    help="only phases 1, 2 and 9a (the block's elementwise kernels)")
    args = ap.parse_args()
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
    if args.block:
        with Phase("9a block kernels"):
            phase_block_kernels(results)
        print(json.dumps(results))
        return 0
    if args.attention:
        with Phase("9 attention kernels"):
            phase_attention_kernels(results)
            phase_prefill_kernels(results)
        print(json.dumps(results))
        return 0
    if args.matmul:
        with Phase("8 matmul_int8 and matmul_int4 kernels"):
            phase_matmul_kernels(results, 8 * 3712)
            torch.cuda.empty_cache()
            phase_matmul_int4_kernels(results, 8 * 3712)
        print(json.dumps(results))
        return 0
    if args.quantized:
        with Phase("8 quantized main path"):
            index, docs_tokens, _, _ = build_zipf_index()
            phase_quantized(gemma_2b_lm(docs_tokens), index, loop_questions(index), results)
        print(json.dumps(results))
        return 0
    if args.train:
        with Phase("10 prober training"):
            index, docs_tokens, _, _ = build_zipf_index()
            phase_prober_training(gemma_2b_lm(docs_tokens), index, loop_questions(index), results)
        print(json.dumps(results))
        return 0
    if args.baselines:
        with Phase("11 baselines and the CLI chain"):
            index, docs_tokens, _, _ = build_zipf_index()
            phase_baselines(gemma_2b_lm(docs_tokens), index)
        return 0
    if args.parallel:
        with Phase("12 native builder, sharded retrieval, tensor parallelism"):
            index, docs_tokens, queries, _ = build_zipf_index()
            phase_parallel(index, docs_tokens, queries, gemma_2b_lm(docs_tokens)[0])
        return 0
    with Phase("3 kernels vs plain"):
        import numpy as np

        from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

        t0 = time.time()
        index, docs_tokens, queries, rng = build_zipf_index()
        print(f"  Zipf index: {index.n_docs} docs, {index.nnz} postings, "
              f"built in {time.time() - t0:.1f}s")
        engine = BM25Engine(index, device=DEVICE)
        sync()
        before = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        dma_engine = BM25Engine(index, device=DEVICE, mode="dma")
        sync()
        dma_bytes = sum(a.numel() * a.element_size() for a in dma_engine._aligned)
        print(f"  dma-mode aligned CSR: {dma_engine._aligned[0].numel()} entries for "
              f"{index.nnz} postings, {dma_bytes / 2**30:.3f} GiB "
              f"({((torch.cuda.memory_allocated() if DEVICE == 'cuda' else 0) - before) / 2**30:.3f}"
              f" GiB allocated by the engine)")
        phase_sort(results)
        phase_gather_segment(engine, queries, results)
        dma_gather = phase_dma_gather(dma_engine, queries)
        phase_hybrid_kernels(engine, index, results, dma_gather)
    with Phase("4 BM25 at scale"):
        cpu_engine = BM25Engine(index, device="cpu")
        phase_bm25(engine, dma_engine, cpu_engine, index, queries, rng)
        del engine, dma_engine
    with Phase("5 main path"):
        launches, lm, questions = phase_main_path(index, docs_tokens, cpu_engine)
    del cpu_engine
    torch.cuda.empty_cache()
    with Phase("6 dense kernels vs plain"):
        phase_dense_kernels(results)
        torch.cuda.empty_cache()
        phase_ivf_kernels(results)
        torch.cuda.empty_cache()
    with Phase("7 dense main path"):
        dense_launches = phase_dense_main_path(docs_tokens, lm)
    launches.update({n: dense_launches[n] for n in DENSE_KERNELS})
    with Phase("8 quantized main path"):
        quant_launches = phase_quantized(lm, index, questions, results)
        launches.update({n: quant_launches[n] for n in ("matmul_int8", "matmul_int4")})
    with Phase("9a block kernels"):
        phase_block_kernels(results)
    torch.cuda.empty_cache()
    with Phase("9 generation"):
        phase_generation(lm, index, questions, results)
    torch.cuda.empty_cache()
    with Phase("10 prober training"):
        phase_prober_training(lm, index, questions, results)
    torch.cuda.empty_cache()
    with Phase("11 baselines and the CLI chain"):
        phase_baselines(lm, index)
    torch.cuda.empty_cache()
    with Phase("12 native builder, sharded retrieval, tensor parallelism"):
        phase_parallel(index, docs_tokens, queries, lm[0])

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every kernel's fields, then the extra shapes some carry (the wide
    # sort's 8M row, the over-cap chain's sort and segment top-k, the
    # assembly's unweighted, cut and widest cases)
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name], **{k: r[k] for k in keys},
         **{k: v for k, v in r.items() if k not in keys}}
        for name, r in results.items()
    ]}
    if sorted(results) != sorted(SOURCES):
        raise AssertionError(f"kernels measured {sorted(results)} != {sorted(SOURCES)}")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
