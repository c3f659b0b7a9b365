"""Command-line entry points of the port: ``index-build`` and ``rag-run``.

Port of the BM25 and dense paths of ``probing_rag_tpu/cli/main.py``:

    python -m probing_rag_tpu_torch.cli index-build --dataset nq --fixture corpus.txt --out artifacts/nq
    python -m probing_rag_tpu_torch.cli rag-run --retr-method probing --dataset nq \\
        --fixture-qa qa.json --index artifacts/nq --device cuda

``--dense`` builds and searches the flat dense index instead of BM25
(``--dense-int8``: the SQ8 store with re-ranking; ``--dense-ivf``: the IVF
index, built beside the flat one). ``rag-run --quantize int8|int4``
quantizes the LM weights (``--int4-scheme``, ``--act-int8-rows``), and
``--kv-int8`` / ``--kv-int4`` the KV cache; ``--spec-k N`` decodes
speculatively (``--spec-drafter prompt``). On the card each decode step
runs as a replayed CUDA graph (``models/graphs.py``).

Without a checkpoint (loading one is not ported yet) ``rag-run`` uses the
random-init tiny model and the byte tokenizer — the JAX CLI's smoke mode —
and a random prober gate unless ``--probers`` names a ``save_pytree``
checkpoint. The dense encoder is then the tiny encoder with weights drawn
from one fixed seed, the same in ``index-build`` and ``rag-run``, so that
documents and queries are embedded by one encoder.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

# seed of the random-init query/document encoder (the JAX CLI's PRNGKey(0))
ENCODER_SEED = 0


def _load_model(args):
    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_params
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer

    print(
        "[probing-rag-tpu-torch] no checkpoint loader yet: using random-init tiny "
        "model (smoke-test mode; outputs are not meaningful)",
        file=sys.stderr,
    )
    cfg = dataclasses.replace(GemmaConfig.tiny(), compute_dtype=torch.float32)
    cfg = _apply_act8(cfg, args)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    return _maybe_quantize(params, args), cfg, ByteTokenizer(cfg.vocab_size)


def _apply_act8(cfg, args):
    """The w8a8 / w4a8 prefill threshold applies to ``--quantize int8`` and
    to rank-1 int4 (its group scale folds into the activations before they
    are quantized per row); grouped int4 keeps its w4a16 form."""
    rows = args.act_int8_rows
    rank1 = args.int4_scheme == "rank1"
    if rows and (args.quantize == "int8" or (args.quantize == "int4" and rank1)):
        return dataclasses.replace(cfg, act_int8_rows=rows)
    return cfg


def _maybe_quantize(params, args):
    if args.quantize == "none":
        return params
    from probing_rag_tpu_torch.models.gemma import quantize_lm_params

    return quantize_lm_params(params, bits=4 if args.quantize == "int4" else 8,
                              int4_scheme=args.int4_scheme)


def _load_probers(args, cfg):
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig, init_prober_stack
    from probing_rag_tpu_torch.utils.checkpoint import load_pytree
    from probing_rag_tpu_torch.weights import probers_from_jax

    tc = ProberTrainConfig(layers=cfg.probe_layers, positions=(args.position,))
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    template = init_prober_stack(tc, cfg.d_model, gen, device=args.device)
    if not args.probers:
        print("[probing-rag-tpu-torch] no --probers: random gate (smoke only)", file=sys.stderr)
        return template
    probers, meta = load_pytree(Path(args.probers))
    # checkpoints trained over both positions carry 2x the gate's sites:
    # select the gate's rows by the manifest's site order
    saved = [tuple(s) for s in meta.get("sites", [])]
    if saved and saved != list(tc.sites):
        missing = [s for s in tc.sites if s not in saved]
        if missing:
            raise SystemExit(f"--probers checkpoint sites {saved} do not cover the gate's sites {tc.sites}")
        rows = torch.as_tensor([saved.index(s) for s in tc.sites])
        probers = {m: {k: v[rows] for k, v in sub.items()} for m, sub in probers.items()}
    probers = probers_from_jax(probers, device=args.device)
    got = {(m, k): tuple(v.shape) for m, sub in probers.items() for k, v in sub.items()}
    want = {(m, k): tuple(v.shape) for m, sub in template.items() for k, v in sub.items()}
    if got != want:
        raise SystemExit(
            f"--probers checkpoint does not match the gate's prober stack: got {got}, "
            f"expected {want} (d_model={cfg.d_model}, sites={tc.sites})"
        )
    return probers


def _dense_encoder(args):
    """Tiny encoder from ``ENCODER_SEED`` (drawn on the CPU, so every
    device gets the same weights) with the byte tokenizer."""
    from probing_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder_params, text_encoder
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = EncoderConfig.tiny()
    params = init_encoder_params(cfg, torch.Generator().manual_seed(ENCODER_SEED),
                                 device="cpu")

    def to_device(tree):
        return {k: to_device(v) if isinstance(v, dict) else v.to(args.device) for k, v in tree.items()}

    return text_encoder(to_device(params), cfg, ByteTokenizer(max(cfg.vocab_size, 259)), args.device)


def cmd_index_build(args):
    from probing_rag_tpu_torch.data.corpus import DocStore, make_documents
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index

    if args.fixture:
        texts = [line for line in Path(args.fixture).read_text().splitlines() if line.strip()]
        ids = [str(i) for i in range(len(texts))]
    else:
        texts, ids = make_documents(args.dataset, Path(args.raw_dir))
    out = Path(args.out)
    DocStore.from_texts(texts, ids).save(out / "docstore.json")
    t0 = time.time()
    if args.dense:
        from probing_rag_tpu_torch.retrieval.dense import DenseIndex

        dense = DenseIndex.build(texts, _dense_encoder(args))
        dense.save(out / "dense")
        print(f"built dense index over {len(texts)} docs in {time.time() - t0:.1f}s")
        if args.dense_ivf:
            from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex

            t0 = time.time()
            IVFDenseIndex.build(
                dense.embeddings, metric=dense.metric, seed=args.seed,
                nlist=args.ivf_nlist, device=args.device,
            ).save(out / "ivf")
            print(f"built IVF quantizer+store in {time.time() - t0:.1f}s")
    else:
        BM25Index.build(texts, BM25Config()).save(out / "bm25")
        print(f"built sparse index over {len(texts)} docs in {time.time() - t0:.1f}s")
    print(f"index written to {out}")


def _load_questions(args):
    from probing_rag_tpu_torch.data.qa import load_qa_dataset

    if args.fixture_qa:
        import json

        data = json.loads(Path(args.fixture_qa).read_text())
        return [d["question"] for d in data], [d["answers"] for d in data]
    examples = load_qa_dataset(Path(args.raw_dir), args.dataset, args.split)
    examples = examples[: args.steps_limit + 1]
    return [e.question for e in examples], [e.answers for e in examples]


def cmd_rag_run(args):
    from probing_rag_tpu_torch.data.corpus import DocStore
    from probing_rag_tpu_torch.eval.evaluator import evaluate_predictions
    from probing_rag_tpu_torch.eval.metrics import EmF1Metric, SupportEmF1Metric
    from probing_rag_tpu_torch.eval.results import RunRecord, result_filename, save_run
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index

    # f32 matmuls in full f32, as the JAX reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, cfg, tok = _load_model(args)
    index_dir = Path(args.index)
    store = DocStore.load(index_dir / "docstore.json")
    if args.dense:
        store_dtype = torch.int8 if args.dense_int8 else torch.bfloat16
        if args.dense_ivf:
            from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex, IVFEngine

            engine = IVFEngine(IVFDenseIndex.load(index_dir / "ivf"), nprobe=args.ivf_nprobe,
                               encode_fn=_dense_encoder(args), device=args.device,
                               store_dtype=store_dtype)
        else:
            from probing_rag_tpu_torch.retrieval.dense import DenseEngine, DenseIndex

            engine = DenseEngine(DenseIndex.load(index_dir / "dense"), _dense_encoder(args),
                                 device=args.device, store_dtype=store_dtype)
    else:
        engine = BM25Engine(BM25Index.load(index_dir / "bm25"), device=args.device)
    probers = _load_probers(args, cfg) if args.retr_method == "probing" else None
    rag = RAGConfig(
        retr_method=args.retr_method,
        threshold=args.threshold,
        ablation=args.ablation,
        top_k=args.top_k,
        max_new_tokens=args.max_new_tokens,
        batch_size=args.batch_size,
        position=args.position,
        kv_int8=args.kv_int8,
        kv_int4=args.kv_int4,
        spec_k=args.spec_k,
        spec_drafter=args.spec_drafter,
    )
    pipeline = AdaptiveRAGPipeline(params, cfg, tok, engine, store, probers, rag)
    questions, answers = _load_questions(args)
    t0 = time.time()
    result = pipeline.run(questions)
    elapsed = time.time() - t0
    multihop = args.dataset in ("hotpotqa", "2wikimultihopqa", "musique", "iirc")
    metric = SupportEmF1Metric() if multihop else EmF1Metric()
    acc, metric, _ = evaluate_predictions(
        result.pred_list, answers, metric,
        dataset_name=args.dataset, retr_method=args.retr_method,
    )
    record = RunRecord(
        retr_method=args.retr_method,
        dataset_name=args.dataset,
        elapsed_s=elapsed,
        acc=acc,
        metric_out=metric.get_metric(),
        retr_count_list=result.retr_count_list if args.retr_method == "probing" else None,
        config={k: v for k, v in vars(args).items() if k != "fn"},
    )
    fname = result_filename(
        args.ablation, "torch", "dense" if args.dense else "sparse", args.dataset,
        args.threshold, args.retr_method, "cot", args.split, args.steps_limit,
    )
    path = save_run(record, Path(args.results_dir), fname)
    em, f1 = record.em_f1()
    print(f"acc={record.accuracy:.4f} em={em} f1={f1} time={elapsed:.1f}s -> {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="probing-rag-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def dense_args(sp):
        sp.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--dense", action="store_true", help="dense retrieval")
        sp.add_argument("--dense-int8", action="store_true",
                        help="int8 (SQ8) dense store, re-ranked against a bf16 copy")
        sp.add_argument("--dense-ivf", action="store_true",
                        help="IVF dense index (k-means cells, probed search)")
        sp.add_argument("--ivf-nprobe", type=int, default=32,
                        help="IVF cells probed per query (recall knob)")
        sp.add_argument("--ivf-nlist", type=int, default=None,
                        help="IVF cell count (default ~2*sqrt(n_docs), pow2)")

    sp = sub.add_parser("index-build")
    dense_args(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--raw-dir", default="raw_data")
    sp.add_argument("--out", required=True)
    sp.add_argument("--fixture", default=None, help="plain-text corpus file (one doc/line)")
    sp.set_defaults(fn=cmd_index_build)

    sp = sub.add_parser("rag-run")
    dense_args(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--split", default="dev")
    sp.add_argument("--raw-dir", default="raw_data")
    sp.add_argument("--fixture-qa", default=None, help="JSON [{question, answers}]")
    sp.add_argument("--index", required=True)
    sp.add_argument("--probers", default=None)
    sp.add_argument("--threshold", type=float, default=0.0)
    sp.add_argument("--ablation", type=int, default=0)
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--max-new-tokens", type=int, default=150)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--position", default="resid_post")
    sp.add_argument("--steps-limit", type=int, default=500)
    sp.add_argument("--results-dir", default="result")
    sp.add_argument("--retr-method", default="probing", choices=["probing", "none", "simple"])
    sp.add_argument("--quantize", default="none", choices=["none", "int8", "int4"],
                    help="LM weights: per-channel int8 (w8a16 on the matmul_int8 kernel), "
                    "or sub-channel int4 (the embedding stays int8)")
    sp.add_argument("--int4-scheme", default="grouped", choices=["grouped", "rank1"],
                    help="with --quantize int4: 'grouped' keeps one scale per "
                    "(group, channel); 'rank1' factorizes them as rs[k] * s[f]")
    sp.add_argument("--act-int8-rows", type=int, default=0,
                    help="with --quantize int8 (or int4 rank1): from this many "
                    "activation rows (batch x tokens, so prefill) the products "
                    "run w8a8 (w4a8); 0 = never")
    sp.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (one scale per token and kv head)")
    sp.add_argument("--kv-int4", action="store_true",
                    help="int4 KV cache (one scale per 32 head-dim lanes); "
                    "exclusive with --kv-int8")
    sp.add_argument("--spec-k", type=int, default=0, dest="spec_k",
                    help="speculative decode: verify this many prompt-lookup draft "
                    "tokens per forward (greedy-exact: the output equals greedy "
                    "decode); 0 = off")
    sp.add_argument("--spec-drafter", default="prompt", dest="spec_drafter",
                    choices=["prompt"],
                    help="speculative draft source (the oracle drafter is a "
                    "bench and test harness, not a serving option)")
    sp.set_defaults(fn=cmd_rag_run)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
