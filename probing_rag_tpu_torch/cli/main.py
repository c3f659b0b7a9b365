"""Command-line entry points of the port: the index build, dataset
extraction, prober training and evaluation, the adaptive RAG run, its
threshold sweep, the analysis report, and the parity drill that chains
them.

Port of ``probing_rag_tpu/cli/main.py``:

    python -m probing_rag_tpu_torch.cli index-build --dataset nq --fixture corpus.txt --out artifacts/nq
    python -m probing_rag_tpu_torch.cli dataset-make --retr-method simple --dataset nq \\
        --fixture-qa qa.json --index artifacts/nq --out dataset/rows_simple.csv
    python -m probing_rag_tpu_torch.cli prober-train --data dataset/rows_*.csv --out artifacts/probers
    python -m probing_rag_tpu_torch.cli prober-eval --data dataset/rows_*.csv \\
        --probers artifacts/probers/probers --positions resid_mid,resid_post
    python -m probing_rag_tpu_torch.cli rag-run --retr-method probing --dataset nq \\
        --fixture-qa qa.json --index artifacts/nq --probers artifacts/probers/probers
    python -m probing_rag_tpu_torch.cli rag-sweep --dataset nq --fixture-qa qa.json \\
        --index artifacts/nq --thresholds=-2,-1,0,1,2
    python -m probing_rag_tpu_torch.cli analyze --runs result/runs.jsonl --report report
    python -m probing_rag_tpu_torch.cli parity --workdir parity --datasets nq,trivia
    python -m probing_rag_tpu_torch.cli param-audit

Every command that runs a model takes ``--device`` (default ``cuda``);
``parity`` passes it to each command it runs, and ``analyze`` runs no
model.
``--checkpoint DIR`` loads a HF Gemma-2B (or, by ``--model-id``,
Mistral-7B) safetensors checkpoint in bf16, with the tokenizer from
``--tokenizer`` (a sentencepiece model) or from the checkpoint directory
(through ``transformers``); without one the model is the random-init tiny
f32 model with the byte tokenizer (smoke mode). ``--dense`` builds and
searches the flat dense index instead of BM25 (``--dense-int8``: the SQ8
store with re-ranking; ``--dense-ivf``: the IVF index, built beside the
flat one). ``--quantize int8|int4`` quantizes the LM weights
(``--int4-scheme``, ``--act-int8-rows``), and ``--kv-int8`` /
``--kv-int4`` the KV cache; ``--spec-k N`` decodes speculatively. On the
card each decode step runs as a replayed CUDA graph
(``models/graphs.py``).

``rag-run --retr-method probing`` gates with a random prober stack unless
``--probers`` names a ``save_pytree`` checkpoint (``prober-train`` writes
one). The dense encoder has weights drawn from one fixed seed, the same in
``index-build`` and ``rag-run``, so that documents and queries are
embedded by one encoder: Contriever's width (768) under ``--checkpoint``,
as in the JAX CLI, else the tiny encoder (32).

``index-build`` and ``rag-run`` end by logging at INFO where their time
went: each span of the recorder (``utils/profiling.py``) with its total
and self seconds, its count and its summed counts, then the graph
captures and hits and the kernel launches.
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


def _f32_matmuls():
    # f32 matmuls in full f32, as the JAX reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _load_model(args):
    """LM params + config + tokenizer: the HF checkpoint in bf16 when one is
    given, else the random-init tiny f32 model with the byte tokenizer."""
    from probing_rag_tpu_torch.models.gemma import GemmaConfig, init_params
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer, SentencePieceTokenizer

    if args.checkpoint:
        from probing_rag_tpu_torch.models.hf_loader import load_gemma_params

        mistral = "mistral" in args.model_id.lower()
        cfg = GemmaConfig.mistral_7b() if mistral else GemmaConfig.gemma_2b()
        cfg = _apply_act8(cfg, args)
        params = load_gemma_params(Path(args.checkpoint), cfg, dtype=torch.bfloat16,
                                   device=args.device)
        if args.tokenizer:
            tok = SentencePieceTokenizer(args.tokenizer)
        else:
            from transformers import AutoTokenizer

            tok = SentencePieceTokenizer(AutoTokenizer.from_pretrained(args.checkpoint))
        return _maybe_quantize(params, args), cfg, tok

    print(
        "[probing-rag-tpu-torch] no --checkpoint: using random-init tiny model "
        "(smoke-test mode; outputs are not meaningful)",
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
    return _checked_stack(probers_from_jax(probers, device=args.device), template, cfg, tc)


def _checked_stack(probers, template, cfg, tc):
    """``probers`` if its leaves have the template's shapes, else exit
    naming both."""
    got = {(m, k): tuple(v.shape) for m, sub in probers.items() for k, v in sub.items()}
    want = {(m, k): tuple(v.shape) for m, sub in template.items() for k, v in sub.items()}
    if got != want:
        raise SystemExit(
            f"--probers checkpoint does not match the prober stack: got {got}, "
            f"expected {want} (d_model={cfg.d_model}, sites={tc.sites})"
        )
    return probers


def _log_report() -> None:
    """Logs the recorder's report and the program's counters at INFO."""
    from probing_rag_tpu_torch import kernels
    from probing_rag_tpu_torch.models.graphs import CAPTURES
    from probing_rag_tpu_torch.utils.logging import get_logger
    from probing_rag_tpu_torch.utils.profiling import RECORDER

    log = get_logger(__name__)
    for name, r in RECORDER.report().items():
        log.info("span %s: %d in %.4f s (self %.4f s) %s", name, r["count"], r["total_s"],
                 r["self_s"], r["counts"])
    log.info("graph captures %d (%.3f s), hits %d; kernel launches %s", CAPTURES["count"],
             CAPTURES["seconds"], CAPTURES["hits"],
             {k: v for k, v in kernels.LAUNCHES.items() if v})


def _dense_encoder(args):
    """The dense encoder with weights from ``ENCODER_SEED`` (drawn on the
    CPU, so every device gets the same weights) and the byte tokenizer:
    Contriever's width under ``--checkpoint``, as the JAX CLI's
    ``_dense_encoder`` takes it, else the tiny encoder."""
    from probing_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder_params, text_encoder
    from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = EncoderConfig.contriever() if args.checkpoint else EncoderConfig.tiny()
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
    _log_report()


def _load_questions(args):
    from probing_rag_tpu_torch.data.qa import load_qa_dataset

    if args.fixture_qa:
        import json

        data = json.loads(Path(args.fixture_qa).read_text())
        return [d["question"] for d in data], [d["answers"] for d in data]
    examples = load_qa_dataset(Path(args.raw_dir), args.dataset, args.split)
    examples = examples[: args.steps_limit + 1]
    return [e.question for e in examples], [e.answers for e in examples]


def _build_pipeline(args, retr_method: str):
    from probing_rag_tpu_torch.data.corpus import DocStore
    from probing_rag_tpu_torch.pipeline.rag import AdaptiveRAGPipeline, RAGConfig
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine
    from probing_rag_tpu_torch.retrieval.bm25_index import BM25Index

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
    probers = _load_probers(args, cfg) if retr_method == "probing" else None
    rag = RAGConfig(
        retr_method=retr_method,
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
    return AdaptiveRAGPipeline(params, cfg, tok, engine, store, probers, rag)


def cmd_rag_run(args):
    from probing_rag_tpu_torch.eval.evaluator import MULTIHOP_DATASETS, evaluate_predictions
    from probing_rag_tpu_torch.eval.metrics import EmF1Metric, SupportEmF1Metric
    from probing_rag_tpu_torch.eval.results import RunRecord, result_filename, save_run

    _f32_matmuls()
    pipeline = _build_pipeline(args, args.retr_method)
    questions, answers = _load_questions(args)
    t0 = time.time()
    result = pipeline.run(questions)
    elapsed = time.time() - t0
    metric = SupportEmF1Metric() if args.dataset in MULTIHOP_DATASETS else EmF1Metric()
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
    _log_report()


def cmd_dataset_make(args):
    from probing_rag_tpu_torch.pipeline.dataset_builder import extract_cot_dataset, save_rows

    _f32_matmuls()
    pipeline = _build_pipeline(args, args.retr_method)
    questions, answers = _load_questions(args)
    rows = extract_cot_dataset(pipeline, questions, answers, args.dataset)
    out = Path(args.out)
    save_rows(rows, out)
    print(f"{len(rows)} rows -> {out}")


def cmd_prober_train(args):
    from probing_rag_tpu_torch.pipeline.dataset_builder import balance_and_merge, load_rows
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig, train_probers
    from probing_rag_tpu_torch.utils.checkpoint import save_pytree
    from probing_rag_tpu_torch.utils.logging import JsonlWriter

    _f32_matmuls()
    params, cfg, tok = _load_model(args)
    row_sets = [load_rows(Path(p)) for p in args.data]
    examples = balance_and_merge(row_sets, pos_ratio=args.pos_ratio, seed=args.seed)
    split = max(1, int(len(examples) * 0.9))
    tc = ProberTrainConfig(
        layers=cfg.probe_layers,
        positions=tuple(args.positions.split(",")),
        method=args.method,
        lr=args.lr,
        batch_size=args.batch_size,
        epochs=args.epochs,
        max_len=args.max_len,
        seed=args.seed,
    )
    writer = JsonlWriter(Path(args.out) / "train_log.jsonl")
    stacked, _ = train_probers(params, cfg, tok, examples[:split], examples[split:], tc,
                               log=writer.write)
    save_pytree(
        Path(args.out) / "probers",
        stacked,
        meta={"sites": [list(s) for s in tc.sites], "method": tc.method,
              "model_id": args.model_id},
    )
    print(f"trained {len(tc.sites)} probers on {split} examples -> {args.out}")


def cmd_prober_eval(args):
    """Offline layer-wise prober classification accuracy over held-out
    generation CSVs, with an optional per-layer logit dump for KDE
    analysis."""
    import numpy as np

    from probing_rag_tpu_torch.eval.analysis import prober_offline_eval
    from probing_rag_tpu_torch.pipeline.dataset_builder import balance_and_merge, load_rows
    from probing_rag_tpu_torch.prober.train import ProberTrainConfig, init_prober_stack
    from probing_rag_tpu_torch.utils.checkpoint import load_pytree
    from probing_rag_tpu_torch.weights import probers_from_jax

    _f32_matmuls()
    params, cfg, tok = _load_model(args)
    examples = balance_and_merge([load_rows(Path(p)) for p in args.data], seed=args.seed)
    tc = ProberTrainConfig(
        layers=cfg.probe_layers,
        positions=tuple(args.positions.split(",")),
        max_len=args.max_len,
    )
    template = init_prober_stack(tc, cfg.d_model, torch.Generator(device=args.device).manual_seed(0),
                                 device=args.device)
    probers, _ = load_pytree(Path(args.probers), like=template)
    probers = _checked_stack(probers_from_jax(probers, device=args.device), template, cfg, tc)
    result = prober_offline_eval(params, cfg, tok, examples, probers, tc,
                                 collect_logits=bool(args.kde_out))
    print(f"{'layer':>6} {'position':>12} {'accuracy':>9}")
    for (layer, pos), acc in zip(tc.sites, result.site_accuracy):
        print(f"{layer:>6} {pos:>12} {acc:>9.4f}")
    if args.kde_out:
        np.save(args.kde_out, result.logits)
        print(f"logits for KDE -> {args.kde_out}")


def cmd_rag_sweep(args):
    """Threshold / prober-ablation sweep (the reference's published
    ablations): reruns the probing pipeline over the grid and tabulates
    accuracy, EM, F1 and mean retrieval steps per setting."""
    from probing_rag_tpu_torch.eval.evaluator import MULTIHOP_DATASETS, evaluate_predictions
    from probing_rag_tpu_torch.eval.metrics import EmF1Metric, SupportEmF1Metric

    _f32_matmuls()
    pipeline = _build_pipeline(args, "probing")
    questions, answers = _load_questions(args)
    multihop = args.dataset in MULTIHOP_DATASETS
    thresholds = [float(t) for t in args.thresholds.split(",")]
    ablations = [int(a) for a in args.ablations.split(",")]
    print(f"{'thr':>6} {'abl':>4} {'acc':>8} {'em':>7} {'f1':>7} {'avg_steps':>9}")
    for thr in thresholds:
        for abl in ablations:
            # the pipeline reads threshold and ablation from .rag at each gate
            pipeline.rag = dataclasses.replace(pipeline.rag, threshold=thr, ablation=abl)
            result = pipeline.run(questions)
            metric = SupportEmF1Metric() if multihop else EmF1Metric()
            acc, metric, _ = evaluate_predictions(
                result.pred_list, answers, metric, dataset_name=args.dataset,
            )
            m = metric.get_metric()
            em, f1 = (m["title_em"], m["title_f1"]) if multihop else (m["em"], m["f1"])
            avg_steps = sum(result.retr_count_list) / max(len(result.retr_count_list), 1)
            scored = [a for a in acc if a is not None]  # None = metric-skipped
            accuracy = sum(scored) / max(len(scored), 1)
            print(f"{thr:>6} {abl:>4} {accuracy:>8.4f} {em:>7} {f1:>7} {avg_steps:>9.2f}")


def cmd_analyze(args):
    """Offline analysis report over persisted runs: retrieval-step
    distribution, comparison against the published tables,
    inverse-weighted averages; ``--report`` also writes report.md (and the
    figures, from ``--kde-logits`` / ``--site-accuracy``)."""
    import json

    from probing_rag_tpu_torch.eval.analysis import (
        DATASETS,
        PUBLISHED,
        PUBLISHED_RETRIEVAL_CALLS,
        inverse_weighted_average,
        retrieval_step_distribution,
    )

    runs = []
    for line in Path(args.runs).read_text().splitlines():
        if line.strip():
            runs.append(json.loads(line))
    if not runs:
        print("no runs found")
        return
    print(f"{len(runs)} runs from {args.runs}\n")
    for run in runs:
        em = run.get("em")
        f1 = run.get("f1")
        print(f"- {run['retr_method']:10s} {run['dataset']:16s} "
              f"acc={run['accuracy']:.4f} em={em} f1={f1} time={run['elapsed_s']:.0f}s")
        if run.get("retr_counts"):
            dist = retrieval_step_distribution(run["retr_counts"])
            print(f"    steps: no={dist['no_retrieval_pct']:.1f}% single={dist['single_pct']:.1f}% "
                  f"multi={dist['multi_pct']:.1f}% calls={dist['total_calls']} "
                  f"(published Probing-RAG: 57.46/20.19/22.35)")
    print("\npublished EM targets (BASELINE.md):")
    for method, row in PUBLISHED["em"].items():
        print(f"  {method:14s} " + " ".join(f"{d}={v}" for d, v in zip(DATASETS, row)))
    print("\ninverse-weighted accuracy averages (published):")
    for m, v in inverse_weighted_average(PUBLISHED["accuracy"]).items():
        print(f"  {m:14s} {v:.2f}")
    print("\npublished total retrieval calls (2500 queries):", PUBLISHED_RETRIEVAL_CALLS)

    if args.report:
        import numpy as np

        from probing_rag_tpu_torch.eval.figures import assemble_report

        kde = np.load(args.kde_logits) if args.kde_logits else None
        site_acc = json.loads(Path(args.site_accuracy).read_text()) if args.site_accuracy else None
        layers = [int(x) for x in args.layers.split(",")]
        report = assemble_report(runs, Path(args.report), kde_logits=kde,
                                 site_accuracy=site_acc, layers=layers)
        print(f"\nreport -> {report}")


def _parity_preflight(args, datasets):
    """Print which of the parity run's inputs are present and which are
    missing. Never aborts: without them the drill runs the synthetic
    fixture chain."""
    from probing_rag_tpu_torch.data.qa import dataset_path

    rows = []

    def check(label, ok, hint):
        rows.append((label, ok, hint))

    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if ckpt is None:
        check("checkpoint", False,
              "--checkpoint DIR with google/gemma-2b safetensors "
              "(RUNBOOK.md §0); without it the drill runs the synthetic "
              "fixture chain")
    else:
        has_st = bool(list(ckpt.glob("*.safetensors"))) if ckpt.is_dir() else False
        check(f"checkpoint safetensors ({ckpt})", has_st,
              "download google/gemma-2b and point --checkpoint at it")
        sp = Path(args.tokenizer) if args.tokenizer else ckpt / "tokenizer.model"
        check(f"sentencepiece model ({sp})", sp.exists(),
              "tokenizer.model from the same checkpoint (pad=eos parity, "
              "exp_rag.py:304); or pass --tokenizer PATH")
    raw = Path(args.raw_dir)
    for ds in datasets:
        for split in ("train", "dev"):
            try:
                p = dataset_path(raw, ds, split)
            except ValueError:
                check(f"dataset {ds}/{split}", False, "unknown dataset name")
                continue
            check(f"dataset {ds}/{split} ({p})", p.exists(),
                  "scripts/download_data.sh fetches the reference layout")
    missing = [r for r in rows if not r[1]]
    print("[parity preflight] artifact checklist:")
    for label, ok, hint in rows:
        mark = "ok " if ok else "MISSING"
        print(f"  [{mark:7s}] {label}" + ("" if ok else f" -> {hint}"))
    if missing:
        print(f"[parity preflight] {len(missing)} artifact(s) missing — "
              "running the synthetic-fixture drill; the published-number "
              "reproduction needs every row green (RUNBOOK.md).")
    else:
        print("[parity preflight] all artifacts present — this run "
              "reproduces the BASELINE.md protocol.")


def cmd_parity(args):
    """One-command parity drill: the reference's five-step workflow (index
    build -> prober-dataset make, simple and none -> prober train ->
    probing RAG eval per dataset -> analyze against the published tables)
    chained through the same commands as the manual steps, each on
    ``--device``.

    With ``--checkpoint`` at a google/gemma-2b checkpoint and ``--raw-dir``
    holding the datasets, it runs the published protocol. Without a
    checkpoint (or with ``--fixture-scale``) it runs the same chain on a
    synthetic fixture corpus with the random-init tiny model."""
    import json

    import numpy as np

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    datasets = args.datasets.split(",")
    _parity_preflight(args, datasets)
    base = ["--device", args.device]
    if args.checkpoint:
        base += ["--checkpoint", args.checkpoint]
        if args.tokenizer:
            base += ["--tokenizer", args.tokenizer]

    if args.checkpoint and not args.fixture_scale:
        def corpus_args(ds):
            return ["--dataset", ds, "--raw-dir", args.raw_dir]

        def qa_args(ds, split):
            return ["--dataset", ds, "--split", split, "--raw-dir", args.raw_dir]
    else:
        # synthetic fixture path: one shared corpus + per-dataset QA files
        rng = np.random.default_rng(args.seed)
        topics = ["paris france capital", "nile africa river", "gemma language model",
                  "tpu google accelerator", "everest tallest mountain"]
        corpus_path = work / "corpus.txt"
        corpus_path.write_text("\n".join(
            f"{t} fact {i} " + " ".join(rng.choice(list("abcdefgh"), 3))
            for i, t in enumerate(topics * 8)
        ))
        qa = [
            {"question": "What is the capital of France?", "answers": ["paris"]},
            {"question": "Which river is in Africa?", "answers": ["nile"]},
            {"question": "What is the tallest mountain?", "answers": ["everest"]},
            {"question": "Who makes TPUs?", "answers": ["google"]},
        ]
        qa_path = work / "qa.json"
        qa_path.write_text(json.dumps(qa))

        def corpus_args(ds):
            return ["--dataset", ds, "--fixture", str(corpus_path)]

        def qa_args(ds, split):
            return ["--dataset", ds, "--split", split, "--fixture-qa", str(qa_path)]

    results_dir = work / "result"
    steps = ["--steps-limit", str(args.steps_limit),
             "--max-new-tokens", str(args.max_new_tokens),
             "--batch-size", str(args.batch_size),
             "--results-dir", str(results_dir)]

    print(f"[parity 1/5] index build -> {work}/index_*")
    for ds in datasets:
        main(["index-build", *base, *corpus_args(ds), "--out", str(work / f"index_{ds}")])

    print("[parity 2/5] prober-dataset make (simple + none, train split)")
    ds0 = datasets[0]
    row_files = []
    for method in ("simple", "none"):
        out = work / f"rows_{method}.csv"
        main(["dataset-make", *base, *qa_args(ds0, "train"),
              "--retr-method", method,
              "--index", str(work / f"index_{ds0}"),
              "--out", str(out), *steps])
        row_files.append(str(out))

    print("[parity 3/5] prober training")
    main(["prober-train", *base, "--data", *row_files,
          "--out", str(work / "probers"),
          "--epochs", str(args.epochs),
          "--batch-size", str(args.batch_size)])

    print("[parity 4/5] probing RAG eval per dataset")
    for ds in datasets:
        main(["rag-run", *base, *qa_args(ds, "dev"),
              "--retr-method", "probing",
              "--index", str(work / f"index_{ds}"),
              "--probers", str(work / "probers" / "probers"), *steps])

    print("[parity 5/5] analysis vs published tables")
    main(["analyze", "--runs", str(results_dir / "runs.jsonl"),
          "--report", str(work / "report")])
    print(f"parity drill complete -> {work}")


def cmd_param_audit(args):
    """Prober-vs-classifier parameter audit (the reference's
    exp_parameter_check)."""
    from probing_rag_tpu_torch.prober.model import init_improved_probe, probe_param_count

    gen = torch.Generator(device=args.device).manual_seed(0)
    probe = init_improved_probe(gen, args.d_model, device=args.device)
    n = probe_param_count(probe)
    t5_large = 737_668_096  # Adaptive-RAG's T5-large classifier
    print(f"prober params:            {n:>13,} ({n * 4 / 2**20:.2f} MB fp32)")
    print(f"adaptive-rag T5 classifier:{t5_large:>13,} ({t5_large * 4 / 2**20:.2f} MB fp32)")
    print(f"ratio: {t5_large / n:.0f}x")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="probing-rag-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
        sp.add_argument("--model-id", default="google/gemma-2b")
        sp.add_argument("--checkpoint", default=None, help="HF checkpoint dir (safetensors)")
        sp.add_argument("--tokenizer", default=None, help="sentencepiece model path")
        sp.add_argument("--seed", type=int, default=42)
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
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--raw-dir", default="raw_data")
    sp.add_argument("--out", required=True)
    sp.add_argument("--fixture", default=None, help="plain-text corpus file (one doc/line)")
    sp.set_defaults(fn=cmd_index_build)

    def rag_common(sp):
        common(sp)
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

    sp = sub.add_parser("rag-run")
    rag_common(sp)
    sp.add_argument("--retr-method", default="probing", choices=["probing", "none", "simple"])
    sp.set_defaults(fn=cmd_rag_run)

    sp = sub.add_parser("dataset-make")
    rag_common(sp)
    sp.add_argument("--retr-method", default="simple", choices=["none", "simple"])
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_dataset_make)

    sp = sub.add_parser("prober-train")
    common(sp)
    sp.add_argument("--data", nargs="+", required=True, help="extracted CSV(s)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--method", default="tokens_mean",
                    choices=["tokens_mean", "last_token", "each_token"])
    sp.add_argument("--positions", default="resid_mid,resid_post")
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--epochs", type=int, default=2)
    sp.add_argument("--max-len", type=int, default=1536)
    sp.add_argument("--pos-ratio", type=float, default=0.5)
    sp.set_defaults(fn=cmd_prober_train)

    sp = sub.add_parser("prober-eval")
    common(sp)
    sp.add_argument("--data", nargs="+", required=True, help="extracted CSV(s)")
    sp.add_argument("--probers", required=True)
    sp.add_argument("--positions", default="resid_post")
    sp.add_argument("--max-len", type=int, default=1536)
    sp.add_argument("--kde-out", default=None, help="npy path for logit dump")
    sp.set_defaults(fn=cmd_prober_eval)

    sp = sub.add_parser("rag-sweep")
    rag_common(sp)
    sp.add_argument("--thresholds", default="-2,-1,0,1,2")
    sp.add_argument("--ablations", default="0")
    sp.set_defaults(fn=cmd_rag_sweep)

    sp = sub.add_parser("analyze")
    sp.add_argument("--runs", default="result/runs.jsonl")
    sp.add_argument("--report", default=None,
                    help="dir for report.md + figures (KDE, layer heatmap)")
    sp.add_argument("--kde-logits", default=None,
                    help="npy logit dump from prober-eval --kde-out")
    sp.add_argument("--site-accuracy", default=None,
                    help="json {position: [per-layer acc]} for the heatmap")
    sp.add_argument("--layers", default="6,8,10,12,14,16")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("parity")
    common(sp)
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--raw-dir", default="raw_data")
    sp.add_argument("--datasets", default="nq,trivia,hotpotqa,2wikimultihopqa,musique")
    sp.add_argument("--steps-limit", type=int, default=500)
    sp.add_argument("--max-new-tokens", type=int, default=150)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--epochs", type=int, default=2)
    sp.add_argument("--fixture-scale", action="store_true",
                    help="synthetic fixture corpus even with a checkpoint")
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("param-audit")
    sp.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    sp.add_argument("--d-model", type=int, default=2048)
    sp.set_defaults(fn=cmd_param_audit)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
