"""The port's CLI chain on the CPU with the tiny f32 model: ``index-build``
-> ``dataset-make`` (none and simple) -> ``prober-train`` ->
``prober-eval`` -> ``rag-run --probers``, and ``param-audit``.

Half the questions have the gold answer "rationale", which every CoT
answer block holds (the block starts at the prompt's ``Rationale:``), the
other half one no block holds, so both labels occur. The prober
checkpoint that ``prober-train`` writes is read by the JAX package's
``load_pytree(like=template)`` and by ``rag-run --probers`` unchanged."""

import json

import jax
import numpy as np
import pytest
import torch

from probing_rag_tpu.prober.train import ProberTrainConfig as JaxProberTrainConfig
from probing_rag_tpu.prober.train import init_prober_stack as jax_init_prober_stack
from probing_rag_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from probing_rag_tpu_torch.cli import main as cli
from probing_rag_tpu_torch.pipeline.dataset_builder import load_rows

torch.set_num_threads(1)

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "paris is the capital of france",
    "the eiffel tower is in central paris",
    "mount everest is the tallest mountain on earth",
    "the pacific ocean is the largest and the deepest ocean",
    "water boils at hundred degrees",
]
QUESTIONS = ["where is the eiffel tower?", "which ocean is the largest?",
             "what is the tallest mountain?", "what is the capital of france?",
             "when does water boil?", "what jumps over the lazy dog?"]
SITES = [[1, "resid_mid"], [1, "resid_post"], [2, "resid_mid"], [2, "resid_post"]]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain")
    (d / "corpus.txt").write_text("\n".join(CORPUS))
    qa = [{"question": q, "answers": ["rationale"] if i % 2 == 0 else ["no such answer"]}
          for i, q in enumerate(QUESTIONS)]
    (d / "qa.json").write_text(json.dumps(qa))
    cli.main(["index-build", "--dataset", "nq", "--fixture", str(d / "corpus.txt"),
              "--out", str(d / "idx")])
    common = ["--device", "cpu", "--dataset", "nq", "--fixture-qa", str(d / "qa.json"),
              "--index", str(d / "idx"), "--max-new-tokens", "6", "--batch-size", "4"]
    for method in ("none", "simple"):
        cli.main(["dataset-make", *common, "--retr-method", method,
                  "--out", str(d / f"rows_{method}.csv")])
    cli.main(["prober-train", "--device", "cpu", "--data", str(d / "rows_none.csv"),
              str(d / "rows_simple.csv"), "--out", str(d / "probers"), "--max-len", "192",
              "--batch-size", "2", "--epochs", "2", "--lr", "3e-3"])
    return d, common


def test_dataset_make_rows(chain):
    d, _ = chain
    for method in ("none", "simple"):
        rows = load_rows(d / f"rows_{method}.csv")
        assert len(rows) == len(QUESTIONS)
        assert [r.acc for r in rows] == [1, 0] * (len(QUESTIONS) // 2)
        assert all(r.pred.strip() and r.pred in r.pred_with_prompt for r in rows)
        # under 8 lines (fewer than 5 passages matched) the block keeps all
        # but the paragraph's first line, as the reference's evaluator does
        assert all(r.pred.startswith("Rationale:" if method == "none" else "passage 1:") for r in rows)
        assert ("passage 1:" in rows[0].pred_with_prompt) == (method == "simple")


def test_prober_train_writes_checkpoint_jax_reads(chain):
    d, _ = chain
    manifest = json.loads((d / "probers" / "probers.json").read_text())
    assert manifest["meta"] == {"sites": SITES, "method": "tokens_mean", "model_id": "google/gemma-2b"}
    log = [json.loads(l) for l in (d / "probers" / "train_log.jsonl").read_text().splitlines()]
    # 12 balanced examples, 10 train (5 batches of 2) and 2 dev, 2 epochs
    assert [r["epoch"] for r in log if "losses" in r] == [0] * 5 + [1] * 5
    assert all(len(r["losses"]) == 4 and np.isfinite(r["losses"]).all() for r in log if "losses" in r)
    assert [len(r["dev_acc"]) for r in log if "dev_acc" in r] == [4, 4]
    tc = JaxProberTrainConfig(layers=(1, 2), positions=("resid_mid", "resid_post"))
    template = jax_init_prober_stack(tc, 64, jax.random.PRNGKey(0))
    tree, meta = jax_load_pytree(d / "probers" / "probers", like=template)
    assert meta["sites"] == SITES
    for m, sub in template.items():
        for k, v in sub.items():
            assert tree[m][k].shape == v.shape and tree[m][k].dtype == np.float32
            assert np.isfinite(tree[m][k]).all()
    assert not np.array_equal(tree["fc1"]["w"], np.asarray(template["fc1"]["w"]))


def test_prober_eval(chain, capsys):
    d, _ = chain
    cli.main(["prober-eval", "--device", "cpu", "--data", str(d / "rows_none.csv"),
              "--probers", str(d / "probers" / "probers"), "--positions", "resid_mid,resid_post",
              "--max-len", "192", "--kde-out", str(d / "kde.npy")])
    out = capsys.readouterr().out.splitlines()
    table = [l.split() for l in out if l.split() and l.split()[0] in ("1", "2")]
    assert [(int(a), b) for a, b, _ in table] == [tuple(s) for s in SITES]
    assert all(0.0 <= float(acc) <= 1.0 for *_, acc in table)
    assert np.load(d / "kde.npy").shape == (len(QUESTIONS), 4, 2)
    # the gate's one position against a two-position checkpoint: the shapes
    # do not match and the command says so
    with pytest.raises(SystemExit, match="does not match"):
        cli.main(["prober-eval", "--device", "cpu", "--data", str(d / "rows_none.csv"),
                  "--probers", str(d / "probers" / "probers"), "--max-len", "192"])


def test_rag_run_with_trained_probers(chain):
    d, common = chain
    cli.main(["rag-run", *common, "--probers", str(d / "probers" / "probers"),
              "--results-dir", str(d / "result")])
    rec = json.loads((d / "result" / "runs.jsonl").read_text().splitlines()[-1])
    assert len(rec["retr_counts"]) == len(QUESTIONS)
    assert rec["config"]["probers"] == str(d / "probers" / "probers")
    # the gate's stack is the checkpoint's resid_post rows, unconverted
    args = cli.build_parser().parse_args(["rag-run", *common, "--probers",
                                          str(d / "probers" / "probers")])
    from probing_rag_tpu_torch.models.gemma import GemmaConfig

    gate = cli._load_probers(args, GemmaConfig.tiny())
    saved = np.load(d / "probers" / "probers.npz")
    np.testing.assert_array_equal(gate["fc1"]["w"].numpy(), saved["fc1/w"][[1, 3]])
    np.testing.assert_array_equal(gate["ln2"]["b"].numpy(), saved["ln2/b"][[1, 3]])


def test_param_audit(capsys):
    assert cli.build_parser().parse_args(["param-audit"]).device == "cuda"
    cli.main(["param-audit", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "1,318,914" in out and "737,668,096" in out and "ratio: 559x" in out
    cli.main(["param-audit", "--device", "cpu", "--d-model", "64"])
    n = 64 * 2 + (64 * 512 + 512) + 512 * 2 + (512 * 512 + 512) + 512 * 2 + (512 * 2 + 2)
    assert f"{n:,}" in capsys.readouterr().out
