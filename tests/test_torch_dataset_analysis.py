"""The port's dataset construction, offline analysis, checkpoints and run
logs against the JAX package's, on the CPU.

- ``extract_cot_dataset`` over a stub pipeline (the same generations on
  both sides), with one row whose metric update fails: equal rows, the
  unlabeled row dropped after the zip.
- ``save_rows`` CSV bytes equal; ``load_rows`` equal and never evaluates
  code; ``balance_and_merge`` equal for several ratios and seeds.
- Every function of ``eval/analysis.py``; ``prober_offline_eval`` on the
  tiny f32 model with a ragged last batch: accuracies equal, logits
  allclose at rtol 1e-4 / atol 1e-4 (f32 forward sums in another order).
- ``save_pytree`` / ``load_pytree``: each package reads the other's
  checkpoints (bf16 leaves too), with and without a template.
- ``JsonlWriter`` records."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import probing_rag_tpu.pipeline.dataset_builder as jdb
import probing_rag_tpu_torch.pipeline.dataset_builder as tdb
from probing_rag_tpu.data import prompts as jprompts
from probing_rag_tpu.eval import analysis as jan
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu.pipeline.rag import RAGResult as JaxRAGResult
from probing_rag_tpu.prober import train as jtrain
from probing_rag_tpu.utils import checkpoint as jckpt
from probing_rag_tpu_torch.eval import analysis as tan
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.pipeline.rag import RAGResult
from probing_rag_tpu_torch.prober import train as ttrain
from probing_rag_tpu_torch.utils import checkpoint as tckpt
from probing_rag_tpu_torch.utils.logging import JsonlWriter, get_logger
from probing_rag_tpu_torch.weights import lm_params_from_jax, probers_from_jax

from test_torch_gemma import numpy_params, to_jax
from test_torch_prober import numpy_stack

torch.set_num_threads(1)

QUESTIONS = ["where is the eiffel tower?", "who wrote hamlet?", "what is 2+2?",
             "which ocean is the largest?", "what is the capital of italy?"]
ANSWERS = [["Paris"], ["Shakespeare", "William Shakespeare"], ["4"], ["Pacific"], ["Rome"]]
GENERATIONS = [" The tower stands in Paris.\nAnswer: Paris", " Hamlet, \"a play\", by Marlowe.\nAnswer: Marlowe",
               " 2+2=4.\nAnswer: 4", "", " Italy's capital, Rome.\nAnswer: Rome, Italy"]


class StubPipeline:
    """``run`` returns CoT prompts + fixed generations, as the pipeline's
    ``pred_list`` holds prompt + generation."""

    def __init__(self, method, result_cls):
        self.rag = type("Rag", (), {"retr_method": method})()
        self.result_cls = result_cls

    def run(self, questions):
        preds = [jprompts.cot_prompt(q) + g for q, g in zip(questions, GENERATIONS)]
        return self.result_cls(preds, [0] * len(preds))


@pytest.mark.parametrize("method", ["none", "simple"])
def test_extract_cot_dataset_matches_jax(method, monkeypatch):
    def skip_second(real):
        def wrapped(*args, **kw):
            acc, metric, train = real(*args, **kw)
            return [None if i == 1 else a for i, a in enumerate(acc)], metric, train
        return wrapped

    monkeypatch.setattr(jdb, "evaluate_predictions", skip_second(jdb.evaluate_predictions))
    monkeypatch.setattr(tdb, "evaluate_predictions", skip_second(tdb.evaluate_predictions))
    for dataset in ("nq", "hotpotqa"):
        j = jdb.extract_cot_dataset(StubPipeline(method, JaxRAGResult), QUESTIONS, ANSWERS, dataset)
        t = tdb.extract_cot_dataset(StubPipeline(method, RAGResult), QUESTIONS, ANSWERS, dataset)
        assert [dataclasses.astuple(r) for r in t] == [dataclasses.astuple(r) for r in j]
        assert len(t) == 4 and t[1].answer == ["4"]  # row 1 dropped, later rows keep their labels
        assert [r.acc for r in t] == [1, 1, 0, 1]
    with pytest.raises(ValueError):
        tdb.extract_cot_dataset(StubPipeline("probing", RAGResult), QUESTIONS, ANSWERS, "nq")


def rows(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pred = "" if i % 9 == 4 else f" step {i}, \"quoted\"\nAnswer: ans{i} café"
        prompt = f"Question: q{i}, with a comma\nRationale:" + pred
        out.append((prompt, pred, [f"ans{i}", "it's \"x\""], int(rng.random() < 0.3)))
    return out


def test_rows_csv_bytes_load_and_balance_match_jax(tmp_path):
    data = rows()
    tdb.save_rows([tdb.ExtractedRow(*r) for r in data], tmp_path / "t" / "rows.csv")
    jdb.save_rows([jdb.ExtractedRow(*r) for r in data], tmp_path / "j" / "rows.csv")
    assert (tmp_path / "t" / "rows.csv").read_bytes() == (tmp_path / "j" / "rows.csv").read_bytes()
    t_rows = tdb.load_rows(tmp_path / "j" / "rows.csv")
    j_rows = jdb.load_rows(tmp_path / "t" / "rows.csv")
    assert [dataclasses.astuple(r) for r in t_rows] == [dataclasses.astuple(r) for r in j_rows] == \
        [tuple(r) for r in data]
    other = [tdb.ExtractedRow(*r) for r in rows(25, seed=1)]
    j_other = [jdb.ExtractedRow(*dataclasses.astuple(r)) for r in other]
    for ratio, seed in ((0.5, 0), (0.5, 3), (0.3, 1), (0.8, 2)):
        t = tdb.balance_and_merge([t_rows, other], pos_ratio=ratio, seed=seed)
        j = jdb.balance_and_merge([j_rows, j_other], pos_ratio=ratio, seed=seed)
        assert [dataclasses.astuple(e) for e in t] == [dataclasses.astuple(e) for e in j]
        assert all(isinstance(e, ttrain.ProberExample) and e.pred.strip() for e in t)
    assert [dataclasses.astuple(e) for e in tdb.balance_and_merge([[r for r in t_rows if r.acc]])] == \
        [dataclasses.astuple(e) for e in jdb.balance_and_merge([[r for r in j_rows if r.acc]])]


def test_load_rows_never_evaluates_code(tmp_path):
    path = tmp_path / "evil.csv"
    path.write_text('pred_with_prompt,pred,answer,acc\np,x,"__import__(\'os\').getcwd()",1\n')
    with pytest.raises(ValueError):
        tdb.load_rows(path)


def test_analysis_functions_match_jax():
    assert tan.PUBLISHED == jan.PUBLISHED
    assert tan.PUBLISHED_RETRIEVAL_CALLS == jan.PUBLISHED_RETRIEVAL_CALLS
    assert tan.DATASETS == jan.DATASETS
    rng = np.random.default_rng(3)
    yt, yp = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    np.testing.assert_array_equal(tan.confusion_matrix(yt, yp), jan.confusion_matrix(yt, yp))
    np.testing.assert_array_equal(tan.confusion_matrix([0, 2, 1], [2, 2, 0], 3),
                                  jan.confusion_matrix([0, 2, 1], [2, 2, 0], 3))
    for counts in (rng.integers(0, 4, 30).tolist(), [], [0, 0]):
        assert tan.retrieval_step_distribution(counts) == jan.retrieval_step_distribution(counts)
    x, y = rng.random(6), rng.random(6)
    assert tan.pearson_correlation(x, y) == jan.pearson_correlation(x, y)
    assert tan.pearson_correlation([1, 1, 1], [1, 2, 3]) == jan.pearson_correlation([1, 1, 1], [1, 2, 3]) == 0.0
    for table in jan.PUBLISHED.values():
        assert tan.inverse_weighted_average(table) == jan.inverse_weighted_average(table)
    d, m = rng.integers(0, 2, 40).tolist(), rng.integers(0, 2, 40).tolist()
    assert tan.consistency_with_direct_qa(d, m) == jan.consistency_with_direct_qa(d, m)
    assert tan.consistency_with_direct_qa([0, 0], [1, 1]) == 0.0


def test_prober_offline_eval_matches_jax():
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)
    tree = numpy_params(jcfg)
    data = [("question alpha", "yes yes yes", 1), ("question beta", "no no", 0),
            ("a longer question here", "maybe so", 1), ("q", "", 0), ("what?", "yes", 1)]
    kw = dict(layers=jcfg.probe_layers, positions=("resid_mid", "resid_post"), max_len=32)
    stack = numpy_stack(4, jcfg.d_model, seed=4)
    j = jan.prober_offline_eval(to_jax(tree), jcfg, JaxByteTokenizer(512),
                                [jtrain.ProberExample(*e) for e in data], to_jax(stack),
                                jtrain.ProberTrainConfig(**kw), collect_logits=True, batch_size=2)
    t = tan.prober_offline_eval(lm_params_from_jax(tree, tcfg, device="cpu"), tcfg, ByteTokenizer(512),
                                [ttrain.ProberExample(*e) for e in data],
                                probers_from_jax(stack, device="cpu"),
                                ttrain.ProberTrainConfig(**kw), collect_logits=True, batch_size=2)
    assert t.n_examples == j.n_examples == 5
    assert t.logits.shape == j.logits.shape == (5, 4, 2)
    np.testing.assert_allclose(t.logits, j.logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t.site_accuracy, j.site_accuracy)
    none = tan.prober_offline_eval(lm_params_from_jax(tree, tcfg, device="cpu"), tcfg,
                                   ByteTokenizer(512), [ttrain.ProberExample(*e) for e in data],
                                   probers_from_jax(stack, device="cpu"), ttrain.ProberTrainConfig(**kw))
    assert none.logits is None
    np.testing.assert_array_equal(none.site_accuracy, t.site_accuracy)


# ------------------------------------------------------------- checkpoints


def tree_with_bf16(seed=5):
    rng = np.random.default_rng(seed)
    return {"probers": numpy_stack(3, 8, seed=seed, hidden=4),
            "lm": {"embed": rng.standard_normal((5, 3)).astype(np.float32),
                   "steps": np.arange(4, dtype=np.int32), "q": rng.integers(-127, 128, (2, 3)).astype(np.int8)}}


def test_jax_reads_port_checkpoint(tmp_path):
    base = tree_with_bf16()
    port_tree = {"probers": probers_from_jax(base["probers"], device="cpu"),
                 "lm": {k: torch.from_numpy(v) for k, v in base["lm"].items()}}
    port_tree["lm"]["embed"] = port_tree["lm"]["embed"].to(torch.bfloat16)
    meta = {"sites": [[1, "resid_post"]], "method": "tokens_mean"}
    tckpt.save_pytree(tmp_path / "ck", port_tree, meta=meta)
    manifest = json.loads((tmp_path / "ck.json").read_text())
    assert manifest["exotic_dtypes"] == {"lm/embed": "bfloat16"}
    assert manifest["keys"] == sorted(manifest["keys"]) and "probers/fc1/w" in manifest["keys"]
    assert manifest["treedef"].startswith("{'lm': {'embed': *")
    template = jax.tree.map(jnp.asarray, {**base, "lm": {**base["lm"],
                                                        "embed": base["lm"]["embed"].astype(ml_dtypes.bfloat16)}})
    got, got_meta = jckpt.load_pytree(tmp_path / "ck", like=template)
    assert got_meta == meta
    assert got["lm"]["embed"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["lm"]["embed"].astype(np.float32),
                                  port_tree["lm"]["embed"].float().numpy())
    for m, s in base["probers"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(got["probers"][m][k], v)
    np.testing.assert_array_equal(got["lm"]["q"], base["lm"]["q"])
    nested, _ = jckpt.load_pytree(tmp_path / "ck")
    assert sorted(nested) == ["lm", "probers"]


def test_port_reads_jax_checkpoint_with_template(tmp_path):
    base = tree_with_bf16(6)
    jtree = jax.tree.map(jnp.asarray, base)
    jtree["lm"]["embed"] = jtree["lm"]["embed"].astype(jnp.bfloat16)
    jckpt.save_pytree(tmp_path / "ck", jtree, meta={"k": 1})
    template = {"probers": probers_from_jax(numpy_stack(3, 8, hidden=4), device="cpu"),
                "lm": {"embed": torch.zeros(5, 3, dtype=torch.bfloat16), "steps": torch.zeros(4),
                       "q": torch.zeros(2, 3)}}
    got, meta = tckpt.load_pytree(tmp_path / "ck", like=template)
    assert meta == {"k": 1} and list(got) == list(template)
    assert list(got["probers"]) == list(template["probers"])
    assert got["lm"]["embed"].dtype == torch.bfloat16 and got["lm"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["lm"]["embed"].float().numpy(),
                                  np.asarray(jtree["lm"]["embed"]).astype(np.float32))
    for m, s in base["probers"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(got["probers"][m][k].numpy(), v)
    # a round trip through the port alone, and a template that does not match
    tckpt.save_pytree(tmp_path / "again", got, meta={"k": 2})
    again, _ = tckpt.load_pytree(tmp_path / "again")
    np.testing.assert_array_equal(again["lm"]["embed"].view(torch.int16).numpy(),
                                  got["lm"]["embed"].view(torch.int16).numpy())
    del template["lm"]["q"]
    with pytest.raises(ValueError, match="keys mismatch"):
        tckpt.load_pytree(tmp_path / "ck", like=template)


def test_jsonl_writer_and_logger(tmp_path):
    w = JsonlWriter(tmp_path / "logs" / "train_log.jsonl")
    w.write({"epoch": 0, "losses": torch.tensor([0.5, 0.25]), "acc": np.asarray([1.0, 0.5]),
             "n": np.int64(3), "x": np.float32(0.5), "other": object})
    w.write({"epoch": 1})
    lines = [json.loads(l) for l in (tmp_path / "logs" / "train_log.jsonl").read_text().splitlines()]
    assert [l["epoch"] for l in lines] == [0, 1] and all("ts" in l for l in lines)
    assert lines[0]["losses"] == [0.5, 0.25] and lines[0]["acc"] == [1.0, 0.5]
    assert lines[0]["n"] == 3 and lines[0]["x"] == 0.5 and isinstance(lines[0]["other"], str)
    JsonlWriter(None).write({"dropped": True})
    log = get_logger("probing_rag_tpu_torch.test")
    get_logger("probing_rag_tpu_torch.test2")
    import logging

    assert len(logging.getLogger("probing_rag_tpu_torch").handlers) == 1
    assert log.name == "probing_rag_tpu_torch.test"
