"""The port's copies of the host-side ``data`` and ``eval`` modules against
their JAX-package twins: every prompt template rendered on the same inputs
(byte for byte), EM/F1 and the support metric, answer extraction, the QA
loader on fixture files, the docstore round trip, and the run files. Exact
equality throughout: the modules are pure Python."""

import csv
import json

import pytest

from probing_rag_tpu.data import corpus as jcorpus
from probing_rag_tpu.data import prompts as jprompts
from probing_rag_tpu.data import qa as jqa
from probing_rag_tpu.eval import evaluator as jevaluator
from probing_rag_tpu.eval import metrics as jmetrics
from probing_rag_tpu.eval import results as jresults
from probing_rag_tpu_torch.data import corpus as tcorpus
from probing_rag_tpu_torch.data import prompts as tprompts
from probing_rag_tpu_torch.data import qa as tqa
from probing_rag_tpu_torch.eval import evaluator as tevaluator
from probing_rag_tpu_torch.eval import metrics as tmetrics
from probing_rag_tpu_torch.eval import results as tresults

QUERY = "Who wrote “Les Misérables”, and when?  "
DOCS = "passage 1: Victor Hugo wrote it.\npassage 2: It was published in 1862."
PASSAGES = ["Victor Hugo wrote it.", "Para one.\n\nPara two.", "  naïve café  "]

TEMPLATES = [
    ("cot_prompt", (QUERY,)),
    ("retr_qa_cot2", (QUERY, DOCS)),
    ("retr_qa_cot", (QUERY, DOCS)),
    ("format_evidences", (PASSAGES,)),
    ("inst_prompt", (QUERY,)),
    ("icl_prompt", (QUERY,)),
    ("retr_qa", (QUERY, DOCS)),
    ("dummy_prompt", (QUERY,)),
    ("flare_query_reformulation_prompt", (QUERY, "Hugo wrote ____ in 1862.")),
    ("flare_for_new_sent_prompt", ("Hugo wrote it.", DOCS)),
    ("llm_based_clf_prompt", (QUERY,)),
]


@pytest.mark.parametrize("name,args", TEMPLATES, ids=[t[0] for t in TEMPLATES])
def test_prompt_templates_render_equal(name, args):
    assert getattr(tprompts, name)(*args) == getattr(jprompts, name)(*args)


PREDS = ["The Eiffel Tower", "an apple a day", "Ünïcödé café", "the the", "", "  Paris, France. "]
GOLDS = [["eiffel tower"], ["Apple"], ["Unicode cafe", "ünïcödé café"], ["a"], ["x"], ["paris"]]


def test_emf1_metric_equal():
    tm, jm = tmetrics.EmF1Metric(), jmetrics.EmF1Metric()
    for pred, golds in zip(PREDS, GOLDS):
        tm(pred, golds)
        jm(pred, golds)
        assert tmetrics.normalize_answer(pred) == jmetrics.normalize_answer(pred)
        for g in golds:
            assert tmetrics.compute_exact(g, pred) == jmetrics.compute_exact(g, pred)
            assert tmetrics.compute_f1(g, pred) == jmetrics.compute_f1(g, pred)
    assert tm.get_metric() == jm.get_metric()


def test_support_emf1_metric_equal():
    tm, jm = tmetrics.SupportEmF1Metric(), jmetrics.SupportEmF1Metric()
    cases = [
        (["The Beatles", "Abbey Road"], ["the beatles", "abbey road"]),
        (["Ünïcödé"], ["unicode"]),
        (["an answer"], ["Answer", "other"]),
        ([], []),
    ]
    for pred, gold in cases:
        tm(pred, gold)
        jm(pred, gold)
    assert tm.get_metric() == jm.get_metric()


GENERATIONS = [
    tprompts.cot_prompt("where is the eiffel tower?")
    + " It stands in Paris.\nAnswer: Paris\n\nQuestion: next",
    tprompts.cot_prompt("q") + " rationale\nAnswer: the answer is an Apple",
    "free text answer: Victor Hugo\n\nmore",
    "a\n\nb\n\nAnswer: non-cot block",
]


@pytest.mark.parametrize("kw", [
    dict(), dict(retr_method="dragin"), dict(retr_method="flare"), dict(is_cot=False),
])
def test_extract_answer_equal(kw):
    """Equal blocks, or the same exception where a generation lacks the
    paragraph the form reads."""
    for pred in GENERATIONS:
        try:
            want = jevaluator.extract_answer(pred, **kw)
        except IndexError:
            with pytest.raises(IndexError):
                tevaluator.extract_answer(pred, **kw)
            continue
        assert tevaluator.extract_answer(pred, **kw) == want


@pytest.mark.parametrize("dataset", ["nq", "hotpotqa"])
def test_evaluate_predictions_equal(dataset):
    answers = [["Paris"], ["apple"]]
    t_metric = tmetrics.SupportEmF1Metric() if dataset == "hotpotqa" else tmetrics.EmF1Metric()
    j_metric = jmetrics.SupportEmF1Metric() if dataset == "hotpotqa" else jmetrics.EmF1Metric()
    t_acc, t_m, t_train = tevaluator.evaluate_predictions(
        GENERATIONS[:2], answers, t_metric, dataset_name=dataset)
    j_acc, j_m, j_train = jevaluator.evaluate_predictions(
        GENERATIONS[:2], answers, j_metric, dataset_name=dataset)
    assert (t_acc, t_train, t_m.get_metric()) == (j_acc, j_train, j_m.get_metric())


@pytest.mark.parametrize("dataset", ["nq", "hotpotqa", "musique", "iirc"])
def test_load_qa_dataset_equal(tmp_path, dataset):
    path = tqa.dataset_path(tmp_path, dataset, "dev")
    assert path == jqa.dataset_path(tmp_path, dataset, "dev")
    path.parent.mkdir(parents=True)
    if dataset == "nq":
        rows = [{"question": "where is paris?", "answers": ["France", "fr"]}]
        path.write_text(json.dumps(rows))
    elif dataset == "hotpotqa":
        rows = [{"question": "q1", "answer": "['a' 'b']", "_id": "x1"},
                {"question": "q2", "answer": "yes", "_id": "x2"}]
        path.write_text(json.dumps(rows))
    elif dataset == "musique":
        rows = [{"question": "q", "answer": "Ünïcödé", "id": "m1"}]
        path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    else:
        rows = [{"questions": [
            {"question": "v", "qid": "1", "answer": {"type": "value", "answer_value": "3"}},
            {"question": "s", "qid": "2", "answer": {
                "type": "span", "answer_spans": [{"text": " a "}, {"text": "b"}]}},
            {"question": "n", "qid": "3", "answer": {"type": "none"}},
        ]}]
        path.write_text(json.dumps(rows))
    got = tqa.load_qa_dataset(tmp_path, dataset, "dev")
    want = jqa.load_qa_dataset(tmp_path, dataset, "dev")
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got


def test_docstore_round_trip_equal(tmp_path):
    texts, ids = ["alpha", "béta", "alpha"], ["a", "b", "c"]
    tcorpus.DocStore.from_texts(texts, ids).save(tmp_path / "t.json")
    jcorpus.DocStore.from_texts(texts, ids).save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    loaded = tcorpus.DocStore.load(tmp_path / "j.json")
    assert loaded.texts([2, 1]) == jcorpus.DocStore.load(tmp_path / "t.json").texts([2, 1])
    assert loaded.doc_ids() == ids
    assert tcorpus.hash_object(("t", "x")) == jcorpus.hash_object(("t", "x"))


@pytest.mark.parametrize("dataset,counts", [("nq", [0, 3]), ("hotpotqa", None)])
def test_result_filename_and_save_run_equal(tmp_path, dataset, counts):
    args = (0, "torch", "sparse", dataset, 0.5, "probing", "cot", "dev", 500)
    assert tresults.result_filename(*args) == jresults.result_filename(*args)
    metric = ({"title_em": 0.5, "title_f1": 0.25} if dataset == "hotpotqa"
              else {"em": 0.5, "f1": 0.75, "count": 2})
    kw = dict(retr_method="probing", dataset_name=dataset, elapsed_s=1.5, acc=[1, None],
              metric_out=metric, retr_count_list=counts, config={"seed": 1})
    paths = []
    for side, mod in (("t", tresults), ("j", jresults)):
        paths.append(mod.save_run(mod.RunRecord(**kw), tmp_path / side, "run.csv"))
    rows = [list(csv.reader(p.open())) for p in paths]
    assert rows[0] == rows[1]
    recs = [json.loads((tmp_path / side / "runs.jsonl").read_text()) for side in "tj"]
    for r in recs:
        r.pop("ts")
        r.pop("csv")
    assert recs[0] == recs[1]
