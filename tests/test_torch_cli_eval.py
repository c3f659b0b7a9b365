"""The rest of the port's CLI and its utilities on the CPU, against the JAX
package where it has a counterpart:

- ``analyze``: stdout and ``report.md`` equal to JAX's ``cmd_analyze`` on
  one ``runs.jsonl``; the figures drawn (needs matplotlib);
- ``rag-sweep``: one row per grid point, threshold -1e6 gives no
  retrieval and 1e6 the round cap, on one reused pipeline;
- ``parity --device cpu``: every artifact JAX's drill test checks;
- ``config.preset``: the trees equal to JAX's, field by field;
- ``param_count`` equal to JAX's, at Gemma-2B and Mistral-7B widths too;
- ``init_quantized_lm_params`` bit-equal to ``quantize_lm_params(
  init_params)`` from one seed (int8, grouped and rank-1 int4), with JAX's
  errors for bad ``bits`` and ``int4_scheme``;
- ``utils/profiling.py``'s report in the shape of JAX's
  ``PhaseTimer.report``, and ``wandb_log_adapter`` without wandb."""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu import config as jconfig
from probing_rag_tpu.cli import main as jcli
from probing_rag_tpu.eval import figures as jfigures
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.utils import profiling as jprofiling
from probing_rag_tpu.utils.logging import wandb_log_adapter as jax_wandb_log_adapter
from probing_rag_tpu_torch import config as tconfig
from probing_rag_tpu_torch.cli import main as cli
from probing_rag_tpu_torch.eval import figures as tfigures
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.utils import profiling
from probing_rag_tpu_torch.utils.logging import wandb_log_adapter
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

RUNS = [
    {"retr_method": "probing", "dataset": "nq", "accuracy": 0.25, "em": 12.5, "f1": 20.25,
     "elapsed_s": 31.4, "retr_counts": [0, 1, 3, 0, 2, 0, 0, 1]},
    {"retr_method": "simple", "dataset": "hotpotqa", "accuracy": 0.5, "em": None, "f1": None,
     "elapsed_s": 3.0},
]


@pytest.fixture
def runs_file(tmp_path):
    path = tmp_path / "runs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in RUNS) + "\n")
    return path


def test_analyze_matches_jax(runs_file, tmp_path, capsys):
    jcli.main(["analyze", "--runs", str(runs_file), "--report", str(tmp_path / "jax")])
    want = capsys.readouterr().out
    cli.main(["analyze", "--runs", str(runs_file), "--report", str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "port"), str(tmp_path / "jax")) == want
    assert "report ->" in got
    assert (tmp_path / "port" / "report.md").read_text() == \
        (tmp_path / "jax" / "report.md").read_text()


def test_analyze_without_runs(tmp_path, capsys):
    (tmp_path / "runs.jsonl").write_text("\n")
    cli.main(["analyze", "--runs", str(tmp_path / "runs.jsonl")])
    assert capsys.readouterr().out == "no runs found\n"


def test_report_without_figures_does_not_draw(tmp_path, monkeypatch):
    """A report with no logits and no site accuracies never reaches the
    render functions (the card's machine has no matplotlib)."""
    def no_matplotlib():
        raise AssertionError("matplotlib requested")

    monkeypatch.setattr(tfigures, "_plt", no_matplotlib)
    report = tfigures.assemble_report(RUNS, tmp_path / "r", layers=[6, 8])
    assert report.read_text().startswith("# Probing-RAG run report")
    assert sorted(p.name for p in (tmp_path / "r").iterdir()) == ["report.md"]


def test_report_with_figures_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("scipy")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 6, 2)).astype(np.float32)
    acc = {"resid_mid": [0.6, 0.65, 0.7, 0.68, 0.66, 0.64],
           "resid_post": [0.62, 0.67, 0.718, 0.7, 0.69, 0.66]}
    layers = [6, 8, 10, 12, 14, 16]
    kw = dict(kde_logits=logits, site_accuracy=acc, layers=layers)
    want = jfigures.assemble_report(RUNS, tmp_path / "jax", **kw).read_text()
    got = tfigures.assemble_report(RUNS, tmp_path / "port", **kw).read_text()
    assert got == want
    for name in ("kde_projection.png", "layer_accuracy_heatmap.png"):
        png = (tmp_path / "port" / name).read_bytes()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    (d / "corpus.txt").write_text("\n".join([
        "the quick brown fox jumps over the lazy dog",
        "paris is the capital of france",
        "the eiffel tower is in central paris",
        "mount everest is the tallest mountain on earth",
    ]))
    qa = [{"question": q, "answers": ["paris"]}
          for q in ("where is the eiffel tower?", "what is the capital of france?",
                    "what is the tallest mountain?")]
    (d / "qa.json").write_text(json.dumps(qa))
    cli.main(["index-build", "--dataset", "nq", "--fixture", str(d / "corpus.txt"),
              "--out", str(d / "idx")])
    return d


def test_rag_sweep_rows_and_extremes(fixture_index, capsys, monkeypatch):
    """The sweep reuses one pipeline, swapping ``.rag`` between grid
    points: -1e6 never retrieves, 1e6 runs every round (retr_count 3)."""
    d = fixture_index
    built = []
    build = cli._build_pipeline
    monkeypatch.setattr(cli, "_build_pipeline",
                        lambda *a: built.append(build(*a)) or built[-1])
    cli.main(["rag-sweep", "--device", "cpu", "--dataset", "nq", "--fixture-qa",
              str(d / "qa.json"), "--index", str(d / "idx"), "--max-new-tokens", "4",
              "--batch-size", "2", "--thresholds=-1e6,1e6", "--ablations", "0,1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["thr", "abl", "acc", "em", "f1", "avg_steps"]
    rows = [line.split() for line in lines[1:]]
    assert [(float(r[0]), int(r[1])) for r in rows] == [
        (t, a) for t in (-1e6, 1e6) for a in (0, 1)]
    steps = {(float(r[0]), int(r[1])): float(r[5]) for r in rows}
    assert steps[-1e6, 0] == steps[-1e6, 1] == 0.0
    assert steps[1e6, 0] == steps[1e6, 1] == 3.0
    assert len(built) == 1 and built[0].rag.threshold == 1e6 and built[0].rag.ablation == 1


def test_parity_leaves_every_artifact(tmp_path, capsys):
    """``parity --device cpu`` on the fixture chain: the artifacts
    ``tests/test_cli_parity.py::test_parity_drill_smoke`` checks."""
    work = tmp_path / "parity"
    cli.main(["parity", "--device", "cpu", "--workdir", str(work), "--datasets", "nq,trivia",
              "--steps-limit", "4", "--max-new-tokens", "8", "--batch-size", "2",
              "--epochs", "1"])
    out = capsys.readouterr().out
    assert "[parity preflight]" in out and "parity drill complete" in out
    assert (work / "index_nq" / "bm25" / "manifest.json").exists()
    assert (work / "index_trivia" / "docstore.json").exists()
    assert (work / "rows_simple.csv").exists()
    assert (work / "rows_none.csv").exists()
    assert any((work / "probers").glob("probers*"))
    recs = [json.loads(line) for line in
            (work / "result" / "runs.jsonl").read_text().splitlines() if line.strip()]
    assert {r["dataset"] for r in recs} == {"nq", "trivia"}
    assert all(r["retr_method"] == "probing" for r in recs)
    assert all(r["config"]["device"] == "cpu" for r in recs)
    assert (work / "report" / "report.md").exists()


def test_parity_preflight_matches_jax(tmp_path, capsys):
    (tmp_path / "ckpt").mkdir()
    for argv in ([], ["--checkpoint", str(tmp_path / "ckpt")]):
        args = jcli.build_parser().parse_args(["parity", "--workdir", "w", *argv])
        jcli._parity_preflight(args, ["nq", "bogus"])
        want = capsys.readouterr().out
        cli._parity_preflight(cli.build_parser().parse_args(["parity", "--workdir", "w", *argv]),
                              ["nq", "bogus"])
        assert capsys.readouterr().out == want


def plain(tree):
    """A config tree as nested plain values: dtypes by name."""
    if dataclasses.is_dataclass(tree):
        return {f.name: plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, (tuple, list)):
        return [plain(v) for v in tree]
    if isinstance(tree, (str, int, float, bool, type(None))):
        return tree
    return re.sub(r"^(torch\.|<class 'jax\.numpy\.)|'>$", "", str(tree))  # a dtype


# GemmaConfig fields of the JAX package that bound XLA temporaries and
# loop copies: not ported
NOT_PORTED = {"attn_q_chunk", "kv_unstacked", "mlp_t_chunk"}


def assert_same_lm_config(got, want):
    g, w = plain(got), plain(want)
    assert set(w) - set(g) == NOT_PORTED
    assert g == {k: w[k] for k in g}


@pytest.mark.parametrize("name", ["rag-sparse-cot", "rag-dense-cot", "rag-ivf-cot",
                                  "dataset-simple", "dataset-none", "prober-train"])
def test_preset_matches_jax(name):
    want, got = jconfig.preset(name), tconfig.preset(name)
    assert plain(got) == plain(want)
    assert_same_lm_config(got.model.lm_config(), want.model.lm_config())
    over = dict(seed=7, prober_ckpt="x")
    assert plain(tconfig.preset(name, **over)) == plain(jconfig.preset(name, **over))


def test_preset_errors_and_families():
    with pytest.raises(KeyError, match="unknown preset"):
        tconfig.preset("nope")
    assert_same_lm_config(tconfig.ModelSpec(family="mistral").lm_config(),
                          jconfig.ModelSpec(family="mistral").lm_config())


FAMILIES = {
    "gemma-2b": (jg.GemmaConfig.gemma_2b(), tg.GemmaConfig.gemma_2b()),
    "mistral-7b": (jg.GemmaConfig.mistral_7b(), tg.GemmaConfig.mistral_7b()),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_count_matches_jax_at_width(family):
    """Counted over shapes alone: JAX's tree by ``eval_shape``, the port's
    on the meta device."""
    jcfg, tcfg = FAMILIES[family]
    shapes = jax.eval_shape(lambda k: jg.init_params(jcfg, k), jax.random.PRNGKey(0))
    want = jg.param_count(shapes)
    assert tg.param_count(tg.init_params(tcfg, None, device="meta")) == want
    assert want > 2e9


@pytest.mark.parametrize("quant", [None, dict(bits=8), dict(bits=4),
                                   dict(bits=4, int4_scheme="rank1")])
def test_param_count_matches_jax(quant):
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)
    tree = numpy_params(jcfg, seed=1)
    jtree, ttree = to_jax(tree), lm_params_from_jax(tree, tcfg, device="cpu")
    if quant:
        jtree, ttree = jg.quantize_lm_params(jtree, **quant), tg.quantize_lm_params(ttree, **quant)
    assert tg.param_count(ttree) == jg.param_count(jtree)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("cfg_name", ["tiny", "tiny_mistral"])
@pytest.mark.parametrize("quant", [dict(bits=8), dict(bits=4), dict(bits=4, group_size=16),
                                   dict(bits=4, int4_scheme="rank1", group_size=16)])
def test_init_quantized_matches_quantize_of_init(cfg_name, quant):
    """Leaf by leaf from the generator, bit-equal to quantizing the whole
    bf16 init from the same seed; the tree has the JAX tree's leaves,
    shapes and dtypes."""
    tcfg = getattr(tg.GemmaConfig, cfg_name)()
    ref = tg.quantize_lm_params(
        tg.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu",
                       dtype=torch.bfloat16), **quant)
    got = tg.init_quantized_lm_params(tcfg, torch.Generator().manual_seed(3), device="cpu",
                                      **quant)
    ref_leaves, got_leaves = dict(leaves(ref)), dict(leaves(got))
    assert list(got_leaves) == list(ref_leaves)
    for name, r in ref_leaves.items():
        assert got_leaves[name].dtype == r.dtype and torch.equal(got_leaves[name], r), name
    jcfg = getattr(jg.GemmaConfig, cfg_name)()
    jtree = jg.init_quantized_lm_params(jcfg, jax.random.PRNGKey(3), **quant)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves(jtree)}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got_leaves.items()} == want


@pytest.mark.parametrize("quant", [dict(bits=8), dict(bits=4, embed_bits=4)])
def test_embedding_row_blocks_match_jax(quant):
    """A vocabulary of two whole row blocks and a ragged third: the
    embedding's per-row quantization, done a block at a time, equals JAX's
    whole-table one (and the port's own on the whole table, bit for bit)."""
    vocab = 2 * tg._EMBED_ROW_BLOCK + 123
    jcfg = jg.GemmaConfig.tiny(vocab_size=vocab)
    tree = numpy_params(jcfg, seed=2)
    want = jg.quantize_lm_params(to_jax(tree), **quant)["embed"]
    got = tg.quantize_lm_params(lm_params_from_jax(tree, tg.GemmaConfig.tiny(vocab_size=vocab),
                                                   device="cpu"), **quant)["embed"]
    whole = tg._quant_channel_2d(torch.from_numpy(tree["embed"]), -1, quant.get("embed_bits", 8))
    assert all(torch.equal(got[k], whole[k]) for k in whole)
    assert set(got) == set(want)
    for k in got:  # integers exact, scales as tests/test_torch_quant.py holds them
        if k == "s":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kw", [dict(bits=3), dict(bits=4, int4_scheme="rank2"),
                                dict(bits=4, group_size=24)])
def test_init_quantized_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jg.init_quantized_lm_params(jg.GemmaConfig.tiny(), jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError) as got:
        tg.init_quantized_lm_params(tg.GemmaConfig.tiny(), torch.Generator(), device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_phase_timer_report():
    """The recorder's report holds JAX's ``PhaseTimer`` report (names in
    first-use order; ``total_s``, ``count``, ``mean_s`` rounded to 4
    places), with each name's self seconds and summed counts beside it."""
    rec, jtimer = profiling.Recorder(), jprofiling.PhaseTimer()
    for name, n in (("search", 3), ("decode", 1)):
        for _ in range(n):
            with rec.span(name, rows=2):
                pass
            with jtimer.phase(name):
                pass
    report, jreport = rec.report(), jtimer.report()
    assert list(report) == list(jreport) == ["search", "decode"]
    assert {k: v["count"] for k, v in report.items()} == {"search": 3, "decode": 1}
    for k, v in report.items():
        total = sum(s.seconds for s in rec.ring if s.name == k)
        assert v["total_s"] == round(total, 4) >= 0.0
        assert v["mean_s"] == round(total / v["count"], 4)
        assert v["self_s"] == v["total_s"] and v["counts"] == {"rows": 2 * v["count"]}
        assert set(v) - set(jreport[k]) == {"self_s", "counts"}
        assert all(type(v[f]) is type(jreport[k][f]) for f in jreport[k])


def test_wandb_adapter_without_wandb():
    try:
        import wandb  # noqa: F401
    except ImportError:
        assert wandb_log_adapter() is None and jax_wandb_log_adapter() is None
    else:
        pytest.skip("wandb is installed: the adapter would start a run")
