"""``run.py`` drives both kinds of cell end to end at tiny sizes on the CPU
(the program's plain paths) and prints a well-formed result; new cells,
mixes and metrics are found from added files alone."""

import json
import subprocess
import sys

import pytest

from benchmark.run import Manifest, run_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _well_formed(out: dict, metrics) -> None:
    assert list(out)[:5] == list(KEYS) and list(out)[-1] == "checks"
    assert json.loads(json.dumps(out)) == out
    assert set(out["metrics"]) == set(metrics)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["device"]["count"] == 1


@pytest.mark.parametrize("cell, rate", [("tiny.rag", "questions_per_s"),
                                        ("tiny.index", "docs_per_s")])
def test_cell_runs_end_to_end(tiny_root, cell, rate):
    m = Manifest(tiny_root)
    out = run_cell(m, m.cell(cell), 2**31 + 12345, 0.5, False, device="cpu")
    _well_formed(out, {rate, "setup_s"})
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["metrics"][rate]["value"] > 0


@pytest.mark.parametrize("cell, names", [
    ("tiny.rag", {"search_share.rag", "capture_share.rag", "units.tiny"}),
    ("tiny.index", {"tokenize_share.index", "units.tiny"})])
def test_traced_run_reads_host_metrics_and_added_metric(tiny_root, cell, names):
    """On the CPU there is no device trace and no peak: those readers
    return nothing and their metrics are left out."""
    m = Manifest(tiny_root)
    out = run_cell(m, m.cell(cell), 7, 0.5, True, device="cpu")
    _well_formed(out, names)
    assert out["correct"]
    assert out["metrics"]["units.tiny"]["value"] == out["attempted"]


def test_same_seed_same_inputs(tiny_root):
    m = Manifest(tiny_root)
    job = m.job("rag")
    traffic = m.traffic("tiny-rag")
    from benchmark.lib.spans import Spans

    def questions(seed):
        j = job.Job(tiny_root, m.config("tiny-mistral"), traffic, seed, "cpu", Spans())
        return j.questions(0), float(j.weights["layers"]["wq"].float().sum())

    assert questions(2**31 + 5) == questions(2**31 + 5)
    assert questions(2**31 + 5) != questions(2**31 + 6)


def test_no_card_no_result(tiny_root):
    """Without a card (and in a tree without the program) the command
    prints no result and exits non-zero."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny.rag", "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=tiny_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
