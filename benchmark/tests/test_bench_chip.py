"""The real cells, briefly, on the card: each prints a correct result line.
Marked ``chip``; the ``cuda`` fixture skips them without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["contriever.index-build", "mistral7b.rag-bm25"])
def test_cell_on_the_card(cuda, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out["checks"]
