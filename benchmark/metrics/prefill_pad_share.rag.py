"""Share (%) of the prefill's token slots that are padding: 1 - valid
prompt tokens / slots (rows x the bucketed length) counted on the
program's ``lm.prefill`` spans (``models/decode.py::generate``) inside the
window."""

from benchmark.metrics.program_spans import window


def read(run):
    w = window(run, "lm.prefill")
    if w is None or not w.counts.get("slots"):
        return None
    return 100.0 * (1.0 - w.counts["valid"] / w.counts["slots"])
