"""Share (%) of the decode loop's row-steps (rows x steps run) that served
a row before its stop and is not a pad row: live row-steps (the pooled
steps of the real rows) over row-steps, counted on the program's
``lm.decode`` spans (``models/decode.py``, ``pipeline/rag.py`` takes the
pad rows' out) inside the window. Higher is better: the rest is work on
finished or pad rows."""

from benchmark.metrics.program_spans import window


def read(run):
    w = window(run, "lm.decode")
    if w is None or not w.counts.get("row_steps"):
        return None
    return 100.0 * w.counts.get("live", 0) / w.counts["row_steps"]
