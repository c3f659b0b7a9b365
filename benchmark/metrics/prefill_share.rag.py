"""Share (%) of the window's time the card spent in the LM's prefill: the
device seconds (a CUDA event pair a call) of the program's ``lm.prefill``
spans (``models/decode.py::decode_greedy``) inside the window."""

from benchmark.metrics.program_spans import window


def read(run):
    w = window(run, "lm.prefill")
    s = None if w is None else w.device_seconds
    return None if not s else 100.0 * s / run.window_s
