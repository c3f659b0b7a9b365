"""Share (%) of the window's time the card spent in the encoder's forward:
the device seconds (a CUDA event pair a batch) of the program's
``encoder.forward`` spans (``models/encoder.py::text_encoder``) inside the
window."""

from benchmark.metrics.program_spans import window


def read(run):
    w = window(run, "encoder.forward")
    s = None if w is None else w.device_seconds
    return None if not s else 100.0 * s / run.window_s
