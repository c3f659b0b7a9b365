"""Share (%) of the encoder's token slots that are padding: 1 - valid
tokens / slots (rows x each batch's longest) counted on the program's
``encoder.forward`` spans (``models/encoder.py::text_encoder``) inside the
window."""

from benchmark.metrics.program_spans import window


def read(run):
    w = window(run, "encoder.forward")
    if w is None or not w.counts.get("slots"):
        return None
    return 100.0 * (1.0 - w.counts["valid"] / w.counts["slots"])
