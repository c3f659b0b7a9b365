"""Share (%) of the window's time the host spent on the index build's own
work, the card waiting (host clock): the program's ``encoder.tokenize``,
``encoder.pad`` and ``encoder.copy_in`` spans, and the self seconds of
``index.build`` and ``encoder.batch`` (``retrieval/dense.py``,
``models/encoder.py::text_encoder``), inside the window."""

from benchmark.metrics.program_spans import window

WHOLE = ("encoder.tokenize", "encoder.pad", "encoder.copy_in")
SELF = ("index.build", "encoder.batch")


def read(run):
    whole = [window(run, n) for n in WHOLE]
    own = [window(run, n) for n in SELF]
    s = (sum(w.seconds for w in whole if w is not None)
         + sum(w.self_seconds for w in own if w is not None))
    return None if not s else 100.0 * s / run.window_s
