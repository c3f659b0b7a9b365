"""Share (%) of the window's time the host spent on the probing loop's own
work, the card waiting: the self seconds (host clock) of the program's
host-only spans inside the window: ``rag.run`` and ``rag.retrieve``
(prompt rendering, docstore look-ups; ``pipeline/rag.py``), ``rag.gate``,
and generate's ``lm.prepare`` (tokenize, pad, copy in) and
``lm.detokenize`` (``models/decode.py``)."""

from benchmark.metrics.program_spans import window

NAMES = ("rag.run", "rag.retrieve", "rag.gate", "lm.prepare", "lm.detokenize")


def read(run):
    found = [window(run, n) for n in NAMES]
    s = sum(w.self_seconds for w in found if w is not None)
    return None if not s else 100.0 * s / run.window_s
