"""Share (%) of the window's time spent in the stand-in tokenizer's
``encode``, which ``models/encoder.py::text_encoder`` calls for every
passage (host clock, summed in ``lib/tokenizer.py``)."""


def read(run):
    s = getattr(run.job, "tokenize_s", None)
    return None if not s else 100.0 * s / run.window_s
