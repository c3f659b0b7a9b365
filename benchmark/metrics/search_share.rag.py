"""Share (%) of the window's time spent in ``BM25Engine.search``: the
benchmark's span around each call the pipeline makes to its retriever
(the call returns host arrays, so its span ends when the search has)."""


def read(run):
    s = run.span_seconds("search")
    return None if s is None else 100.0 * s / run.window_s
