"""What the readers of the program's own spans share: one name's spans
inside the window, from the port's recorder
(``probing_rag_tpu_torch/utils/profiling.py::RECORDER``)."""


def window(run, name):
    """The program's spans named ``name`` inside the window (a ``Window``:
    seconds, self seconds, device seconds, summed counts), or None off the
    card or where the program has no recorder."""
    if run.trace is None:
        return None
    try:
        from probing_rag_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    return None if rec is None else rec.window(name, run.window_start, run.window_end)
