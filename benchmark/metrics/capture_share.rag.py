"""Share (%) of the window's time spent capturing decode graphs: the
program's counter ``models/graphs.py::CAPTURES["seconds"]`` over the window
(a capture is a miss of ``GRAPHS``, an LRU of a few captured steps)."""


def read(run):
    s = getattr(run.job, "capture_s", None)
    return None if s is None else 100.0 * s / run.window_s
