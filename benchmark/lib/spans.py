"""Spans that the benchmark's own files record around the calls it makes
into the program's layers: a name, a start and an end on the host clock
(``time.perf_counter``), and the span it lies in. Kept in memory and written
out when the run ends. While a profiler runs (``profiling``) each span is
also a ``torch.profiler.record_function`` range, so the device trace can say
which span the host was in during each idle gap.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import List, Optional


class Spans:
    def __init__(self):
        self.items: List[tuple] = []  # (name, start, end, parent index or -1)
        self._open: List[int] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._open[-1] if self._open else -1
        idx = len(self.items)
        self.items.append((name, time.perf_counter(), None, parent))
        self._open.append(idx)
        if self.profiling:
            from torch.profiler import record_function

            ctx = record_function("bench:" + name)
        else:
            ctx = contextlib.nullcontext()
        try:
            with ctx:
                yield
        finally:
            self._open.pop()
            n, t0, _, p = self.items[idx]
            self.items[idx] = (n, t0, time.perf_counter(), p)

    def seconds(self, name: str, start: float, end: float) -> Optional[float]:
        """Seconds of the spans named ``name`` that lie in [start, end], or
        None if there is none."""
        found = [e - s for n, s, e, _ in self.items
                 if n == name and e is not None and s >= start and e <= end]
        return sum(found) if found else None

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for n, s, e, p in self.items:
                f.write(json.dumps({"name": n, "start": s, "end": e, "parent": p}) + "\n")
