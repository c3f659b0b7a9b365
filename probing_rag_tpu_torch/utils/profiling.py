"""The port's recorder of spans and counts.

A span is one call at a layer boundary (a generate call's prefill, a BM25
search, an encoder batch): its name, its start and end on the host clock
(``time.perf_counter_ns``), the span open around it on the same thread
(its parent), the outermost of those (its root: a ``rag.run`` chunk, an
``index.build`` call), and the counts attached at the boundary (rows,
slots, tokens, steps), summed by name. Spans open at call granularity,
never once per decode step and never inside a captured graph.

:data:`RECORDER` keeps a per-thread stack of open spans, a bounded ring of
closed ones and running totals by name (:meth:`Recorder.report`, which
the CLI logs); :meth:`Recorder.window` sums the seconds, self seconds,
device seconds and counts of one name's spans inside an interval of the
host clock.

- A device span (``device=`` a CUDA device) also records a pair of CUDA
  events on the current stream, unless the stream is capturing a graph.
  They are read lazily, once the card has passed them (``Event.query``,
  asked when a later span closes or a window is read), after a
  synchronisation the program makes anyway (the readback): a span adds no
  ``synchronize``.
- While a ``torch.profiler`` is active, each span is also a profiler range
  under its own name, so that the device trace places it. The range is of
  function scope, as PyTorch's own fast ranges are, which gives it no
  shadow on the device's timeline. :attr:`Recorder.anchor_ns` maps the
  host clock onto the trace's (Unix time).
- With no profiler, a span costs two clock reads, a ring append and a
  dict add: no profiler range, no NVTX push, no synchronisation.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import torch

_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span:
    """One span: a context manager made by :meth:`Recorder.span`, and
    after it closes, the record the ring keeps."""

    __slots__ = ("rec", "name", "id", "parent", "root", "start_ns", "end_ns", "child_ns",
                 "counts", "device_s", "_device", "_events", "_range")

    def __init__(self, rec: "Recorder", name: str, device, counts: Dict[str, int]):
        self.rec, self.name, self.counts = rec, name, counts
        self.id = next(rec._ids)
        self.parent = self.root = None
        self.start_ns = self.end_ns = None
        self.child_ns = 0
        self.device_s: Optional[float] = None
        self._device = device
        self._events = self._range = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        """Seconds not covered by the span's children."""
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-9

    def count(self, **counts: int) -> None:
        """Adds ``counts`` to the span's (and, once it has closed, to its
        name's totals): for counts read after the span, such as a decode's
        live rows, read back after its loop."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        if self.end_ns is not None:
            self.rec._add_counts(self.name, counts)

    def __enter__(self) -> "Span":
        stack = self.rec._stack()
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.root = self.id
        dev = self._device
        if dev is not None and dev.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(dev)
            self._events = (stream, torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[1].record(stream)
        if _RANGE is not None and torch.autograd._profiler_enabled():
            self._range = _RANGE(self.name)
            self._range.__enter__()
            self.rec.anchor_ns = time.time_ns() - time.perf_counter_ns()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        rec = self.rec
        stack = rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += self.end_ns - self.start_ns
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._events is not None:
            self._events[2].record(self._events[0])
        rec._close(self)


@dataclass
class Window:
    """What :meth:`Recorder.window` found of one name's spans."""

    spans: int = 0
    seconds: float = 0.0
    self_seconds: float = 0.0
    device_seconds: Optional[float] = None  # None where no span had events
    counts: Dict[str, int] = field(default_factory=dict)


class Recorder:
    """Spans and counts of the process (module docstring). ``ring``: how
    many closed spans are kept for :meth:`window`."""

    def __init__(self, ring: int = 65_536):
        self.ring: Deque[Span] = deque(maxlen=ring)
        self.anchor_ns = time.time_ns() - time.perf_counter_ns()
        self._totals: Dict[str, list] = {}  # name -> [spans, ns, self ns, counts]
        self._pending: Deque[Span] = deque()  # device spans whose events are unread
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def span(self, name: str, *, device: Optional[torch.device] = None, **counts: int) -> Span:
        """A span named ``name``, with ``counts`` attached; with a CUDA
        ``device``, timed on the card too."""
        return Span(self, name, device, counts)

    def last(self, name: str) -> Optional[Span]:
        """This thread's most recent closed span named ``name``."""
        return getattr(self._local, "last", {}).get(name)

    def to_trace_ns(self, perf_ns: int) -> int:
        """A host-clock time in the profiler trace's clock (Unix time)."""
        return perf_ns + self.anchor_ns

    def window(self, name: str, start_s: float, end_s: float) -> Window:
        """The spans named ``name`` that lie in [``start_s``, ``end_s``]
        (``time.perf_counter`` seconds) among those the ring holds."""
        self._resolve()
        lo, hi = int(start_s * 1e9), int(end_s * 1e9)
        w = Window()
        for s in list(self.ring):
            if s.name != name or s.start_ns < lo or s.end_ns > hi:
                continue
            w.spans += 1
            w.seconds += s.seconds
            w.self_seconds += s.self_seconds
            if s.device_s is not None:
                w.device_seconds = (w.device_seconds or 0.0) + s.device_s
            for k, v in s.counts.items():
                w.counts[k] = w.counts.get(k, 0) + v
        return w

    def report(self) -> Dict[str, dict]:
        """Totals by name, in the order the names first closed: seconds
        (``total_s``, ``self_s``), spans (``count``), ``mean_s`` and the
        summed ``counts``."""
        with self._lock:
            totals = {n: (t[0], t[1], t[2], dict(t[3])) for n, t in self._totals.items()}
        return {n: {"total_s": round(ns * 1e-9, 4), "count": k,
                    "mean_s": round(ns * 1e-9 / k, 4), "self_s": round(self_ns * 1e-9, 4),
                    "counts": counts}
                for n, (k, ns, self_ns, counts) in totals.items()}

    # ------------------------------------------------------------ internals

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.last = {}
        return stack

    def _close(self, s: Span) -> None:
        self.ring.append(s)
        self._local.last[s.name] = s
        with self._lock:
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = [0, 0, 0, {}]
            t[0] += 1
            t[1] += s.end_ns - s.start_ns
            t[2] += s.end_ns - s.start_ns - s.child_ns
            for k, v in s.counts.items():
                t[3][k] = t[3].get(k, 0) + v
            if s._events is not None:
                self._pending.append(s)
        if self._pending:
            self._resolve()

    def _add_counts(self, name: str, counts: Dict[str, int]) -> None:
        with self._lock:
            t = self._totals[name][3]
            for k, v in counts.items():
                t[k] = t.get(k, 0) + v

    def _resolve(self) -> None:
        """Reads the events of the device spans the card has passed, in
        the order they closed; waits for none."""
        with self._lock:
            while self._pending and self._pending[0]._events[2].query():
                s = self._pending.popleft()
                _, start, end = s._events
                s.device_s = start.elapsed_time(end) * 1e-3
                s._events = None


# the recorder of the process: the program's layers record into it
RECORDER = Recorder()
