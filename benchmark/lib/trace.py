"""The device trace of one unit of work: ``torch.profiler`` (CPU and CUDA
activities) around it, read from kineto's raw events.

The traced window is the unit's own host span, ``synchronize`` to
``synchronize``. ``busy_s`` is the union of the device events' intervals
inside it; the idle gaps are the rest, each put down to the innermost
benchmark span (``spans.py``, a ``bench:`` range in the trace) that covers
its middle, or to ``program`` where none does (the program's own host work
between the benchmark's calls); a gap under 20 us is put down to
``kernel-to-kernel``, the launches of one call. Kineto drops kernel records that lie at
the very edges of its window, so the profiler opens a margin before the
unit and closes a margin after it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

MARGIN_S = 0.2
# idle gaps shorter than this are put down to the launches of one call
SHORT_GAP_NS = 20_000


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]  # device seconds by event name
    gaps: List[Tuple[str, float]]  # (span, seconds) of each idle gap

    def device_seconds(self, patterns) -> Optional[float]:
        """Device seconds of the events whose name holds any of
        ``patterns``, or None if none ran."""
        found = [s for name, s in self.kernels.items() if any(p in name for p in patterns)]
        return sum(found) if found else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        by_span: Dict[str, float] = {}
        for name, s in self.gaps:
            by_span[name] = by_span.get(name, 0.0) + s
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """Merged, clipped intervals and their total length."""
    out, total = [], 0
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                total += e - out[-1][1]
                out[-1][1] = e
        else:
            out.append([s, e])
            total += e - s
    return out, total


def profile(fn: Callable[[], None], spans) -> Trace:
    """Runs ``fn`` (one unit, which synchronises the card at its end) under
    the profiler and reads its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    spans.profiling = True
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(MARGIN_S)
            with record_function("bench:unit"):
                fn()
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
    finally:
        spans.profiling = False
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        span = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if name.startswith("bench:"):  # a span; on the device timeline only its shadow
            if ev.device_type() != DeviceType.CUDA:
                host.append((name[6:], *span))
        elif ev.device_type() == DeviceType.CUDA:
            device.append((name, *span))
    return summarize(device, host)


def summarize(device: List[tuple], host: List[tuple]) -> Trace:
    """The trace of the ``unit`` host span from raw events: ``device`` as
    (name, start_ns, end_ns) of the operations on the card, ``host`` as
    (span name, start_ns, end_ns) of the benchmark's spans."""
    unit = [h for h in host if h[0] == "unit"]
    lo, hi = unit[0][1], unit[0][2]
    kernels: Dict[str, float] = {}
    inside = []
    for name, s, e in device:
        if e <= lo or s >= hi:
            continue
        kernels[name] = kernels.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
        inside.append((s, e))
    merged, busy = _union(inside, lo, hi)
    gaps, cur = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    labelled = []
    host_spans = sorted((h for h in host if h[0] != "unit"), key=lambda h: h[2] - h[1])
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:  # between two kernels of one call: not worth a span
            labelled.append(("kernel-to-kernel", (e - s) * 1e-9))
            continue
        mid = (s + e) // 2
        name = next((h[0] for h in host_spans if h[1] <= mid <= h[2]), "program")
        labelled.append((name, (e - s) * 1e-9))
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels, gaps=labelled)
