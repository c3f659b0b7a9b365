"""Tracing and phase timing.

Port of ``probing_rag_tpu/utils/profiling.py``: ``trace_annotation`` names
a span (index search, decode, prober gate) in ``torch.profiler`` traces,
and as an NVTX range when CUDA is present; ``profile_to`` records a CPU
(and CUDA) trace of its block and writes it to a directory as a Chrome
trace; ``PhaseTimer`` sums wall seconds per named phase, waiting for the
device of a given tensor before it stops the clock.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profiles the block (CPU activity, and CUDA when present) and writes
    ``trace.json`` (Chrome trace format) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclass
class PhaseTimer:
    """Accumulates wall seconds per named phase."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None) -> Iterator[None]:
        """Times the block as ``name``; with ``sync``, first waits for the
        device that tensor lives on (CUDA runs asynchronously)."""
        start = time.perf_counter()
        with trace_annotation(name):
            yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        elapsed = time.perf_counter() - start
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
        }
