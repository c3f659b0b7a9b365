"""The cost of one span of the port's recorder (``utils/profiling.py``),
and where its profiler ranges land in a device trace.

    python scripts/recorder_cost.py [--device cuda|cpu] [--n 20000]

Prints one JSON line: the torch version; the mean cost of a span (open
and close, host clock) with no profiler and under ``torch.profiler``, as
a host span and, on CUDA, as a device span (a CUDA event pair); the same
for a bare ``record_function`` range; whether a span's range, or a
``record_function`` range, leaves an event of its name on the device's
timeline (a "shadow", which a trace reader would count as device work);
and how far a span, mapped by the recorder's anchor, lies from its range
in the trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from probing_rag_tpu_torch.utils.profiling import Recorder  # noqa: E402


def per_span_us(make, n: int) -> float:
    for _ in range(min(n, 1000)):  # warm-up
        with make():
            pass
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with make():
            pass
    return (time.perf_counter_ns() - t0) / n / 1e3


def costs(rec: Recorder, device, n: int) -> dict:
    out = {"host_span_us": per_span_us(lambda: rec.span("cost.host", rows=1), n),
           "record_function_us": per_span_us(lambda: record_function("cost.rf"), n)}
    if device.type == "cuda":
        out["device_span_us"] = per_span_us(lambda: rec.span("cost.device", device=device), n)
        torch.cuda.synchronize()
        rec.window("cost.device", 0.0, time.perf_counter())  # reads the events
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20000)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rec = Recorder()
    out = {"torch": torch.__version__, "device": (torch.cuda.get_device_name(device)
                                                  if device.type == "cuda" else "cpu"),
           "no_profiler": costs(rec, device, args.n)}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities):
        out["profiler"] = costs(rec, device, args.n // 10)
    x = torch.randn(256, 256, device=device)
    with profile(activities=activities) as prof:
        with rec.span("shadow.span", device=device) as s:
            for _ in range(4):
                x = x @ x
                x = x / x.norm()
        with record_function("shadow.rf"):
            for _ in range(4):
                x = x @ x
        if device.type == "cuda":
            torch.cuda.synchronize()
    host, shadow = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ("shadow.span", "shadow.rf"):
            if ev.device_type() == DeviceType.CUDA:
                shadow[ev.name()] = True
            else:
                host[ev.name()] = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
    start, end = host["shadow.span"]
    out["device_shadow"] = {"span": shadow.get("shadow.span", False),
                            "record_function": shadow.get("shadow.rf", False)}
    out["anchor_error_us"] = {"start": (rec.to_trace_ns(s.start_ns) - start) / 1e3,
                              "end": (rec.to_trace_ns(s.end_ns) - end) / 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
