"""Runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name. The cell names a configuration (its file in
``BENCHMARK.json``) and a traffic mix (``benchmark/traffic/<mix>.json``),
whose ``job`` key names the module that drives the program
(``benchmark/jobs/<job>.py``); the limits of the cell's check are in
``benchmark/limits/<cell>.json``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``. A new cell, mix or metric is new files
and entries, never an edit.

A run: set-up (the job's data, weights and one warm-up unit), then units of
work until one ends at or past ``--seconds``: the window, whose rate is all
its work over all its time. With ``--trace 1`` it then profiles one more
unit and reports the per-layer metrics instead of the end-to-end ones. The
program's state is dropped and the check holds the window's outputs to the
plain reference; each number that the cell's limits file names is compared
and printed with its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import math
import sys
import time
from pathlib import Path

T0 = time.perf_counter()  # set-up counts from here
ROOT = Path(__file__).resolve().parent.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        self.dir = root / "benchmark"

    def cell(self, name: str) -> dict:
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        return found[0]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def job(self, name: str):
        return load_module(self.dir / "jobs" / f"{name}.py", f"benchmark_job_{name}")

    def metrics(self, cell: dict, trace: bool) -> list:
        """The cell's metrics: its end-to-end ones (those that list it, and
        those that list no cell), or with ``trace`` the per-layer ones that
        list it."""
        if trace:
            return [m for m in self.bench["per_layer"] if cell["name"] in m["workloads"]]
        return [m for m in self.bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "benchmark_metric_" + metric.replace(".", "_"))


class Run:
    """What the per-layer readers read: the window's seconds, work and
    spans, the job (its counters and counts), the device trace, the card's
    peaks."""

    def __init__(self, job, spans, window, work, trace, peaks):
        self.job, self.spans, self.trace, self.peaks = job, spans, trace, peaks
        self.window_start, self.window_end = window
        self.window_s = window[1] - window[0]
        self.work = work

    def span_seconds(self, name: str):
        return self.spans.seconds(name, self.window_start, self.window_end)


def run_cell(manifest: Manifest, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    from benchmark.lib import device as dev
    from benchmark.lib.spans import Spans

    traffic = manifest.traffic(cell["traffic"])
    spans = Spans()
    job = manifest.job(traffic["job"]).Job(manifest.root, manifest.config(cell["config"]),
                                           traffic, seed, device, spans)
    logging.getLogger("probing_rag_tpu_torch").setLevel(logging.WARNING)  # its per-round lines
    job.unit()  # warm-up: every shape the traffic uses, every graph captured
    sync(device)
    setup_s = time.perf_counter() - T0
    job.start_window()
    start = time.perf_counter()
    work = 0
    while True:
        work += job.unit()
        if time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    job.end_window()
    device_block = dev.device_block(device, cell["chips"])
    metrics = {}
    kinds = {m["name"]: m for m in manifest.metrics(cell, trace)}
    breakdown = None
    if not trace:
        values = dict(job.end_to_end(work, end - start), setup_s=setup_s)
        metrics = {n: {"value": values[n], "unit": kinds[n]["unit"]} for n in kinds if n in values}
    else:
        profile = None
        if device == "cuda":
            from benchmark.lib import trace as tr

            profile = tr.profile(job.profiled_unit, spans)
            device_block["busy_s"] = profile.busy_s
            device_block["window_s"] = profile.window_s
            breakdown = profile.breakdown()
        peaks = dev.peaks(device_block["kind"]) if device == "cuda" else None
        run = Run(job, spans, (start, end), work, profile, peaks)
        for name, m in kinds.items():
            value = manifest.reader(name).read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    job.free_program()
    limits = manifest.limits(cell["name"])
    checks = {n: v for n, v in job.check().items() if n in limits}  # the numbers compared
    out = {"correct": not judge(checks, limits), "attempted": work,
           "failed": int(checks.get("answers_missing", 0)), "metrics": metrics,
           "device": device_block}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": limits[n]} for n, v in checks.items()}
    spans.write(Path(manifest.root) / ".bench_cache" / "spans" / f"{cell['name']}.jsonl")
    return out


def judge(checks: dict, limits: dict) -> list:
    """The names of the numbers compared that fail their limit: a number
    passes where it is finite and at most its limit."""
    return [n for n, v in checks.items() if n in limits and not (math.isfinite(v) and v <= limits[n])]


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import device as dev

    dev.set_cache_dirs(ROOT)
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    why_not = dev.require_cuda(cell["chips"])
    if why_not:
        print(f"no run: {why_not}", file=sys.stderr)
        return 1
    print(f"card: {dev.power_limit()}; peaks: {dev.PEAKS}", file=sys.stderr)
    result = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace))
    loaded = dev.loaded_forbidden()
    if loaded:
        print(f"no result: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
