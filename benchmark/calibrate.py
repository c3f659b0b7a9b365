"""The readings that a cell's check limits are set from: the check's numbers
for the program on many seeds and for the control on a few, in one process
(set-up that does not depend on the seed is made once).

    python benchmark/calibrate.py --workload <cell> --seeds 1-12 --control-seeds 1-3

Each seed runs ``--units`` units of the cell's own traffic (the window's
work, at the cell's sizes) and its check; a control seed then reads the
control (the job's ``control``: the program's int8 path for an LM, fp8
products for an encoder, bf16 impacts for BM25) on the same outputs. Each
reading is judged as a run judges it, against ``benchmark/limits/<cell>.json``
(``run.judge``): the program's must come out correct, the control's not. One
JSON line a seed; the last line sums each number up (the program's largest,
the control's smallest) with the seeds on which the program failed and
those on which the control passed, both of which should be empty.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def calibrate(manifest, cell: dict, program_seeds, control_seeds, units: int,
              device: str = "cuda", out=sys.stdout, dump=None) -> dict:
    from benchmark.lib.spans import Spans
    from benchmark.run import judge

    limits = manifest.limits(cell["name"])
    traffic = manifest.traffic(cell["traffic"])
    module = manifest.job(traffic["job"])
    shared: dict = {}
    program, control = {}, {}
    program_failed, control_passed = [], []
    for seed in sorted(set(program_seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        job = module.Job(manifest.root, manifest.config(cell["config"]), traffic, seed, device,
                         Spans(), shared)
        job.start_window()
        for _ in range(units):
            job.unit()
        job.end_window()
        job.free_program()
        line = {"seed": seed}
        if seed in program_seeds:
            line["program"] = job.check()
            line["program_fails"] = judge(line["program"], limits)
            if line["program_fails"]:
                program_failed.append(seed)
            for k, v in line["program"].items():
                program[k] = max(program.get(k, v), v)
        if seed in control_seeds:
            line["control"] = job.control()
            line["control_fails"] = judge(line["control"], limits)
            if not line["control_fails"]:
                control_passed.append(seed)
            for k, v in line["control"].items():
                control[k] = min(control.get(k, v), v)
        if dump is not None and getattr(job, "diag", None):
            import numpy as np

            dump.mkdir(parents=True, exist_ok=True)
            np.savez(dump / f"{cell['name']}.{seed}.npz",
                     **{k: np.concatenate(v) for k, v in job.diag.items()})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), file=out, flush=True)
        del job
        gc.collect()
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()
    summary = {"program_max": program, "control_min": control, "limits": limits,
               "program_failed": program_failed, "control_passed": control_passed}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--dump", type=Path, default=None,
                    help="a directory for each seed's per-token readings (.npz)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import device as dev
    from benchmark.run import Manifest

    dev.set_cache_dirs(ROOT)
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    why_not = dev.require_cuda(cell["chips"])
    if why_not:
        print(f"no run: {why_not}", file=sys.stderr)
        return 1
    print(f"card: {dev.power_limit()}", file=sys.stderr)
    calibrate(manifest, cell, seeds(args.seeds), seeds(args.control_seeds), args.units,
              dump=args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
