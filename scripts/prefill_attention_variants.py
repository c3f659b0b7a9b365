#!/usr/bin/env python3
"""Variants of ``prefill_attention.cu``'s persistent regime (the Contriever
encoder's attention) timed in turns in one process, on a machine with an
NVIDIA Hopper GPU.

Each variant is a source of the file (the package's, or another copy given
as ``src=PATH``, for example one taken from git history into a directory
that ``.gitignore`` lists) with named constants replaced and named edits
applied, built into its own library under ``scripts/_build/``:

    python3 scripts/prefill_attention_variants.py base: \\
        s6:kPersistentStagesMax=6,py_PERSISTENT_MAX_STAGES=6 \\
        noexp:edit=noexp1+noexp2

A spec is ``name:KEY=VALUE,...``: ``kName=V`` replaces ``constexpr int kName
= ...;``; ``edit=a+b`` applies the edits of ``EDITS``; ``py_NAME=V`` sets
``ops/attention.py``'s ``_NAME`` while the variant runs (the planner's mirror
of a constant); ``src=PATH`` builds from another copy. At the index build's
512 x 376 (lengths ~N(350, 25)), at T 512 and at 8 x 40 queries, each variant
is held to the plain version within ``rounding_tolerance`` (variants with an
edit that changes the arithmetic are only reported) and timed with
``chip_smoke.cuda_ms`` (10 launches, bf16 store), in the order A B .. B A
twice; the script prints each variant's minimum and every run, then a
``torch.profiler`` split of the package's own launch (prep, finish,
attention).

``TRACE=1`` instead builds the variants with ``EDITS["trace"]`` added and
runs the build shape twice: threads 0 and 128 (the first two consumer
warpgroups) of block 5 print clock64 stamps (item start, Q ready, each
wait and product; codes in ``TRACE_NAMES``), from which an item's cycles
can be split.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from probing_rag_tpu_torch import kernels  # noqa: E402
from probing_rag_tpu_torch.ops import attention as at  # noqa: E402

OUT = REPO / "scripts" / "_build"

# named edits of the source: (old text, new text)
EDITS = {
    # no exponentials in sweep 2 / sweep 1 (what binds, not a result)
    "noexp2": [("ex2(fmaf(sc[8 * ks + 2 * e], c2, -mc)) * rl",
                "fmaf(sc[8 * ks + 2 * e], c2, -mc) * rl"),
               ("ex2(fmaf(sc[8 * ks + 2 * e + 1], c2, -mc)) * rl",
                "fmaf(sc[8 * ks + 2 * e + 1], c2, -mc) * rl")],
    "noexp1": [("ex2(fmaf(s[4 * j], c2, -nc0)) + ex2(fmaf(s[4 * j + 1], c2, -nc0));",
                "fmaf(s[4 * j], c2, -nc0) + fmaf(s[4 * j + 1], c2, -nc0);"),
               ("ex2(fmaf(s[4 * j + 2], c2, -nc1)) + ex2(fmaf(s[4 * j + 3], c2, -nc1));",
                "fmaf(s[4 * j + 2], c2, -nc1) + fmaf(s[4 * j + 3], c2, -nc1);")],
    # every warpgroup works through an item, also when its rows lie past T
    "noidle": [("      if (P && tc >= a.t) {", "      if (false) {")],
}
EDITS["trace"] = [
    ("    const int c = warp >> 2, wq = warp & 3, ctid = threadIdx.x & 127, t4 = lane & 3;\n",
     "    const int c = warp >> 2, wq = warp & 3, ctid = threadIdx.x & 127, t4 = lane & 3;\n"
     "    long long tsb[200]; int tsn = 0;\n"
     "    const bool rec = blockIdx.x == 5 && (threadIdx.x == 0 || threadIdx.x == 128);\n"
     "    auto mark = [&](int code) {\n"
     "      if (rec && tsn < 200) tsb[tsn++] = (clock64() << 8) | code;\n    };\n"),
    ("    for (int it = blockIdx.x; it < items; it += gridDim.x, ++u) {\n      const int qb = u % kQB;",
     "    for (int it = blockIdx.x; it < items; it += gridDim.x, ++u) {\n      mark(1);\n"
     "      const int qb = u % kQB;"),
    ("        hop::mbar_wait(qfull + 8 * qb, (u / kQB) & 1);\n        I.n",
     "        hop::mbar_wait(qfull + 8 * qb, (u / kQB) & 1);\n        mark(2);\n        I.n"),
    ("        wait_full(g);\n        turn_begin();\n        issue_scores<KIND, HD>(s, q_tile, tile_at(g));\n"
     "        turn_end();\n        hop::wgmma_wait<0>();",
     "        mark(11);\n        wait_full(g);\n        mark(3);\n        turn_begin();\n        mark(4);\n"
     "        issue_scores<KIND, HD>(s, q_tile, tile_at(g));\n        turn_end();\n"
     "        hop::wgmma_wait<0>();\n        mark(5);"),
    ("        wait_full(gv);\n        turn_begin();",
     "        mark(10);\n        wait_full(gv);\n        mark(6);\n        turn_begin();\n        mark(7);"),
    ("        hop::wgmma_commit();\n        turn_end();\n        hop::wgmma_wait<0>();\n"
     "        release(empty + 8 * (gv % kR));",
     "        hop::wgmma_commit();\n        turn_end();\n        hop::wgmma_wait<0>();\n        mark(8);\n"
     "        release(empty + 8 * (gv % kR));"),
    ("      if (kQB > 1) release(qempty + 8 * qb);  // the item's Q is read",
     "      mark(9);\n      if (kQB > 1) release(qempty + 8 * qb);  // the item's Q is read"),
    ("    if (!P && c == 0) hop::bar_sync(3, 256);  // warpgroup 1's last arrival",
     "    if (!P && c == 0) hop::bar_sync(3, 256);  // warpgroup 1's last arrival\n"
     "    if (rec)\n      for (int i = 0; i < tsn; ++i)\n"
     "        printf(\"C%d %d %lld\\n\", c, (int)(tsb[i] & 255), (tsb[i] >> 8));"),
]
TRACE_NAMES = {1: "item", 2: "Q ready", 3: "K ready", 4: "turn", 5: "scores done",
               6: "V ready", 7: "turn V", 8: "P V done", 9: "sweep 2 done", 10: "probs done",
               11: "wait"}


def source(name: str, spec: dict, trace: bool) -> str:
    src = Path(spec["src"]).read_text() if "src" in spec else (
        kernels.CSRC / "prefill_attention.cu").read_text()
    edits = [e for e in spec.get("edit", "").split("+") if e] + (["trace"] if trace else [])
    for e in edits:
        for old, new in EDITS[e]:
            if old not in src:
                raise ValueError(f"{name}: edit {e} does not apply")
            src = src.replace(old, new)
    for key, val in spec.items():
        if key.startswith("k"):
            src, n = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{val};", src)
            if n != 1:
                raise ValueError(f"{name}: no constant {key}")
    return ("#include <cstdio>\n" if trace else "") + src


def build(specs: dict, trace: bool) -> dict:
    """One library a variant: the file's four parts and errors.cu, compiled
    at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, spec in specs.items():
        cu = OUT / f"pa_{name}.cu"
        cu.write_text(source(name, spec, trace))
        objs, procs = [], []
        for part in range(4):
            obj = OUT / f"pa_{name}.{part}.o"
            objs.append(obj)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DNVCC_PART={part}", "-DNVCC_PARTS=4",
                   "-I", str(kernels.CSRC), "-c", "-o", str(obj), str(cu)]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        jobs[name] = (objs, procs)
    libs = {}
    for name, (objs, procs) in jobs.items():
        for p in procs:
            _, err = p.communicate()
            if p.returncode:
                raise RuntimeError(err)
            for line in err.splitlines():
                if "spill" in line and "prefill_attn" in line:
                    print(f"  ptxas {name}: {line.strip()}", flush=True)
        so = OUT / f"libpa_{name}.so"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *map(str, objs), str(kernels.CSRC / "errors.cu")], check=True)
        lib = ctypes.CDLL(str(so))
        lib.prefill_attention.argtypes = kernels._SIGNATURES["prefill_attention"]
        lib.prefill_attention.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    specs = {}
    for arg in sys.argv[1:]:
        name, _, rest = arg.partition(":")
        specs[name] = dict(kv.split("=", 1) for kv in rest.split(",") if kv)
    trace = bool(os.environ.get("TRACE"))
    t0 = time.time()
    libs = build(specs, trace)
    print(f"built {list(libs)} in {time.time() - t0:.1f}s", flush=True)
    kernels.library()  # the package's, for check()'s error strings
    own = kernels.library
    mirrors = {k[2:]: getattr(at, k[2:]) for sp in specs.values() for k in sp if k.startswith("py")}

    def use(name):
        kernels.library = lambda lib=libs[name]: lib
        for attr, val in mirrors.items():
            setattr(at, attr, int(specs[name].get("py" + attr, val)))

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)

    def case(b, t, lengths):
        q = torch.randn((b, t, 12, 64), generator=gen, device="cuda").to(bf16)
        k, v = (torch.randn((b, 12, t, 64), generator=gen, device="cuda").to(bf16)
                for _ in range(2))
        valid = (torch.arange(t, device="cuda")[None, :]
                 < torch.tensor(lengths, device="cuda")[:, None])
        pos = torch.zeros((b, t), dtype=torch.int32, device="cuda")
        return q, k, v, pos, valid

    build_len = [int(x) for x in rng.normal(350, 25, 512).clip(1, 376)]
    build_len[0] = 376
    cases = {"build": case(512, 376, build_len),
             "T 512": case(512, 512, [int(x) for x in rng.integers(1, 513, 512)]),
             "query": case(8, 40, [40, 1, 23, 30, 17, 40, 9, 0])}
    if trace:
        q, k, v, pos, valid = cases["build"]
        for name in libs:
            use(name)
            for _ in range(2):
                at.prefill_attention(q, k, v, pos, pos, valid, dt=bf16, out_dtype=bf16)
                torch.cuda.synchronize()
        kernels.library = own
        print("codes: " + ", ".join(f"{c} {n}" for c, n in TRACE_NAMES.items()))
        return 0
    for label, (q, k, v, pos, valid) in cases.items():
        ref = at.prefill_attention_plain(q, k, v, pos, pos, valid, dt=bf16)
        tol = at.rounding_tolerance(q, k, v, at.structured_mask(pos, pos, valid), dt=bf16)
        for name in libs:
            use(name)
            got = at.prefill_attention(q, k, v, pos, pos, valid, dt=bf16)
            torch.cuda.synchronize()
            ratio = float(((got - ref).abs() / tol).nan_to_num(nan=0.0).max())
            plan = at.last_prefill_plan
            print(f"{label} {name}: {plan.regime} grid {plan.grid} stages {plan.stages}; worst "
                  f"err/limit {ratio:.3g}", flush=True)
            if ratio > 1.0 and "edit" not in specs[name]:
                raise AssertionError(f"{label} {name}: outside rounding_tolerance")
        del ref, tol
        times = {name: [] for name in libs}
        for _ in range(2):
            for name in list(libs) + list(libs)[::-1]:
                use(name)
                times[name].append(cs.cuda_ms(lambda: at.prefill_attention(
                    q, k, v, pos, pos, valid, dt=bf16, out_dtype=bf16), reps=10))
        kernels.library = own
        print(f"{label}: " + ", ".join(
            f"{name} {min(ts):.4f} ms (all {' '.join(f'{x:.4f}' for x in ts)})"
            for name, ts in times.items()), flush=True)
    from torch.profiler import ProfilerActivity, profile

    q, k, v, pos, valid = cases["build"]
    at.prefill_attention(q, k, v, pos, pos, valid, dt=bf16, out_dtype=bf16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            at.prefill_attention(q, k, v, pos, pos, valid, dt=bf16, out_dtype=bf16)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"  profile: {e.key[:60]} {e.device_time_total / 3 / 1e3:.4f} ms a call")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
