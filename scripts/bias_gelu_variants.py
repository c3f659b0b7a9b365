#!/usr/bin/env python3
"""Variants of ``bias_gelu.cu``'s launch plan (or other copies of the file)
timed in turns in one process, on a machine with an NVIDIA Hopper GPU.

    python3 scripts/bias_gelu_variants.py base: t1024:kThreads=1024,kBlocksPerSm=1

A spec is ``name:KEY=VALUE,...``: ``kThreads``, ``kBlocksPerSm`` and
``kUnroll`` replace the file's constants and set their mirrors in
``ops/encoder.py`` (``GELU_THREADS``, ``GELU_BLOCKS_PER_SM``,
``GELU_UNROLL``) while the variant runs; ``src=PATH`` builds from another
copy of the file (for example one taken from git history into a directory
that ``.gitignore`` lists). Each variant is built into its own library
under ``scripts/_build/``. At the index build's 512 x 376 x 3072, at T 512
and at 8 x 40 queries (h = 2 randn, bias = 0.5 randn, bf16) each variant is
held bit-equal to ``bias_gelu_plain`` and timed with
``chip_smoke.timed_fresh`` (5 launches, each on a fresh copy of h: the
kernel works in place), in the order A B .. B A twice, beside a same-bytes
in-place ``torch.add``; the script prints each variant's minimum and every
run.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from probing_rag_tpu_torch import kernels  # noqa: E402
from probing_rag_tpu_torch.ops import encoder as ek  # noqa: E402

OUT = REPO / "scripts" / "_build"
MIRRORS = {"kThreads": "GELU_THREADS", "kBlocksPerSm": "GELU_BLOCKS_PER_SM",
           "kUnroll": "GELU_UNROLL"}


def build(specs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in specs.items():
        src = Path(spec["src"]).read_text() if "src" in spec else (
            kernels.CSRC / "bias_gelu.cu").read_text()
        for key in MIRRORS:
            if key in spec:
                src, n = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{spec[key]};", src)
                if n != 1:
                    raise ValueError(f"{name}: no constant {key}")
        cu, so = OUT / f"bg_{name}.cu", OUT / f"libbg_{name}.so"
        cu.write_text(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu),
               str(kernels.CSRC / "errors.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(err)
        lib = ctypes.CDLL(str(so))
        for fn in ("bias_gelu", "gelu_table"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
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
    libs = build(specs)
    own = kernels.library
    defaults = {key: getattr(ek, attr) for key, attr in MIRRORS.items()}

    def use(name):
        kernels.library = lambda lib=libs[name]: lib
        for key, attr in MIRRORS.items():
            setattr(ek, attr, int(specs[name].get(key, defaults[key])))
        ek.GELU_TABLES.clear()  # each library builds its own table

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, rows in (("build", 512 * 376), ("T 512", 512 * 512), ("query", 8 * 40)):
        h = (2 * torch.randn((rows, 3072), generator=gen, device="cuda")).to(bf16)
        bias = (0.5 * torch.randn(3072, generator=gen, device="cuda")).to(bf16)
        ref = ek.bias_gelu_plain(h, bias)
        for name in libs:
            use(name)
            got = ek.bias_gelu(h.clone(), bias)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"{label} {name}: not bit-equal to the plain version")
        times = {name: [] for name in libs}
        for _ in range(2):
            for name in list(libs) + list(libs)[::-1]:
                use(name)
                ek.gelu_table(h.device)  # built before the timing
                times[name].append(cs.timed_fresh(lambda x: ek.bias_gelu(x, bias), h.clone))
        kernels.library = own
        add = cs.cuda_ms(lambda: torch.add(h, 0, out=h))
        print(f"{label}: " + ", ".join(
            f"{name} {min(ts):.4f} ms ({' '.join(f'{x:.4f}' for x in ts)})"
            for name, ts in times.items()) + f"; same-bytes add {add:.4f}", flush=True)
        del h, ref
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
