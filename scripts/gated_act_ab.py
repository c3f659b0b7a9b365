#!/usr/bin/env python3
"""``gated_act.cu`` on the card against an earlier design of the same file,
in turns, in one process.

Take the earlier design from git history into a directory that
``.gitignore`` lists, then run from the repository root on a machine with
an NVIDIA Hopper GPU:

    git show 84c1022:probing_rag_tpu_torch/kernels/csrc/gated_act.cu \\
        > scratch_chip/gated_act_before.cu
    python3 scripts/gated_act_ab.py scratch_chip/gated_act_before.cu

The earlier file's entry takes ``(gate, up, out, dt, act, n, sms,
stream)``, as the design before ``plan_act`` (a grid-stride loop of
16-byte vectors) does; it is built into ``scripts/_build/``. At
Gemma-2B's decode step, verify round, prefill and capture rows and
Mistral-7B's decode, verify and prefill rows (bf16), the script prints
min / mean ``chip_smoke.cuda_ms`` over 4 rounds in alternating order of:
the earlier design and the package's ``gated_act``, each launch on a fresh
copy of gate; the earlier design applied in place to one buffer over the
repeats (its values drift toward 0: how its first times were taken); and
the same-bytes ``torch.add(gate, up, out=gate)``. Each kernel's output is
counted against ``gated_act_plain`` for elements not bit-equal.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from probing_rag_tpu_torch import kernels  # noqa: E402
from probing_rag_tpu_torch.ops import block as bk  # noqa: E402

BUILD = REPO / "scripts" / "_build"
SHAPES = {  # rows, d_ff, activation
    "decode": (8, 16_384, "gelu"), "verify": (40, 16_384, "gelu"),
    "mistral decode": (8, 14_336, "silu"), "mistral verify": (40, 14_336, "silu"),
    "prefill": (8 * 3712, 16_384, "gelu"), "capture": (8 * 1536, 16_384, "gelu"),
    "mistral prefill": (8 * 1024, 14_336, "silu"),
}
ROUNDS = 4


def build_before(cu: Path) -> ctypes.CDLL:
    BUILD.mkdir(exist_ok=True)
    so = BUILD / "gated_act_before.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.gated_act.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def kernels_of(before: ctypes.CDLL, act: str) -> dict:
    """name -> fn(gate, up, out) for the earlier design and the package's."""
    a, sms, lib = bk.ACTIVATIONS[act], kernels.sm_count(0), kernels.library()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def earlier(g, u, o):
        kernels.check(before.gated_act(g.data_ptr(), u.data_ptr(), o.data_ptr(), 0, a, g.numel(),
                                       sms, stream()), "earlier gated_act")

    def package(g, u, o):
        kernels.check(lib.gated_act(g.data_ptr(), u.data_ptr(), o.data_ptr(), 0, a, g.numel(),
                                    *bk.plan_act(g.numel(), g.dtype), stream()), "gated_act")

    return {"earlier": earlier, "gated_act": package}


def turns(shape: str, fns: dict) -> str:
    rows, f, act = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 18)
    g = (2 * torch.randn((rows, f), generator=gen, device="cuda")).bfloat16()
    u = torch.randn((rows, f), generator=gen, device="cuda").bfloat16()
    ref = bk.gated_act_plain(g, u, act)
    unequal = {}
    for name, fn in fns.items():
        out = torch.empty_like(g)
        fn(g, u, out)
        unequal[name] = int((out != ref).sum())
    del ref
    reps = 20 if rows <= 64 else 8

    def fresh(fn):
        copies = []

        def run():
            if not copies:
                copies.extend(g.clone() for _ in range(reps + 1))
            x = copies.pop()
            fn(x, u, x)
        return run

    in_place, summed = g.clone(), g.clone()
    timed = {"earlier": fresh(fns["earlier"]), "gated_act": fresh(fns["gated_act"]),
             "earlier in place": lambda: fns["earlier"](in_place, u, in_place),
             "same-bytes add": lambda: torch.add(summed, u, out=summed)}
    ms = {name: [] for name in timed}
    for r in range(ROUNDS):
        for name in (list(timed) if r % 2 == 0 else list(timed)[::-1]):
            ms[name].append(cs.cuda_ms(timed[name], reps=reps))
    torch.cuda.empty_cache()
    return (f"{shape} [{rows} x {f}] {act} bf16: " + "; ".join(
        f"{name} {min(v):.5f} / {sum(v) / len(v):.5f}" for name, v in ms.items())
        + f"; elements not bit-equal to plain {unequal}")


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage, on a CUDA machine: gated_act_ab.py EARLIER_GATED_ACT_CU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    before = build_before(Path(sys.argv[1]))
    print(f"the earlier design against gated_act, in turns (min / mean ms of {ROUNDS} rounds)",
          flush=True)
    for shape in SHAPES:
        print("  " + turns(shape, kernels_of(before, SHAPES[shape][2])), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
