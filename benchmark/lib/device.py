"""The card a run uses: the checks before a run, the device block of the
result line, the published peaks the rooflines divide by, and the check that
nothing of JAX was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}
FORBIDDEN = ("jax", "jaxlib", "flax", "probing_rag_tpu")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache the run might write goes to a fixed
    directory inside the checkout (the program's own kernel build lives in
    ``probing_rag_tpu_torch/kernels/_build``). Keeps libraries from loading
    JAX on their own."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cuda(chips: int) -> Optional[str]:
    """None when the run can go on, else why it cannot."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} visible"
    return None


def peaks(kind: str) -> Optional[dict]:
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def device_block(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (``probing_rag_tpu_torch`` is the port)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
