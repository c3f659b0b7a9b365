"""int8-weight matrix product of the quantized LM (w8a16). A CUDA kernel and
its plain PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_matmul.py::matmul_int8``:
``out = dt(x @ dt(q)) * dt(s)`` with f32 accumulation, the product rounded
to ``dt`` before the per-column scale is applied in ``dt`` (the op order of
``models/gemma.py::_mm``'s int8 branch). ``q`` is ``[K, N]``, or ``[N, K]``
with ``transpose_rhs`` (the tied head reads the ``[V, D]`` embedding).
:func:`matmul_int8` launches ``kernels/csrc/matmul_int8.cu`` for CUDA
tensors and takes :func:`matmul_int8_plain` for CPU tensors; there is no
other switch.
"""

from __future__ import annotations

import math

import torch

from probing_rag_tpu_torch import kernels

_MODES = {torch.bfloat16: 0, torch.float32: 1}
# matmul_int8.cu: 128 output columns per block; 16 rows x 64 deep per step
# up to 16 rows of x, 64 x 32 above
_BN, _SMALL_M = 128, 16
_BLOCKS_PER_SM = 4


def _check(x, q, s, dt, transpose_rhs):
    """Shapes and types both versions take. Returns (m, n, k)."""
    if dt not in _MODES:
        raise TypeError(f"dt must be bf16 or f32, got {dt}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"need a 2-D x and q, got {tuple(x.shape)} and {tuple(q.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    m, k = x.shape
    n, kq = q.shape if transpose_rhs else (q.shape[1], q.shape[0])
    if k != kq:
        raise ValueError(f"x {tuple(x.shape)} and q {tuple(q.shape)} disagree on K "
                         f"(transpose_rhs={transpose_rhs})")
    if s.dtype != torch.float32 or s.numel() != n:
        raise ValueError(f"s must hold {n} f32 column scales, got {s.dtype} {tuple(s.shape)}")
    return m, n, k


def matmul_int8_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                      dt: torch.dtype, transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of :func:`matmul_int8`: ``x`` cast to ``dt``, an f32
    product (products of a bf16 and an int8 value are exact in f32), cast
    to ``dt``, times the scale in ``dt``."""
    m, n, k = _check(x, q, s, dt, transpose_rhs)
    w = q.T if transpose_rhs else q
    acc = x.to(dt).float() @ w.float()
    return acc.to(dt) * s.reshape(1, n).to(dt)


def _splits(m: int, n: int, k: int, device) -> int:
    """K splits that give the SMs about ``_BLOCKS_PER_SM`` blocks each when
    the output tiles alone are too few, each split at least 2 steps deep."""
    bm, bk = (16, 64) if m <= _SMALL_M else (64, 32)
    tiles = math.ceil(n / _BN) * math.ceil(m / bm)
    steps = math.ceil(k / bk)
    want = math.ceil(_BLOCKS_PER_SM * kernels.sm_count(device) / tiles)
    splits = max(1, min(want, steps // 2))
    return math.ceil(steps / math.ceil(steps / splits))  # no empty split


def matmul_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                dt: torch.dtype, transpose_rhs: bool = False) -> torch.Tensor:
    """``[M, N]`` in ``dt`` = ``dt(x @ dt(q)) * dt(s)``.

    ``x`` is ``[M, K]`` (in ``dt`` for the kernel), ``q`` int8 ``[K, N]``
    (``[N, K]`` with ``transpose_rhs``), ``s`` the ``N`` f32 column scales
    in any shape (``[1, N]``, or the embedding's ``[V, 1]``). CPU tensors
    take the plain version; CUDA tensors launch the kernel, which needs
    contiguous operands."""
    m, n, k = _check(x, q, s, dt, transpose_rhs)
    dev = q.device
    if dev.type == "cpu":
        return matmul_int8_plain(x, q, s, dt=dt, transpose_rhs=transpose_rhs)
    if dev.type != "cuda":
        raise ValueError(f"no matmul_int8 for device {dev}")
    if x.device != dev or s.device != dev:
        raise ValueError(f"x on {x.device}, s on {s.device}, q on {dev}")
    if x.dtype != dt:
        raise TypeError(f"matmul_int8 kernel needs x in {dt}, got {x.dtype}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("matmul_int8 kernel needs contiguous x, q and s")
    out = torch.empty((m, n), dtype=dt, device=dev)
    if m == 0:
        return out
    mode = _MODES[dt]
    splits = _splits(m, n, k, dev) if mode == 0 else 1
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    tail = bool(k % 16 or (not transpose_rhs and n % 16)
                or x.data_ptr() % 16 or q.data_ptr() % 16)
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.matmul_int8(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                mode, int(transpose_rhs), m, n, k, splits, int(tail),
                kernels.stream_ptr(dev),
            ),
            "matmul_int8",
        )
    kernels.LAUNCHES["matmul_int8"] += 1
    return out
