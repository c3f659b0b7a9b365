"""int8-weight matrix product of the quantized LM (w8a16). A CUDA kernel and
its plain PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_matmul.py::matmul_int8``:
``out = dt(x @ dt(q)) * dt(s)`` with f32 accumulation, the product rounded
to ``dt`` before the per-column scale is applied in ``dt`` (the op order of
``models/gemma.py::_mm``'s int8 branch). ``q`` is ``[K, N]``, or ``[N, K]``
with ``transpose_rhs`` (the tied head reads the ``[V, D]`` embedding).
:func:`matmul_int8` launches ``kernels/csrc/matmul_int8.cu`` for CUDA
tensors, once per product, in the regime :func:`plan_matmul` picks from
the shapes (wgmma at prefill, small-M at decode, tail where TMA cannot
describe the operands), and takes :func:`matmul_int8_plain` for CPU
tensors; there is no other switch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from probing_rag_tpu_torch import kernels

_MODES = {torch.bfloat16: 0, torch.float32: 1}
REGIMES = ("wgmma", "small_m", "tail", "f32")
_REGIME_CODE = {"wgmma": 0, "small_m": 1, "tail": 2, "f32": 0}
# M above this takes the wgmma regime where TMA can describe the operands
# and the product has at least WGMMA_MIN_TILES output tiles: with fewer,
# its unsplit persistent blocks leave most SMs idle and the small-M
# regime's K splits are faster (chip_smoke.py's threshold sweep on an H100)
WGMMA_MIN_M, WGMMA_MIN_TILES = 64, 32
# matmul_int8.cu: the wgmma regime's 128-row tiles, 64 deep per step; the
# small-M and tail regimes' 128-column tiles, 16 rows x 64 deep up to 16
# rows, 64 x 32 above
_WG_BM, _WG_BK = 128, 64
_BN, _SMALL_M = 128, 16
# K splits: about _BLOCKS_PER_SM blocks a SM (more for K over _LONG_K
# steps), at most a cluster's 16 (from decode sweeps on an H100)
_BLOCKS_PER_SM, _LONG_K, MAX_SPLITS = 1.5, 64, 16


@dataclass(frozen=True)
class MatmulPlan:
    """How :func:`matmul_int8` runs one product: the regime, the output
    tile (``bm`` x ``bn``, ``bk`` deep per step), the K splits and the
    blocks launched (the wgmma regime's persistent blocks; else one block
    per tile and split)."""

    regime: str
    m: int
    n: int
    k: int
    bm: int
    bn: int
    bk: int
    splits: int
    grid: int


# the plan of the last product launched on the card (read by chip_smoke.py)
last_plan: MatmulPlan | None = None


def tma_describable(n: int, k: int, transpose_rhs: bool, x_ptr: int = 0, q_ptr: int = 0) -> bool:
    """Whether TMA can describe x ``[M, K]`` bf16 and q: 16-byte-aligned
    bases and row pitches (K % 8 for x; N % 16 for q ``[K, N]``, K % 16 for
    q ``[N, K]``)."""
    return (x_ptr % 16 == 0 and q_ptr % 16 == 0 and k % 8 == 0
            and (k % 16 == 0 if transpose_rhs else n % 16 == 0))


def plan_matmul(m: int, n: int, k: int, *, transpose_rhs: bool = False,
                dt: torch.dtype = torch.bfloat16, sm_count: int = 132, x_ptr: int = 0,
                q_ptr: int = 0) -> MatmulPlan:
    """The plan of one product, from its shapes, the operands' base
    addresses and the SM count alone:

    - ``wgmma`` for M > ``WGMMA_MIN_M`` where :func:`tma_describable` and
      the product has ``WGMMA_MIN_TILES`` tiles or more: 128 x 256 tiles
      (128 x 128 for N <= 128), one persistent block per SM up to the tile
      count;
    - ``small_m`` for the other products with K % 16 (and N % 16 for
      ``[K, N]``) and aligned bases: 16 x 128 tiles up to 16 rows, 64 x
      128 above (64 wide where 128-wide tiles are fewer than the SMs), K
      split over blocks (at most ``MAX_SPLITS``, one cluster per tile)
      while the tiles alone give the SMs fewer than ``_BLOCKS_PER_SM``
      blocks each (scaled by steps / ``_LONG_K`` past that depth), each
      split at least 2 steps deep;
    - ``tail`` for the rest: the small-M tiles with every element checked;
    - ``f32`` for the f32 mode: 32 x 32 tiles, no split."""
    if dt == torch.float32:
        return MatmulPlan("f32", m, n, k, 32, 32, 32, 1, math.ceil(m / 32) * math.ceil(n / 32))
    if m > WGMMA_MIN_M and tma_describable(n, k, transpose_rhs, x_ptr, q_ptr):
        bn = 256 if n > 128 else 128
        tiles = math.ceil(m / _WG_BM) * math.ceil(n / bn)
        if tiles >= WGMMA_MIN_TILES:
            return MatmulPlan("wgmma", m, n, k, _WG_BM, bn, _WG_BK, 1, min(tiles, sm_count))
    aligned = (k % 16 == 0 and (transpose_rhs or n % 16 == 0)
               and x_ptr % 16 == 0 and q_ptr % 16 == 0)
    regime = "small_m" if aligned else "tail"
    bm, bk = (16, 64) if m <= _SMALL_M else (64, 32)
    tiles = math.ceil(n / _BN) * math.ceil(m / bm)
    tile_n = _BN
    if regime == "small_m" and tiles < sm_count:
        tile_n = _BN // 2  # half-width tiles, twice as many
        tiles = math.ceil(n / tile_n) * math.ceil(m / bm)
    steps = math.ceil(k / bk)
    want = math.ceil(_BLOCKS_PER_SM * sm_count * max(1.0, steps / _LONG_K) / tiles)
    splits = max(1, min(want, steps // 2, MAX_SPLITS))
    splits = math.ceil(steps / math.ceil(steps / splits))  # no empty split
    return MatmulPlan(regime, m, n, k, bm, tile_n, bk, splits, tiles * splits)


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


def matmul_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                dt: torch.dtype, transpose_rhs: bool = False) -> torch.Tensor:
    """``[M, N]`` in ``dt`` = ``dt(x @ dt(q)) * dt(s)``.

    ``x`` is ``[M, K]`` (in ``dt`` for the kernel), ``q`` int8 ``[K, N]``
    (``[N, K]`` with ``transpose_rhs``), ``s`` the ``N`` f32 column scales
    in any shape (``[1, N]``, or the embedding's ``[V, 1]``). CPU tensors
    take the plain version; CUDA tensors launch the kernel once, which
    needs contiguous operands, in the regime :func:`plan_matmul` picks."""
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
    global last_plan
    plan = plan_matmul(m, n, k, transpose_rhs=transpose_rhs, dt=dt,
                       sm_count=kernels.sm_count(dev), x_ptr=x.data_ptr(), q_ptr=q.data_ptr())
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.matmul_int8(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), _MODES[dt], int(transpose_rhs), _REGIME_CODE[plan.regime], m, n, k,
                plan.bm, plan.bn, plan.splits, plan.grid, kernels.stream_ptr(dev),
            ),
            "matmul_int8",
        )
    kernels.LAUNCHES["matmul_int8"] += 1
    last_plan = plan
    return out
