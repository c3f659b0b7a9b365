"""Quantized-weight matrix products of the LM: int8 (w8a16) and int4
(w4a16). Two CUDA kernels and their plain PyTorch versions.

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

:func:`matmul_int4` computes ``models/gemma.py::_mm``'s int4 branches (the
JAX ``_mm``'s rank-1 and grouped forms, and the tied head of an int4
embedding) from the packed nibbles of ``ops/attention.py::pack_int4``:
``kernels/csrc/matmul_int4.cu`` reads them from device memory and widens
them on chip, in the regime :func:`plan_matmul_int4` picks (stream at
decode and verify rows, wgmma for rank-1 at prefill and grouped from 65
rows, small-M for the tied head, tail where cp.async cannot copy the
operands). :func:`matmul_int4_plain`, which CPU tensors take, unpacks the
weight first.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.ops.attention import unpack_int4

_MODES = {torch.bfloat16: 0, torch.float32: 1}
REGIMES = ("wgmma", "small_m", "tail", "f32", "stream")
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
    # matmul_int4's stream regime: the ring's stages, the x window's steps
    # and the launch's units (column tiles x depth steps)
    stages: int = 0
    xsteps: int = 0
    units: int = 0


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


# ------------------------------------------------------------------ int4

INT4_SCHEMES = ("rank1", "grouped", "channel")
_FN_CODE = {"rank1": 0, "grouped": 1, "channel": 2}
_REGIME4_CODE = {"wgmma": 0, "small_m": 1, "tail": 2, "f32": 3, "stream": 4}
# matmul_int4.cu's small-M regime: 64-column tiles of 8, 16 or 32 rows
# (more rows take more tiles), steps 128 deep (grouped: whole groups, at
# most 128), each block's warps taking its steps in turn
_BN4, _BK4 = 64, 128
# its stream regime (namespace st): units of 256 columns x 128 depths (16
# KB of nibbles; grouped: one group of 128), one row tile of STREAM_ROWS, a
# ring of STREAM_STAGES units (fewer where the x window needs the room, at
# least STREAM_MIN_STAGES), STREAM_BLOCKS_PER_SM persistent blocks a SM, a
# counter per column tile (at most STREAM_MAX_TILES a launch). A column
# tile split into at most STREAM_MAX_CLUSTER equal pieces is finished by a
# cluster of their blocks (clusters of 16 such blocks, a SM each, did not
# run at once on an H100: their tiles took the scratch's time); one split
# further goes through the scratch, whose round trips cost ~3 us. At 8
# rows, shares of at most STREAM_MIN_SCRATCH_SHARE units take the small-M
# regime where it was faster on an H100: grouped, and rank-1 that would
# need the scratch (a decode step's wo and grouped wq + wk + wv); at 40
# rows that regime reads each weight twice
STREAM_ROWS = (8, 16, 32, 40, 64)
_ST_BN, _ST_BK, _ST_UNIT = 256, 128, 128 * 128
STREAM_STAGES, STREAM_MIN_STAGES = 8, 4
STREAM_BLOCKS_PER_SM, STREAM_MAX_TILES = 1, 4096
STREAM_MAX_CLUSTER, STREAM_MIN_SCRATCH_SHARE = 8, 2
_SMEM_MAX = 232448  # a block's dynamic shared memory on Hopper


def stream_smem(stages: int, xsteps: int, rows: int) -> int:
    """Dynamic shared memory of a stream block (``st::Layout::alloc``): the
    ring, the x window of ``xsteps`` steps of 128 depths x ``rows`` bf16
    rows, two barriers a stage, two flags (16 bytes), at 8 rows the second
    pair of consumer warpgroups' sums (256 threads x 8 f32), and 1,024
    bytes to align the base."""
    pairs = rows * 256 * 4 if rows == 8 else 0
    return stages * (_ST_UNIT + 16) + xsteps * rows * _ST_BK * 2 + 16 + pairs + 1024


def stream_schedule(plan: MatmulPlan):
    """The blocks' shares of a stream plan's units (``st::Shares``): block
    b takes units ``[start(b), start(b + 1))``, unit ``T * steps + s``
    step s of column tile T; the first ``units % grid`` blocks one unit
    more. Returns ``start``, a list of grid + 1 unit indices."""
    per, rem = divmod(plan.units, plan.grid)
    return [b * per + min(b, rem) for b in range(plan.grid + 1)]


def _stream_grid(units: int, steps: int, blocks: int) -> int:
    """Persistent blocks for ``units`` (``steps`` a column tile) on at most
    ``blocks``: where a share no longer than the fewest possible divides
    the units and either divides a tile's steps or is whole tiles, that
    many blocks, so that no share straddles two tiles (one x window a
    block; whole tiles need no fixup); else ``min(units, blocks)``."""
    least = math.ceil(units / blocks)
    for share in range(least, 2 * least):
        if units % share == 0 and (steps % share == 0 or share % steps == 0):
            return units // share if share == least else min(units, blocks)
    return min(units, blocks)


def _plan_stream(m: int, ns, k: int, sm_count: int) -> MatmulPlan:
    """The stream plan: the smallest row tile that holds M; one block a SM
    (``STREAM_BLOCKS_PER_SM``) up to the units, tile-aligned where that
    costs no unit a block (``_stream_grid``); an x window as deep as the
    longest share (the whole K if a share may span it), each depth loaded
    once a piece; the deepest ring that the window leaves room for, at most
    ``STREAM_STAGES``, else ``STREAM_MIN_STAGES`` and a shallower window;
    where a tile splits into equal pieces, one a block, of at most
    ``STREAM_MAX_CLUSTER``, ``splits`` is the cluster they form."""
    rows = next(r for r in STREAM_ROWS if r >= m)
    steps = math.ceil(k / _ST_BK)
    units = sum(math.ceil(w / _ST_BN) for w in ns) * steps
    grid = _stream_grid(units, steps, sm_count * STREAM_BLOCKS_PER_SM)
    xsteps = min(steps, math.ceil(units / grid))
    room = _SMEM_MAX - stream_smem(0, xsteps, rows)
    stages = min(STREAM_STAGES, room // (_ST_UNIT + 16))
    if stages < STREAM_MIN_STAGES:
        stages = STREAM_MIN_STAGES
        xsteps = (_SMEM_MAX - stream_smem(stages, 0, rows)) // (rows * _ST_BK * 2)
    # a column tile split over blocks in equal pieces, one a block (grid =
    # tiles x pieces): its pieces form a cluster that adds them through
    # distributed shared memory
    share = units // grid
    pieces = steps // share if units % grid == 0 and steps % share == 0 else 1
    cluster = pieces if 2 <= pieces <= STREAM_MAX_CLUSTER else 1
    return MatmulPlan("stream", m, sum(ns), k, rows, _ST_BN, _ST_BK, cluster, grid,
                      stages=stages, xsteps=xsteps, units=units)


def stream_scratch_fixup(plan: MatmulPlan) -> bool:
    """Whether a stream plan finishes split column tiles through the scratch
    and counters (no cluster holds their pieces)."""
    share, ragged = divmod(plan.units, plan.grid)
    return plan.splits == 1 and bool(ragged or share % math.ceil(plan.k / _ST_BK))


def int4_tma_describable(n: int, k: int, x_ptr: int = 0, q_ptr: int = 0) -> bool:
    """Whether TMA (and cp.async) can copy x ``[M, K]`` bf16 and the packed
    ``[K, N/2]`` weight: 16-byte-aligned bases and row pitches (K % 8, N %
    32)."""
    return x_ptr % 16 == 0 and q_ptr % 16 == 0 and k % 8 == 0 and (n // 2) % 16 == 0


def plan_matmul_int4(m: int, n, k: int, *, scheme: str, group: int = 0,
                     dt: torch.dtype = torch.bfloat16, sm_count: int = 132, x_ptr: int = 0,
                     q_ptr: int = 0, gs_ptr: int = 0) -> MatmulPlan:
    """The plan of one int4 launch (``matmul_int4.cu``'s C entries refuse
    any other), from its shapes, scheme, group, the operands' base addresses
    (``gs_ptr``: grouped's scales, copied with each step; for several
    weights the bitwise or of theirs, which is 16-byte aligned only if each
    is) and the SM count alone. ``n`` is the output width, or a tuple of
    the widths of several weights that share x (:func:`matmul_int4` with a
    list: the small-M regime only, their column tiles on one grid,
    ``plan.n`` their sum):

    - ``wgmma`` for rank-1 at M > ``WGMMA_MIN_M`` where
      :func:`int4_tma_describable` and the product has ``WGMMA_MIN_TILES``
      tiles or more: 128 x 256 tiles (128 x 128 for N <= 128), one
      persistent block per SM up to the tile count; and for grouped (one
      weight, groups of 128) at M > ``WGMMA_MIN_M`` where TMA can describe
      it and there are ``WGMMA_MIN_TILES`` tiles or more: 128 x 128 tiles,
      so a weight is read ceil(M / 128) times;
    - ``stream`` for rank-1 and grouped (groups of 128) at up to
      ``WGMMA_MIN_M`` rows where TMA can describe every weight (and gs is
      16-byte aligned), at most ``STREAM_MAX_TILES`` column tiles:
      :func:`_plan_stream`, unless at 8 rows its shares are of at most
      ``STREAM_MIN_SCRATCH_SHARE`` units and the scheme is grouped or the
      plan's split tiles need the scratch (a decode step's wo, and its
      grouped wq + wk + wv);
    - ``small_m`` for the other products whose packed rows are whole
      16-byte pieces (N % 32, or K % 32 for the channel scheme's ``[N,
      K/2]``) with K % 8 and aligned bases: tiles of 64 columns and 8, 16
      or 32 rows (the fewest that hold M, at most 32), steps 128 deep
      (grouped: the most whole groups that fit in 128), K split over a
      cluster (at most ``MAX_SPLITS``, never more splits than steps) while
      the tiles alone give the SMs fewer than ``_BLOCKS_PER_SM`` blocks
      each;
    - ``tail`` for the rest: the same tiles, every element checked;
    - ``f32`` for the f32 mode: 32 x 32 tiles, no split."""
    ns = tuple(n) if isinstance(n, (tuple, list)) else (n,)
    n = sum(ns)
    if dt == torch.float32:
        return MatmulPlan("f32", m, n, k, 32, 32, 32, 1, math.ceil(m / 32) * math.ceil(n / 32))
    channel = scheme == "channel"
    if (scheme == "rank1" and len(ns) == 1 and m > WGMMA_MIN_M
            and int4_tma_describable(n, k, x_ptr, q_ptr)):
        bn = 256 if n > 128 else 128
        tiles = math.ceil(m / _WG_BM) * math.ceil(n / bn)
        if tiles >= WGMMA_MIN_TILES:
            return MatmulPlan("wgmma", m, n, k, _WG_BM, bn, _WG_BK, 1, min(tiles, sm_count))
    tma = (all(int4_tma_describable(w, k, x_ptr, q_ptr) for w in ns) and gs_ptr % 16 == 0
           and (scheme == "rank1" or (scheme == "grouped" and group == _ST_BK)))
    if tma and scheme == "grouped" and len(ns) == 1 and m > WGMMA_MIN_M:
        tiles = math.ceil(m / _WG_BM) * math.ceil(n / _WG_BM)
        if tiles >= WGMMA_MIN_TILES:
            return MatmulPlan("wgmma", m, n, k, _WG_BM, _WG_BM, _WG_BK, 1, min(tiles, sm_count))
    if tma and m <= WGMMA_MIN_M and sum(math.ceil(w / _ST_BN) for w in ns) <= STREAM_MAX_TILES:
        plan = _plan_stream(m, ns, k, sm_count)
        short = plan.bm == 8 and plan.units // plan.grid <= STREAM_MIN_SCRATCH_SHARE
        if not (short and (scheme == "grouped" or stream_scratch_fixup(plan))):
            return plan
    rows_aligned = all((k if channel else w) // 2 % 16 == 0 for w in ns)
    aligned = (k % 8 == 0 and rows_aligned and x_ptr % 16 == 0 and q_ptr % 16 == 0
               and gs_ptr % 16 == 0)
    bm = 8 if m <= 8 else 16 if m <= 16 else 32
    bk = _BK4 // group * group if scheme == "grouped" else _BK4
    tiles = sum(math.ceil(w / _BN4) for w in ns) * math.ceil(m / bm)
    steps = math.ceil(k / bk)
    want = math.ceil(_BLOCKS_PER_SM * sm_count / tiles)
    splits = max(1, min(want, steps, MAX_SPLITS))
    splits = math.ceil(steps / math.ceil(steps / splits))  # no empty split
    return MatmulPlan("small_m" if aligned else "tail", m, n, k, bm, _BN4, bk, splits,
                      tiles * splits)


def _check_int4(x, qp, dt, scheme, rs, s, gs, transpose_rhs):
    """Shapes and types both versions take. Returns (m, n, k, group)."""
    if dt not in _MODES:
        raise TypeError(f"dt must be bf16 or f32, got {dt}")
    if scheme not in INT4_SCHEMES:
        raise ValueError(f"scheme must be one of {INT4_SCHEMES}, got {scheme!r}")
    if transpose_rhs != (scheme == "channel"):
        raise ValueError("the channel scheme (the tied head) reads qp [N, K/2] with "
                         "transpose_rhs; rank1 and grouped read qp [K, N/2] without it")
    if x.dim() != 2 or qp.dim() != 2:
        raise ValueError(f"need a 2-D x and qp, got {tuple(x.shape)} and {tuple(qp.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if qp.dtype != torch.uint8:
        raise TypeError(f"qp must hold uint8 nibble pairs, got {qp.dtype}")
    m, k = x.shape
    n, kq = (qp.shape[0], 2 * qp.shape[1]) if transpose_rhs else (2 * qp.shape[1], qp.shape[0])
    if k != kq:
        raise ValueError(f"x {tuple(x.shape)} and qp {tuple(qp.shape)} disagree on K "
                         f"(scheme {scheme})")

    def f32(t, what):
        if t is None or t.dtype != torch.float32:
            raise ValueError(f"scheme {scheme} needs {what} in f32, got "
                             f"{None if t is None else t.dtype}")
        return t

    group = 0
    if scheme == "grouped":
        gs = f32(gs, "gs [K / group, N]")
        if gs.dim() != 2 or gs.shape[1] != n or gs.shape[0] == 0 or k % gs.shape[0]:
            raise ValueError(f"gs must be [K / group, {n}] with K {k}, got {tuple(gs.shape)}")
        group = k // gs.shape[0]
    else:
        s = f32(s, "s (N column scales)")
        if s.numel() != n:
            raise ValueError(f"s must hold {n} column scales, got {tuple(s.shape)}")
    if scheme == "rank1":
        rs = f32(rs, "rs (K / group row scales)")
        if rs.numel() == 0 or k % rs.numel():
            raise ValueError(f"rs must hold K / group scales with K {k}, got {tuple(rs.shape)}")
        group = k // rs.numel()
    return m, n, k, group


def matmul_int4_plain(x: torch.Tensor, qp: torch.Tensor, *, dt: torch.dtype, scheme: str,
                      rs=None, s=None, gs=None, transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of :func:`matmul_int4`: the weight unpacked to int8
    (``unpack_int4``), then ``models/gemma.py::_mm``'s op order: rank-1
    scales ``x`` by ``rs`` in f32 and takes :func:`matmul_int8_plain`;
    grouped takes a ``dt`` product per group, its f32 partials scaled by
    ``gs`` and summed; channel is :func:`matmul_int8_plain` on ``[N,
    K]``."""
    m, n, k, group = _check_int4(x, qp, dt, scheme, rs, s, gs, transpose_rhs)
    q = unpack_int4(qp)
    if scheme == "grouped":
        kg = gs.shape[0]
        part = torch.einsum("rkg,kgf->rkf", x.to(dt).reshape(m, kg, group),
                            q.reshape(kg, group, n).to(dt))
        return torch.einsum("rkf,kf->rf", part.float(), gs).to(dt)
    if scheme == "rank1":
        x = (x.float().reshape(m, -1, group) * rs.reshape(-1, 1)).reshape(m, k)
    return matmul_int8_plain(x.to(dt), q, s, dt=dt, transpose_rhs=transpose_rhs)


def int4_grouped_tolerance(x: torch.Tensor, qp: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """Per-output bound on a bf16 grouped product summed in another order
    than :func:`matmul_int4_plain` (the kernel's 16-deep products, its K
    splits): each group partial may round to the neighbouring bf16 value
    (one step, at most 2^-7 of its size) before it is scaled by gs, and the
    result rounds once more (2^-7 of its size); partials whose f32 sums
    differ in their last bits add 2^-20 of the sum of |x q gs|."""
    m, k = x.shape
    kg, n = gs.shape
    xg = x.float().reshape(m, kg, k // kg)
    q = unpack_int4(qp).float().reshape(kg, k // kg, n)
    part = torch.einsum("rkg,kgf->rkf", xg, q)
    mag = torch.einsum("rkg,kgf->rkf", xg.abs(), q.abs())
    ref = torch.einsum("rkf,kf->rf", part, gs)
    return (2**-7 * (torch.einsum("rkf,kf->rf", part.abs(), gs.abs()) + ref.abs())
            + 2**-20 * torch.einsum("rkf,kf->rf", mag, gs.abs()))


# the most weights that share x in one launch (matmul_int4.cu's
# MAX_PRODUCTS)
MAX_SHARED = 3
# the stream regime's column-tile counters on each device: zeros that every
# launch leaves at zero (the block that finishes a split tile resets its
# counter), so consecutive launches on a stream share them
_TILE_COUNTERS: dict = {}


def _tile_counters(dev: torch.device) -> torch.Tensor:
    """The stream regime's ``STREAM_MAX_TILES`` counters on ``dev``, made
    at the first stream launch there. A CUDA graph capture records a fill
    without running it, so they must exist before any capture: the
    captured steps' warm-up runs every product eagerly first."""
    buf = _TILE_COUNTERS.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("matmul_int4: the stream regime's tile counters are made outside "
                               "a CUDA graph capture; run the product once before capturing it")
        buf = _TILE_COUNTERS[dev] = torch.zeros(STREAM_MAX_TILES, dtype=torch.int32, device=dev)
    return buf


# each scheme's scales in a weight's leaf, beside its "qp"
_SCALES4 = {"rank1": ("rs", "s"), "grouped": ("gs",), "channel": ("s",)}


def matmul_int4(x: torch.Tensor, w, *, dt: torch.dtype, scheme: str,
                transpose_rhs: bool = False):
    """``[M, N]`` in ``dt``: ``x`` ``[M, K]`` times the int4 weight ``w``, a
    leaf of ``models/gemma.py::quantize_lm_params``: ``qp`` (uint8 nibble
    pairs, ``ops/attention.py::pack_int4``) and the scales of ``scheme``:

    - ``"rank1"``: qp ``[K, N/2]``, ``rs`` the K / group f32 row scales,
      ``s`` the N f32 column scales: ``dt(xs @ dt(q)) * dt(s)`` with ``xs =
      dt(f32(x) * rs[k // group])``;
    - ``"grouped"``: qp ``[K, N/2]``, ``gs`` f32 ``[K / group, N]``:
      ``dt(sum_j f32(dt(x_j @ q_j)) * gs[j])`` over the groups j;
    - ``"channel"`` (``transpose_rhs``): qp ``[N, K/2]``, ``s`` the N column
      scales: ``dt(x @ dt(q^T)) * dt(s)``, the tied head of an int4
      embedding.

    ``w`` may also be a list of rank-1 or grouped leaves of one group that
    share ``x`` (a layer's wq, wk and wv; its w_gate and w_up); then the
    result is the list of their products.

    CPU tensors take :func:`matmul_int4_plain`. CUDA tensors launch the
    kernel in the plans :func:`plan_matmul_int4` gives, which needs ``x``
    in ``dt``, contiguous operands and, in bf16, a group that is a multiple
    of 16 (grouped: at most 128). Weights that share ``x`` take one launch
    for each ``MAX_SHARED`` of them in bf16 at up to ``WGMMA_MIN_M`` rows
    (the stream or small-M regime: fewer launches, one load latency for
    the small products), otherwise one launch a weight."""
    many = isinstance(w, (list, tuple))
    ws = list(w) if many else [w]
    if many and (scheme == "channel" or not ws):
        raise ValueError(f"a list of weights must hold rank1 or grouped leaves, got {len(ws)} "
                         f"{scheme!r}")
    shapes = [_check_int4(x, v["qp"], dt, scheme, v.get("rs"), v.get("s"), v.get("gs"),
                          transpose_rhs) for v in ws]
    m, _, k, group = shapes[0]
    if any(sh[2:] != (k, group) for sh in shapes):
        raise ValueError(f"weights disagree on K or group: {[sh[2:] for sh in shapes]}")
    keys = _SCALES4[scheme]
    dev = ws[0]["qp"].device
    if dev.type == "cpu":
        outs = [matmul_int4_plain(x, v["qp"], dt=dt, scheme=scheme, transpose_rhs=transpose_rhs,
                                  **{key: v[key] for key in keys}) for v in ws]
        return outs if many else outs[0]
    if dev.type != "cuda":
        raise ValueError(f"no matmul_int4 for device {dev}")
    ops = [x] + [v[key] for v in ws for key in ("qp", *keys)]
    if any(t.device != dev for t in ops):
        raise ValueError(f"operands on {sorted({str(t.device) for t in ops})}, qp on {dev}")
    if x.dtype != dt:
        raise TypeError(f"matmul_int4 kernel needs x in {dt}, got {x.dtype}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("matmul_int4 kernel needs contiguous operands")
    if dt == torch.bfloat16 and scheme != "channel" and group % 16:
        raise ValueError(f"matmul_int4 kernel needs a group that is a multiple of 16, got {group}")
    if dt == torch.bfloat16 and scheme == "grouped" and group > _BK4:
        raise ValueError(f"matmul_int4 kernel needs a grouped group of at most {_BK4}, got {group}")
    share = MAX_SHARED if dt == torch.bfloat16 and m <= WGMMA_MIN_M else 1
    outs = []
    for i in range(0, len(ws), share):
        outs += _launch_int4(x, ws[i : i + share], [sh[1] for sh in shapes[i : i + share]],
                             dt=dt, scheme=scheme, k=k, group=group)
    return outs if many else outs[0]


def _launch_int4(x, ws, ns, *, dt, scheme, k, group) -> list:
    """One launch of ``matmul_int4.cu`` (two in the wgmma regime) for the
    checked weights ``ws``, of widths ``ns``, that share ``x``."""
    global last_plan
    dev, m = x.device, x.shape[0]
    outs = [torch.empty((m, n), dtype=dt, device=dev) for n in ns]
    if m == 0:
        return outs
    q_or = gs_or = 0
    for v in ws:
        q_or |= v["qp"].data_ptr()
        gs_or |= v["gs"].data_ptr() if scheme == "grouped" else 0
    plan = plan_matmul_int4(m, tuple(ns), k, scheme=scheme, group=group, dt=dt,
                            sm_count=kernels.sm_count(dev), x_ptr=x.data_ptr(), q_ptr=q_or,
                            gs_ptr=gs_or)
    # rank-1's wgmma regime first folds rs into a copy of x (an activation);
    # the stream regime writes the partial sums of split column tiles, two
    # slots of rows x 256 f32 a block, and counts their pieces
    xs = counters = None
    if plan.regime == "wgmma" and scheme == "rank1":
        xs = torch.empty_like(x)
    elif plan.regime == "stream":
        xs = torch.empty(plan.grid * 2 * plan.bm * _ST_BN, dtype=torch.float32, device=dev)
        counters = _tile_counters(dev)
    count = len(ws)
    arr = lambda ts: (ctypes.c_void_p * count)(*[t.data_ptr() for t in ts])  # noqa: E731
    col = lambda key: arr([v[key] for v in ws]) if key in _SCALES4[scheme] else None  # noqa: E731
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.matmul_int4(
                x.data_ptr(), arr([v["qp"] for v in ws]), col("rs"), col("s"), col("gs"),
                arr(outs), (ctypes.c_int * count)(*ns), count,
                None if xs is None else xs.data_ptr(), _MODES[dt], _FN_CODE[scheme],
                _REGIME4_CODE[plan.regime], m, k, group, plan.bm, plan.bn, plan.splits,
                plan.grid, plan.stages, plan.xsteps,
                None if counters is None else counters.data_ptr(), kernels.stream_ptr(dev),
            ),
            "matmul_int4",
        )
    kernels.LAUNCHES["matmul_int4"] += 1
    last_plan = plan
    return outs
