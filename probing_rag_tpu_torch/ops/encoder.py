"""The Contriever encoder's elementwise work: three CUDA kernels and their
plain PyTorch versions.

Not a port of a Pallas kernel. The JAX package's encoder
(``probing_rag_tpu/models/encoder.py::encoder_forward``) is one jitted
program (``probing_rag_tpu/cli/main.py:147``), and XLA fuses this work into
its products and one reduction a norm. Plain PyTorch ops run it as some
twenty kernels a layer with f32 temporaries. The three kernels here keep
the intermediates in registers:

- :func:`add_layer_norm` (``kernels/csrc/layer_norm.cu``): ``LN(resid +
  f32(bf16(delta + bias)))`` with its bf16 copy, the next product's input
  (JAX ``:124-131``, ``:134-139``); without a delta the LayerNorm of the
  embedding sum (``:97-102``). XLA's fusion of the bias add of the
  attention output and of the MLP output, the residual add and ``_ln``.
- :func:`bias_gelu` (``kernels/csrc/bias_gelu.cu``): ``gelu(bf16(h + b))``,
  exact GELU in JAX's erfc form, in place (JAX ``:132``): XLA's fusion of
  the bias add and the GELU into the first MLP product. The kernel looks
  each result up in :func:`gelu_table`, the 65,536 exact results, which
  ``gelu_table_build`` computes once a device at first use.
- :func:`qkv_heads` (``kernels/csrc/qkv_heads.cu``): the q, k and v bias
  adds on one product of the concatenated ``wq | wk | wv``, q as ``[B, T,
  H, hd]`` and k and v as ``[B, H, T, hd]``, the contiguous slot rows
  ``prefill_attention`` reads (JAX ``:111-119``): XLA's fusion of the bias
  adds and the layouts into the products and the attention's dots.

The attention itself (JAX ``:119-123``) is ``ops/attention.py::
prefill_attention`` under the key-padding mask (``qpos = kpos = 0``,
``valid`` the mask), with its output stored in bf16.

Each is bound by device-memory bytes on the H100 at the index build's rows
(a few operations a byte, below its ridge of ~295), by latency at a query
batch's: the kernels read each input once and write each output once, and
their launch geometry comes from :func:`plan_layer_norm`,
:func:`plan_bias_gelu` and :func:`plan_qkv_heads`, which the C entries
check. CUDA tensors launch the kernel or raise on a dtype, shape or stride
it does not take; CPU tensors take the plain version (``*_plain``), which
is the JAX package's arithmetic as PyTorch ops. There is no other switch.
The checks run on every device, before either version. The plain versions
also take f32 compute (``models/encoder.py``'s checking mode, and configs
:func:`kernels_take` refuses), where each rounds to f32 instead of bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.ops.attention import PREFILL_HEAD_DIMS
from probing_rag_tpu_torch.ops.block import _aligned, _on_cuda, rounding_bound

_FLOATS = (torch.bfloat16, torch.float32)
_BF16 = (torch.bfloat16,)
# sqrt(1/2) as jax.nn.gelu holds it (np.sqrt(0.5).astype(float32))
SQRT_HALF = float(np.float32(np.sqrt(0.5)))


# ------------------------------------------------------------ plain versions


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX ``_ln`` in f32: ``(x - mean) * rsqrt(var + eps) * w + b``,
    the variance ``mean((x - mean)^2)`` (``jnp.var``'s two passes)."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * w.float() + b.float()


def add_layer_norm_plain(resid: torch.Tensor, delta: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
                         eps: float, dt: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_layer_norm`: ``resid + f32(delta +
    bias)`` (the bias add in ``dt``, bf16 or f32), :func:`layer_norm`, and
    its copy in ``dt``; ``w`` and ``b`` in either type."""
    _check_ln(resid, delta, bias, w, b, dt, _FLOATS)
    x = resid if delta is None else resid + (delta + bias).float()
    out = layer_norm(x, w, b, eps)
    return out, out.to(dt)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` in f32: ``0.5 x erfc(-x
    sqrt(1/2))``."""
    return 0.5 * x * torch.erfc(-x * SQRT_HALF)


def bias_gelu_plain(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bias_gelu`: the bias add in ``h``'s type
    (bf16 or f32), then :func:`gelu_exact` of it in f32, rounded to that
    type."""
    _check_gelu(h, bias, _FLOATS)
    return gelu_exact((h + bias).float()).to(h.dtype)


def qkv_heads_plain(y: torch.Tensor, bq: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor,
                    n_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`qkv_heads`: each bias added in ``y``'s type
    (bf16 or f32) to its third of ``y``, q reshaped to ``[B, T, H, hd]``, k
    and v to ``[B, H, T, hd]`` contiguous."""
    b, t, d, hd = _check_qkv(y, bq, bk, bv, n_heads, _FLOATS)
    q = (y[..., :d] + bq).reshape(b, t, n_heads, hd)
    k = (y[..., d:2 * d] + bk).reshape(b, t, n_heads, hd).transpose(1, 2).contiguous()
    v = (y[..., 2 * d:] + bv).reshape(b, t, n_heads, hd).transpose(1, 2).contiguous()
    return q, k, v


# --------------------------------------------------------------- tolerances
#
# The kernels round where the plain ops do, so bias_gelu and qkv_heads are
# expected bit-equal to their plain versions on the card. The norm's mean
# and variance are f32 sums in another order than torch's (its variance a
# Welford reduction, the kernel's two passes over the row in registers):
# each may lie a few f32 ulps of its operands apart, so the norm's output
# may differ from the plain one by that much through the rounding to bf16.

# the mean: a few ulps of the row's sum of |x| (sums of 768 values over
# 24-element lanes and a 5-level butterfly against torch's vectorised
# tree: each side's rounding within ~30 ulps of the sum of |x| in the worst
# case), 2^-16 of the row's mean |x| with room
LN_MEAN_REL = 2.0 ** -16
# the variance: the same for the sum of squares, and Welford's updates;
# rsqrt then halves it (its own ~2 ulps inside)
LN_VAR_REL = 2.0 ** -15
# the four roundings of (x - mean) * r * w + b, each moved by the above
LN_ROUND_REL = 2.0 ** -21
# erfcf against another implementation (JAX on the CPU, a libdevice that
# differs): a few f32 ulps of the GELU
GELU_REL = 2.0 ** -20


def layer_norm_tolerance(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-element bounds of :func:`add_layer_norm`'s f32 output and
    its bf16 copy around the plain ones, for ``x`` the norm's f32 input
    (``resid + f32(bf16(delta + bias))``): ``(LN_MEAN_REL mean|x| +
    LN_VAR_REL |x - mean|) r |w| + LN_ROUND_REL (|out| + |b|)``, with ``r``
    the row's ``rsqrt(var + eps)``, then through the rounding to bf16. A
    skipped bias add, a delta left unrounded before the add, or the
    unbiased variance lands outside it."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    c = x - mean
    r = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    ref = layer_norm(x, w, b, eps)
    err = ((LN_MEAN_REL * x.abs().mean(-1, keepdim=True) + LN_VAR_REL * c.abs()) * r
           * w.float().abs() + LN_ROUND_REL * (ref.abs() + b.float().abs()))
    return rounding_bound(ref, err, torch.float32), rounding_bound(ref, err, torch.bfloat16)


def gelu_tolerance(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The per-element bound of :func:`bias_gelu` around the plain one:
    ``GELU_REL`` of the f32 value, through the rounding to bf16 (0 where it
    rounds to one value: most elements)."""
    ref = gelu_exact((h + bias).float())
    return rounding_bound(ref, GELU_REL * ref.abs(), torch.bfloat16)


# ------------------------------------------------------------------ planners
#
# The kernels' launch geometry, chosen here from the shapes and passed to
# the C entries, which hold the same rule (namespaces lnorm, bgelu, qkvh)
# and refuse any other plan. tests/test_torch_encoder_kernels.py compiles
# those rules with the host compiler and holds these plans to them.

# layer_norm.cu: a warp a row of LN_WIDTH, 4-wide f32 vectors, LN_PER a
# lane, LN_WARPS rows a block
LN_VEC = 4
LN_WARPS = 4
LN_WIDTH = 768  # Contriever's D, the one row a configuration runs on the card
LN_PER = LN_WIDTH // (32 * LN_VEC)
# qkv_heads.cu: a 16-byte vector of 8 bf16 values a thread, in blocks of
# VEC_THREADS
VEC = 8
VEC_THREADS = 128
MAX_INDEX = 2**31 - 1  # the kernels' thread indices in 32-bit ints
# bias_gelu.cu (namespace bgelu): GELU_BLOCKS_PER_SM resident blocks of
# GELU_THREADS an SM, GELU_UNROLL vectors of 8 a thread a step; the window
# of the table each block keeps in shared memory: the patterns whose
# magnitude bits lie in [GELU_WIN_LO, GELU_WIN_LO + GELU_WIN_LEN), of each
# sign: |x| in [2^-16, 2^8)
GELU_THREADS = 512
GELU_BLOCKS_PER_SM = 2
GELU_UNROLL = 2
GELU_WIN_LO = 0x3780  # the bf16 bits of 2^-16
GELU_WIN_LEN = 24 * 128  # 24 binades of 128 patterns
GELU_TABLE = 65536  # one entry a bf16 pattern


class LnPlan(NamedTuple):
    per: int  # 4-wide vectors a lane (the last ones idle past d)
    warps: int  # rows a block, a warp each
    blocks: int


class VecPlan(NamedTuple):
    vec: int  # bf16 values a thread
    threads: int  # a block
    blocks: int


class GeluPlan(NamedTuple):
    vec: int  # bf16 values a vector
    threads: int  # a block
    blocks: int  # resident: at most GELU_BLOCKS_PER_SM an SM
    unroll: int  # vectors a thread a step
    win_lo: int  # the window's least magnitude bits
    win_len: int  # its patterns of each sign


def plan_layer_norm(rows: int, d: int) -> LnPlan:
    """``layer_norm.cu``'s launch over ``rows`` rows of width ``d`` (which
    must be ``LN_WIDTH``): a warp a row, lane l on the vectors ``l + 32 j``,
    ``LN_WARPS`` rows a block (the index build's 512 x 380 rows: 48,640
    blocks; a query batch's 8 x 40: 80)."""
    if rows < 1 or d != LN_WIDTH:
        raise ValueError(f"layer_norm kernel takes rows of {LN_WIDTH}, got {rows} of {d}")
    blocks = -(-rows // LN_WARPS)
    if blocks > MAX_INDEX:
        raise ValueError(f"layer_norm kernel takes up to {MAX_INDEX} blocks, {rows} rows need more")
    return LnPlan(LN_PER, LN_WARPS, blocks)


def _vec_plan(units: int, what: str) -> VecPlan:
    blocks = max(1, -(-units // VEC_THREADS))
    if blocks * VEC_THREADS > MAX_INDEX:
        raise ValueError(f"{what} kernel indexes its threads in 32-bit ints: {units} vectors "
                         f"need more")
    return VecPlan(VEC, VEC_THREADS, blocks)


def plan_bias_gelu(rows: int, f: int, sms: int) -> GeluPlan:
    """``bias_gelu.cu``'s launch over ``rows`` rows of ``f`` bf16 values on
    a card of ``sms`` SMs: blocks of ``GELU_THREADS`` that each fill the
    table's window once and then walk vectors of 8, ``GELU_UNROLL`` a
    thread a step, the next step's loads in flight; as many blocks as give
    each thread one step, at most ``GELU_BLOCKS_PER_SM`` an SM (the index
    build's 512 x 376 rows on 132 SMs: 264 blocks of ~273 steps; a query
    batch's 8 x 40: 120 blocks of one)."""
    if rows < 1 or f < VEC or f % VEC or sms < 1:
        raise ValueError(f"bias_gelu kernel takes rows of a multiple of {VEC}, got {f}")
    vecs = rows * (f // VEC)
    step = GELU_THREADS * GELU_UNROLL
    blocks = min(-(-vecs // step), sms * GELU_BLOCKS_PER_SM)
    if vecs + blocks * step > MAX_INDEX:
        raise ValueError(f"bias_gelu kernel indexes its vectors in 32-bit ints: {vecs} vectors "
                         f"need more")
    return GeluPlan(VEC, GELU_THREADS, blocks, GELU_UNROLL, GELU_WIN_LO, GELU_WIN_LEN)


def gelu_window_misses(x: torch.Tensor) -> int:
    """How many of the bf16 values ``x`` (the GELU's input, ``bf16(h +
    b)``) lie outside ``bias_gelu.cu``'s window, so that the kernel reads
    their result from the device table."""
    mag = x.contiguous().view(torch.int16).int() & 0x7FFF
    return int(((mag < GELU_WIN_LO) | (mag >= GELU_WIN_LO + GELU_WIN_LEN)).sum())


def plan_qkv_heads(b: int, t: int, h: int, hd: int) -> VecPlan:
    """``qkv_heads.cu``'s launch over ``b * t`` rows of ``h`` heads of
    ``hd``: a thread a vector of 8 lanes of each of q, k and v at one
    column, as many blocks of ``VEC_THREADS`` as the columns need."""
    if min(b, t, h) < 1 or hd < VEC or hd % VEC:
        raise ValueError(f"qkv_heads kernel takes a head dim that is a multiple of {VEC}, got "
                         f"{hd}")
    return _vec_plan(b * t * (h * hd // VEC), "qkv_heads")


# (d, heads, d_ff) of the configurations that run the kernels: Contriever's,
# whose shapes chip_smoke.py phase 7a holds to the plain versions on the card
KERNEL_WIDTHS = ((LN_WIDTH, 12, 3072),)


def kernels_take(d: int, n_heads: int, d_ff: int) -> bool:
    """Whether a config of width ``d``, ``n_heads`` heads and ``d_ff`` runs
    the encoder's kernels: one of ``KERNEL_WIDTHS``, whose head dim is
    ``prefill_attention``'s. Contriever (768, 12 x 64, 3072) does; the tiny
    test config (32, 2 x 16) does not, and runs the plain versions."""
    return ((d, n_heads, d_ff) in KERNEL_WIDTHS and d % n_heads == 0
            and d // n_heads in PREFILL_HEAD_DIMS)


# the last launches' plans (chip_smoke.py prints them)
last_plan = {"layer_norm": None, "bias_gelu": None, "qkv_heads": None}
# bias_gelu.cu's tables, one a device, built at first use (gelu_table)
GELU_TABLES: dict = {}


# ------------------------------------------------------------------- checks


def _check_ln(resid, delta, bias, w, b, dt, weights) -> Tuple[int, int]:
    """Delta and bias in ``dt``, w and b of one type in ``weights``.
    Returns (rows, width)."""
    if resid.dtype != torch.float32:
        raise TypeError(f"add_layer_norm takes the f32 residual stream, got {resid.dtype}")
    if dt not in _FLOATS:
        raise TypeError(f"add_layer_norm computes in bf16 or f32, got {dt}")
    d = resid.shape[-1]
    if w.dtype not in weights or b.dtype != w.dtype or w.shape != (d,) or b.shape != (d,):
        raise ValueError(f"w and b must be [{d}] of one type in {weights}, got {w.dtype} "
                         f"{tuple(w.shape)}, {b.dtype} {tuple(b.shape)}")
    if (delta is None) != (bias is None):
        raise ValueError("add_layer_norm takes a delta with its bias, or neither")
    if delta is not None:
        if delta.shape != resid.shape or delta.dtype != dt:
            raise ValueError(f"delta must be {dt} of the residual's shape {tuple(resid.shape)}, "
                             f"got {delta.dtype} {tuple(delta.shape)}")
        if bias.shape != (d,) or bias.dtype != dt:
            raise ValueError(f"bias must be {dt} [{d}], got {bias.dtype} {tuple(bias.shape)}")
    _contiguous("add_layer_norm", resid, delta, bias, w, b)
    return resid.numel() // max(d, 1), d


def _check_gelu(h, bias, dts) -> Tuple[int, int]:
    """h and bias of one type in ``dts``. Returns (rows, width)."""
    f = h.shape[-1]
    if h.dtype not in dts or bias.dtype != h.dtype or bias.shape != (f,):
        raise TypeError(f"bias_gelu takes h [.., F] and bias [F] of one type in {dts}, got "
                        f"{h.dtype} {tuple(h.shape)}, {bias.dtype} {tuple(bias.shape)}")
    _contiguous("bias_gelu", h, bias)
    return h.numel() // max(f, 1), f


def _check_qkv(y, bq, bk, bv, n_heads, dts) -> Tuple[int, int, int, int]:
    """y and the biases of one type in ``dts``. Returns (b, t, d, hd)."""
    if y.dim() != 3 or y.shape[-1] % (3 * n_heads):
        raise ValueError(f"y must be [B, T, 3 D] with D a multiple of {n_heads} heads, got "
                         f"{tuple(y.shape)}")
    b, t, d3 = y.shape
    d = d3 // 3
    for name, x in (("bq", bq), ("bk", bk), ("bv", bv)):
        if x.shape != (d,) or x.dtype != y.dtype:
            raise ValueError(f"{name} must be [{d}] in y's {y.dtype}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if y.dtype not in dts:
        raise TypeError(f"qkv_heads takes the product in {dts}, got {y.dtype}")
    _contiguous("qkv_heads", y, bq, bk, bv)
    return b, t, d, d // n_heads


def _contiguous(what: str, *tensors) -> None:
    if not all(x is None or x.is_contiguous() for x in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


# ----------------------------------------------------------------- wrappers


def add_layer_norm(resid: torch.Tensor, delta: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, xin)``: ``out = LN(resid + f32(bf16(delta + bias)))`` in f32
    (``resid`` alone without a delta: the embedding sum) and ``xin = bf16(
    out)``, for the f32 residual stream ``resid`` [.., D], ``delta`` [.., D]
    bf16 (the attention's or the MLP's output product), its ``bias`` [D]
    bf16, and the norm's ``w``, ``b`` [D] f32 (``models/encoder.py::
    prepare_params`` keeps them so), D ``LN_WIDTH``. The adds equal
    the plain ones; the mean and variance are the kernel's own f32 sums, so
    ``out`` lies within :func:`layer_norm_tolerance` of the plain version.
    On the card the kernel writes ``out`` IN PLACE into ``resid``'s buffer
    and returns it (the encoder's residual: the old one is not read again);
    the plain version returns a new tensor. CPU tensors take
    :func:`add_layer_norm_plain`."""
    rows, d = _check_ln(resid, delta, bias, w, b, torch.bfloat16, (torch.float32,))
    if not _on_cuda("add_layer_norm", resid, delta, bias, w, b):
        return add_layer_norm_plain(resid, delta, bias, w, b, eps)
    _aligned("add_layer_norm", resid, delta, bias, w, b)
    plan = last_plan["layer_norm"] = plan_layer_norm(rows, d)
    xin = torch.empty(resid.shape, dtype=torch.bfloat16, device=resid.device)
    lib = kernels.library()
    with torch.cuda.device(resid.device):
        kernels.check(
            lib.layer_norm(
                resid.data_ptr(), 0 if delta is None else delta.data_ptr(),
                0 if bias is None else bias.data_ptr(), w.data_ptr(), b.data_ptr(),
                resid.data_ptr(), xin.data_ptr(), rows, d,
                float(np.float32(eps)), plan.per, plan.warps, plan.blocks,
                kernels.stream_ptr(resid.device),
            ),
            "layer_norm",
        )
    kernels.LAUNCHES["layer_norm"] += 1
    return resid, xin


def gelu_table(device: torch.device) -> torch.Tensor:
    """``bias_gelu.cu``'s table on the CUDA ``device``: [65,536] bf16, entry
    i the exact GELU (the plain version's arithmetic, on the card's
    libdevice) of the bf16 value whose bits are i, rounded to bf16. Built
    by the kernel ``gelu_table_build`` in one launch (counted as
    ``gelu_table``) at first use on the device, then kept in
    ``GELU_TABLES``; a failed build raises."""
    key = torch.device(device.type, device.index if device.index is not None
                       else torch.cuda.current_device())
    table = GELU_TABLES.get(key)
    if table is None:
        table = torch.empty(GELU_TABLE, dtype=torch.bfloat16, device=key)
        with torch.cuda.device(key):
            kernels.check(kernels.library().gelu_table(table.data_ptr(),
                                                       kernels.stream_ptr(key)), "gelu_table")
        kernels.LAUNCHES["gelu_table"] += 1
        GELU_TABLES[key] = table
    return table


def bias_gelu(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(bf16(h + bias))`` for the first MLP product ``h`` [.., F] and
    its ``bias`` [F], bf16: exact GELU in JAX's form ``0.5 x erfc(-x
    sqrt(1/2))`` in f32, rounded to bf16, expected bit-equal to the plain
    version on the card (within :func:`gelu_tolerance` where a libm
    differs): the kernel forms ``bf16(h + bias)`` and reads its result
    from :func:`gelu_table`. On the card the kernel writes the result IN
    PLACE into ``h``'s buffer (the product's output, a temporary) and
    returns it; the plain version returns a new tensor. CPU tensors take
    :func:`bias_gelu_plain`."""
    rows, f = _check_gelu(h, bias, _BF16)
    if not _on_cuda("bias_gelu", h, bias):
        return bias_gelu_plain(h, bias)
    _aligned("bias_gelu", h, bias)
    table = gelu_table(h.device)
    plan = last_plan["bias_gelu"] = plan_bias_gelu(rows, f, kernels.sm_count(h.device))
    lib = kernels.library()
    with torch.cuda.device(h.device):
        kernels.check(
            lib.bias_gelu(h.data_ptr(), bias.data_ptr(), table.data_ptr(), rows, f, *plan,
                          kernels.stream_ptr(h.device)),
            "bias_gelu",
        )
    kernels.LAUNCHES["bias_gelu"] += 1
    return h


def qkv_heads(y: torch.Tensor, bq: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor,
              n_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, k, v)`` from ``y`` [B, T, 3 D] bf16, the product of the
    encoder's input with the concatenated ``wq | wk | wv`` [D, 3 D], and
    the three biases [D] bf16: q ``[B, T, H, hd]``, k and v ``[B, H, T,
    hd]`` contiguous (the slot rows ``prefill_attention`` reads), each
    ``bf16(y third + bias)``, bit-equal to the plain version. CPU tensors
    take :func:`qkv_heads_plain`."""
    b, t, d, hd = _check_qkv(y, bq, bk, bv, n_heads, _BF16)
    if not _on_cuda("qkv_heads", y, bq, bk, bv):
        return qkv_heads_plain(y, bq, bk, bv, n_heads)
    _aligned("qkv_heads", y, bq, bk, bv)
    plan = last_plan["qkv_heads"] = plan_qkv_heads(b, t, n_heads, hd)
    q = torch.empty((b, t, n_heads, hd), dtype=y.dtype, device=y.device)
    k = torch.empty((b, n_heads, t, hd), dtype=y.dtype, device=y.device)
    v = torch.empty_like(k)
    lib = kernels.library()
    with torch.cuda.device(y.device):
        kernels.check(
            lib.qkv_heads(y.data_ptr(), bq.data_ptr(), bk.data_ptr(), bv.data_ptr(),
                          q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t, n_heads, hd,
                          plan.vec, plan.threads, plan.blocks, kernels.stream_ptr(y.device)),
            "qkv_heads",
        )
    kernels.LAUNCHES["qkv_heads"] += 1
    return q, k, v
