"""The launch plans of the block's kernels, carried out on the CPU.

``ops/block.py::plan_norm``, ``plan_rope`` and ``plan_act`` give
``rms_norm.cu``, ``rope_kv.cu`` and ``gated_act.cu`` their geometry; the
kernels run only on the card
(``chip_smoke.py`` phase 9a holds them bit-equal to their plain versions
there). Here each plan is carried out in numpy with the kernels' rules:

- ``plan_norm``: every row is one group's, and every vector (or element)
  of a row one thread's, exactly once, at 8, 40, 12,288 and 29,696 rows of
  D 64, 2048 and 4096; and the row's sum of squares taken in the plan's
  order (a thread's chunks, four partial sums, the shared-memory halving,
  the last halving step in every warp, ``shfl_down``) equals, bit for bit,
  an independent emulation of torch's CUDA reduction written from
  ``ATen/native/cuda/Reduce.cuh`` (``setReduceConfig``'s block width, the
  vectorized and the plain thread reduce, ``block_x_reduce``), which is
  what makes the kernel's ``normed`` equal to the plain ``torch.mean``. A
  width of 32 where torch takes 64 changes the sums: the check can fail.
- ``plan_rope``: every (token, row, vector) once, at the decode step's,
  the verify round's and the prefill's tokens of Gemma-2B, Mistral-7B and
  the tiny configs, bf16 and f32, into a cache of the compute type or a
  quantized one; and the lanes' quantizer maxima (the
  row's for int8, each group's for int4: over a group's lanes inside a
  half, or over the row where groups cross the halves) with the scales
  each lane writes give the bytes and scales of ``quant_kv`` /
  ``quant_kv4`` + ``pack_int4`` exactly, each scale written once.
- ``plan_act``: the kernel's one pass (a vector a thread, the last one
  ragged where n is not a multiple of it) carried out at Gemma-2B's
  decode, verify, prefill and capture rows, Mistral-7B's, the tiny
  configs' and ragged n, bf16 and f32: each element loaded once and
  stored once, by the thread that loaded it, the loads and the stores
  modelled apart from the kernel's own index expressions (in place is
  safe), no idle block; the plan's end where 32-bit thread indices end;
  and the C entry's check itself (``gated_act.cu``'s host-only ``namespace
  gact``, compiled with g++) takes the planner's plan at every case and
  refuses any other.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.ops import block as bk

NORM_ROWS = (8, 40, 12_288, 29_696)
NORM_WIDTHS = (64, 2048, 4096)
SAMPLE_ROWS = 24  # rows of data a sum case takes (the layout is every row's)
F32 = np.float32


# ------------------------------------------------------------------ the norm


def torch_reduce_config(d: int, rows: int):
    """``setReduceConfig`` for torch.mean over the contiguous last dim of
    an f32 [rows, d]: (vectorized, block_width, split across warps)."""
    vectorized = d >= 128  # "vectorize along input", 4 floats a load
    dim0, dim1 = (d // 4 if vectorized else d), rows
    max_threads = 512

    def last_pow2(n):
        return 1 << (int(n).bit_length() - 1)

    dim0_pow2 = last_pow2(dim0) if dim0 < max_threads else max_threads
    dim1_pow2 = last_pow2(dim1) if dim1 < max_threads else max_threads
    block_width = min(dim0_pow2, 32)
    block_height = min(dim1_pow2, max_threads // block_width)
    block_width = min(dim0_pow2, max_threads // block_height)
    step_input = block_width  # split_input(block_width)
    values_per_thread = -(-d // step_input)
    split = values_per_thread >= min(block_height * 16, 256)
    return vectorized, block_width, split


def torch_row_sums(sq: np.ndarray, rows: int) -> np.ndarray:
    """Each row's sum of the f32 squares ``sq`` [n, d] as torch's CUDA
    reduction takes it for a tensor of ``rows`` rows."""
    n, d = sq.shape
    vectorized, bw, split = torch_reduce_config(d, rows)
    assert not split, "the emulation covers one warp group a row"
    lanes = np.arange(bw)
    if vectorized:  # input_vectorized_thread_reduce_impl: value_list[i] per element of a vector
        vals = sq.reshape(n, d // 4, 4)
        value_list = np.zeros((n, bw, 4), F32)
        idx = lanes.copy()
        while True:
            live = idx * 4 + 3 < d
            if not live.any():
                break
            value_list[:, live] = value_list[:, live] + vals[:, idx[live]]
            idx = idx + bw
        acc = value_list[..., 0]
        for i in range(1, 4):
            acc = acc + value_list[..., i]
    else:  # thread_reduce_impl, vt0 = 4: element idx + i * stride into value_list[i]
        value_list = np.zeros((4, n, bw), F32)
        idx = lanes.copy()
        while True:
            full = idx + 3 * bw < d
            if not full.any():
                break
            for i in range(4):
                value_list[i][:, full] = value_list[i][:, full] + sq[:, idx[full] + i * bw]
            idx = np.where(full, idx + 4 * bw, idx)
        for i in range(4):  # the tail
            live = idx < d
            value_list[i][:, live] = value_list[i][:, live] + sq[:, idx[live]]
            idx = idx + bw
        acc = value_list[0]
        for i in range(1, 4):
            acc = acc + value_list[i]
    # block_x_reduce: halving in shared memory down to a warp, then shfl_down
    shared = acc.copy()
    offset = bw // 2
    while offset >= 32:
        shared[:, :offset] = shared[:, :offset] + shared[:, offset:2 * offset]
        offset //= 2
    warp = shared[:, :min(bw, 32)].copy()
    offset = warp.shape[1] // 2
    while offset > 0:
        warp[:, :offset] = warp[:, :offset] + warp[:, offset:2 * offset]
        offset //= 2
    return warp[:, 0]


def plan_row_sums(plan: bk.NormPlan, sq: np.ndarray, width: int = None) -> np.ndarray:
    """Each row's sum as ``rms_norm.cu`` takes it under ``plan`` (or a
    forced ``width``): thread t's vectors t + width k a chunk at a time,
    four partial sums added in order, the halving while more than 64
    threads hold sums, the last step, shfl_down at 16 .. 1."""
    n, d = sq.shape
    width = width or plan.width
    vectorized = d >= 128
    units = d // 4 if vectorized else d
    per = -(-units // width)
    chunk = plan.chunk
    acc = np.zeros((4, n, width), F32)
    vals = sq.reshape(n, units, 4) if vectorized else sq
    for c in range(-(-per // chunk)):
        for k in range(chunk):
            v = np.arange(width) + width * (c * chunk + k)
            live = v < units
            if vectorized:
                for j in range(4):
                    acc[j][:, live] = acc[j][:, live] + vals[:, v[live], j]
            else:
                j = (c * chunk + k) & 3
                acc[j][:, live] = acc[j][:, live] + vals[:, v[live]]
    s = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    if width > 32:
        off = width // 2
        while off > 32:
            s[:, :off] = s[:, :off] + s[:, off:2 * off]
            off //= 2
        s = s[:, :32] + s[:, 32:64]  # every warp of the row alike
    off = 16
    while off > 0:
        s[:, :off] = s[:, :off] + s[:, off:2 * off]
        off //= 2
    return s[:, 0]


@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_norm_plan_covers_every_row_once(rows, d):
    plan = bk.plan_norm(rows, d)
    _, bw, _ = torch_reduce_config(d, rows)
    assert plan.width == max(bw, 32)
    assert plan.regime == ("latency" if rows < bk.NORM_STREAM_ROWS else "stream")
    cap = 256 if plan.chunk >= 8 else bk.NORM_MAX_THREADS
    assert plan.rows_block * plan.width <= cap
    assert plan.chunk in (bk.NORM_CHUNKS if d >= 128 else (4,))
    block, group = np.meshgrid(np.arange(plan.blocks), np.arange(plan.rows_block), indexing="ij")
    row = (block * plan.rows_block + group).ravel()
    covered = np.bincount(row[row < rows], minlength=rows)
    assert (covered == 1).all()
    assert (row >= rows).sum() < plan.rows_block  # only the last block has idle groups
    units = d // 4 if d >= 128 else d
    t = np.arange(plan.width)[:, None]
    k = np.arange(-(-plan.per // plan.chunk) * plan.chunk)[None, :]
    v = (t + plan.width * k).ravel()
    assert (np.bincount(v[v < units], minlength=units) == 1).all()
    assert plan.per == -(-units // plan.width)


@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_norm_plan_sums_in_torchs_order(rows, d):
    x = np.random.default_rng(rows + d).standard_normal((SAMPLE_ROWS, d), dtype=F32) * F32(3)
    sq = x * x
    got = plan_row_sums(bk.plan_norm(rows, d), sq)
    want = torch_row_sums(sq, rows)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_norm_sum_of_a_wrong_width_differs():
    """Gemma-2B's decode step: torch sums a row of 2048 over 64 threads;
    the plan's order over 32 gives other sums, which the check sees."""
    rows, d = 8, 2048
    plan = bk.plan_norm(rows, d)
    assert plan.width == 64
    x = np.random.default_rng(5).standard_normal((SAMPLE_ROWS, d), dtype=F32) * F32(3)
    sq = x * x
    want = torch_row_sums(sq, rows)
    np.testing.assert_array_equal(plan_row_sums(plan, sq), want)
    assert (plan_row_sums(plan, sq, width=32) != want).any()


# ------------------------------------------------------------------ the rope

ROPE_CASES = {  # (b, t, h, kvh, hd)
    "gemma_2b decode": (8, 1, 8, 1, 256),
    "gemma_2b verify": (8, 5, 8, 1, 256),
    "gemma_2b prefill": (8, 3712, 8, 1, 256),
    "mistral_7b decode": (8, 1, 32, 8, 128),
    "mistral_7b verify": (8, 5, 32, 8, 128),
    "mistral_7b prefill": (8, 1024, 32, 8, 128),
    "tiny prefill": (8, 64, 2, 1, 32),
    "tiny_mistral prefill": (8, 64, 4, 2, 16),
}
DTS = {"bf16": torch.bfloat16, "f32": torch.float32}


def lane_vectors(plan: bk.RopePlan, hd: int, dt: torch.dtype):
    """(elements a vector, vectors a half row)."""
    e = plan.vec_bytes // torch.empty((), dtype=dt).element_size()
    return e, hd // 2 // e


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dt", list(DTS))
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_plan_covers_every_row_once(case, dt, quantized):
    b, t, h, kvh, hd = ROPE_CASES[case]
    plan = bk.plan_rope(b, t, h, kvh, hd, DTS[dt], quantized)
    _, vecs = lane_vectors(plan, hd, DTS[dt])
    rows, tokens = h + 2 * kvh, b * t
    assert plan.lanes_row >= vecs and plan.lanes_row < 2 * vecs  # a power of two
    assert plan.lanes_row & (plan.lanes_row - 1) == 0
    assert 1 <= plan.steps_warp <= bk.ROPE_MAX_STEPS
    assert plan.tokens_block * plan.warps_token * 32 <= bk.ROPE_MAX_THREADS
    assert plan.regime == ("decode" if t <= 5 else "stream")
    assert plan.vec_bytes == 16 or (plan.regime == "decode" and quantized)
    if plan.regime == "decode":
        assert plan.tokens_block == 1
        assert plan.steps_warp == -(-plan.steps // (bk.ROPE_MAX_THREADS // 32))
    warps = plan.tokens_block * plan.warps_token
    blk, warp, lane, s = np.meshgrid(np.arange(plan.blocks), np.arange(warps), np.arange(32),
                                     np.arange(plan.steps_warp), indexing="ij")
    token = blk * plan.tokens_block + warp // plan.warps_token
    step = (warp % plan.warps_token) * plan.steps_warp + s
    row = step * plan.rows_step + lane // plan.lanes_row
    p = lane % plan.lanes_row
    live = (token < tokens) & (step < plan.steps) & (row < rows) & (p < vecs)
    key = (token[live] * rows + row[live]) * vecs + p[live]
    assert (np.bincount(key, minlength=tokens * rows * vecs) == 1).all()
    # no warp without a step of its token
    assert (plan.warps_token - 1) * plan.steps_warp < plan.steps


def carry_out_cache_row(plan: bk.RopePlan, x: torch.Tensor, kind: str, dt: torch.dtype) -> tuple:
    """The cache row and scales the lanes of ``plan`` write for one
    rotated, rounded key (or value) row ``x`` [hd] (f32 values of the
    compute type): lane p holds the vectors at p E and hd / 2 + p E."""
    hd = x.shape[0]
    half = hd // 2
    e, vecs = lane_vectors(plan, hd, dt)
    xs = x.numpy().astype(F32)
    lanes = np.arange(plan.lanes_row)
    o1, o2 = lanes * e, half + lanes * e
    ok = lanes < vecs

    def vec_max(o):
        return np.array([np.abs(xs[i:i + e]).max() if k else F32(0) for i, k in zip(o, ok)], F32)

    m1, m2 = vec_max(o1), vec_max(o2)
    if kind == "int8":
        m = np.full(plan.lanes_row, max(m1.max(), m2.max()), F32)  # lanes_max over the row
        sc = F32(m[0] / F32(127))
        sc = F32(1) if sc == 0 else sc
        out = np.zeros(hd, np.int8)
        for p in lanes[ok]:
            for o in (o1[p], o2[p]):
                out[o:o + e] = np.clip(np.rint(xs[o:o + e] / sc), -127, 127)
        return out, np.array([sc], F32)
    g = at.kv4_group(hd)
    groups = hd // g
    if half % g == 0:  # lanes_max over g / E neighbouring lanes of one half
        span = g // e
        r1 = np.array([m1[(p // span) * span:(p // span + 1) * span].max() for p in lanes], F32)
        r2 = np.array([m2[(p // span) * span:(p // span + 1) * span].max() for p in lanes], F32)
    else:  # each group's max over the row's lanes
        r1, r2 = np.zeros_like(m1), np.zeros_like(m2)
        for gi in range(groups):
            mg = np.maximum(np.where(o1 // g == gi, m1, 0), np.where(o2 // g == gi, m2, 0)).max()
            r1 = np.where(o1 // g == gi, mg, r1)
            r2 = np.where(o2 // g == gi, mg, r2)
    out = np.zeros(hd // 2, np.uint8)
    scales = np.full(groups, np.nan, F32)
    written = np.zeros(groups, int)
    for p in lanes[ok]:
        for o, m in ((o1[p], r1[p]), (o2[p], r2[p])):
            sc = F32(m / F32(7))
            sc = F32(1) if sc == 0 else sc
            q = (np.clip(np.rint(xs[o:o + e] / sc), -7, 7) + 8).astype(np.uint8)
            out[o // 2:(o + e) // 2] = q[0::2] | (q[1::2] << 4)
            if o % g == 0:
                scales[o // g] = sc
                written[o // g] += 1
    assert (written == 1).all(), "each group's scale is written by one lane"
    return out, scales


@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("dt", list(DTS))
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_rope_lanes_quantize_as_the_plain_cache_write(kind, hd, dt, t):
    """A key row rotated and rounded to the compute type, quantized by
    the plan's lanes, equals ``quant_kv`` / ``quant_kv4`` + ``pack_int4``
    byte for byte, with the same scales: hd 64, 128 and 256 take the
    groups inside a half, 16, 32 and 96 the groups across the halves; a
    decode step's plan (T 1) in 8-byte vectors, a prefill's in 16."""
    torch.manual_seed(hd)
    plan = bk.plan_rope(8, t, 2, 1, hd, DTS[dt], quantized=True)
    es = torch.empty((), dtype=DTS[dt]).element_size()
    assert plan.vec_bytes == (8 if t == 1 and hd // 2 * es // 8 <= 32 else 16)
    x = (3 * torch.randn(4, hd)).to(DTS[dt])
    x[1, : hd // 4] = 0  # a zero group (int4) or a small one
    x[2] = 0  # an all-zero row: scale 1
    for row in x:
        got, scales = carry_out_cache_row(plan, row.float(), kind, DTS[dt])
        if kind == "int8":
            q, s = at.quant_kv(row[None])
            np.testing.assert_array_equal(got, q[0].numpy())
        else:
            q, s = at.quant_kv4(row[None])
            np.testing.assert_array_equal(got, at.pack_int4(q)[0].numpy())
        np.testing.assert_array_equal(scales, s[0].numpy().reshape(-1))


# ------------------------------------------------------- the gated activation

ACT_CASES = {  # (rows, d_ff): n = rows x d_ff values
    "gemma_2b decode": (8, 16_384),
    "gemma_2b verify": (40, 16_384),
    "gemma_2b prefill": (8 * 3712, 16_384),
    "gemma_2b capture": (8 * 1536, 16_384),
    "mistral_7b decode": (8, 14_336),
    "mistral_7b verify": (40, 14_336),
    "mistral_7b prefill": (8 * 1024, 14_336),
    "tiny decode": (8, 128),
    "tiny prefill": (8 * 64, 128),
    "ragged one value": (1, 1),
    "ragged [3 x 7]": (3, 7),
    "ragged [515 x 125]": (515, 125),
    "ragged [257 x 16,383]": (257, 16_383),
    "ragged [29,697 x 16,383]": (8 * 3712 + 1, 16_383),
}
WHOLE_GRID = 1 << 21  # threads carried out one by one up to this; beyond, the edges
ACT_SHIM = """
extern "C" int act_plan(long long n, int es, int* out) {
  gact::Plan p;
  if (!gact::plan(n, es, &p)) return 0;
  out[0] = p.vec_bytes;
  out[1] = p.threads;
  out[2] = p.blocks;
  return 1;
}
extern "C" int act_accepts(long long n, int es, int vec_bytes, int threads, int blocks) {
  gact::Plan p;
  return gact::accepts(n, es, vec_bytes, threads, blocks, &p);
}
"""


class ActRule:
    """``gated_act.cu``'s ``namespace gact`` (the plan's rule and the C
    entry's check; host code only), compiled with g++ from the source the
    card builds."""

    def __init__(self, build_dir: Path):
        src = (Path(bk.__file__).resolve().parents[1] / "kernels" / "csrc"
               / "gated_act.cu").read_text()
        ns = src[src.index("namespace gact {"):src.index("}  // namespace gact")] + "}\n"
        cpp, so = build_dir / "gact.cpp", build_dir / "gact.so"
        cpp.write_text(ns + ACT_SHIM)
        subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", str(cpp), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        self.lib = ctypes.CDLL(str(so))
        self.lib.act_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
        self.lib.act_accepts.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4

    def plan(self, n: int, dt: torch.dtype):
        """``gact::plan``: (vec_bytes, threads, blocks), or None where the
        entry takes no plan."""
        out = (ctypes.c_int * 3)()
        ok = self.lib.act_plan(n, torch.empty((), dtype=dt).element_size(), out)
        return tuple(out) if ok else None

    def accepts(self, plan: bk.ActPlan, n: int, dt: torch.dtype) -> bool:
        """``gact::accepts``: the C entry launches this plan."""
        return bool(self.lib.act_accepts(n, torch.empty((), dtype=dt).element_size(), *plan))


@pytest.fixture(scope="module")
def act_rule(tmp_path_factory) -> ActRule:
    return ActRule(tmp_path_factory.mktemp("gact"))


def act_accesses(vec: np.ndarray, ragged: np.ndarray, per: int, tail: int, vec_index,
                 ragged_base: int) -> tuple:
    """(elements, threads) of one access of ``gated_act_pass``: threads
    ``vec`` each touch the ``per`` values of vector ``vec_index(i)``, and
    the ragged thread (if in ``ragged``) the ``tail`` values from
    ``ragged_base`` one at a time."""
    el = [(vec_index(vec)[:, None] * per + np.arange(per)).ravel()]
    by = [np.repeat(vec, per)]
    for r in ragged:
        el.append(ragged_base + np.arange(tail))
        by.append(np.full(tail, r))
    return np.concatenate(el), np.concatenate(by)


def carry_out_act(plan: bk.ActPlan, n: int, dt: torch.dtype, lo: int, hi: int) -> tuple:
    """Runs ``gated_act_pass`` for the grid's threads ``[lo, hi)`` with the
    kernel's index expressions, its loads' and its stores' written apart:
    thread i < full loads ``gate[i]`` and ``up[i]`` and stores ``out[i]``
    (16-, 8-byte vectors), and the thread at i == full loads ``gate + per *
    full + e`` and stores ``out + per * full + e`` for e < tail. Asserts
    that each element those threads store is stored once, by the thread
    that loaded it from gate and up, and that no element is loaded without
    being stored (so gate may be the output: no thread touches another's
    elements). Returns the element range they cover."""
    per = plan.vec_bytes // torch.empty((), dtype=dt).element_size()
    full, tail = divmod(n, per)
    t = np.arange(lo, hi, dtype=np.int64)
    vec, ragged = t[t < full], t[(t == full) & (tail > 0)]
    loads = {name: act_accesses(vec, ragged, per, tail, lambda i: i, per * full)
             for name in ("gate", "up")}
    stored, sby = act_accesses(vec, ragged, per, tail, lambda i: i, per * full)
    if not len(stored):
        assert not any(len(el) for el, _ in loads.values()), "an element loaded, none stored"
        return 0, 0
    sorder = np.argsort(stored, kind="stable")
    stored, sby = stored[sorder], sby[sorder]
    assert (np.diff(stored) == 1).all(), "an element stored twice or skipped"
    assert 0 <= stored[0] and stored[-1] < n, "a store outside the tensor"
    for name, (loaded, by) in loads.items():
        order = np.argsort(loaded, kind="stable")
        assert np.array_equal(loaded[order], stored), f"an element of {name} loaded, not stored"
        assert np.array_equal(by[order], sby), f"an element of {name} stored by another thread"
    return int(stored[0]), int(stored[-1]) + 1


@pytest.mark.parametrize("dt", list(DTS))
@pytest.mark.parametrize("case", list(ACT_CASES))
def test_act_plan_covers_every_element_once(case, dt):
    """One pass: a thread a vector over the grid, no idle block; every
    element loaded and stored once, by one thread (the whole grid carried
    out up to ``WHOLE_GRID`` threads; beyond it the first block and the
    last three, where the ragged vector and the idle threads are)."""
    rows, f = ACT_CASES[case]
    n = rows * f
    plan = bk.plan_act(n, DTS[dt])
    assert (plan.vec_bytes, plan.threads) == (bk.ACT_VEC_BYTES, bk.ACT_THREADS)
    vecs = -(-n // (plan.vec_bytes // torch.empty((), dtype=DTS[dt]).element_size()))
    grid = plan.blocks * plan.threads
    assert (plan.blocks - 1) * plan.threads < vecs <= grid
    assert grid <= bk.ACT_MAX_INDEX
    if grid <= WHOLE_GRID:
        assert carry_out_act(plan, n, DTS[dt], 0, grid) == (0, n)
    else:
        per = plan.vec_bytes // torch.empty((), dtype=DTS[dt]).element_size()
        assert carry_out_act(plan, n, DTS[dt], 0, plan.threads) == (0, plan.threads * per)
        last = grid - 3 * plan.threads
        assert carry_out_act(plan, n, DTS[dt], last, grid) == (last * per, n)


@pytest.mark.parametrize("dt", list(DTS))
def test_act_plan_spreads_a_decode_step(dt):
    """A decode step of Gemma-2B reaches every SM of the card (132) in
    blocks of ``ACT_THREADS``; a verify round and a prefill take the same
    geometry, more blocks."""
    d = DTS[dt]
    step = bk.plan_act(8 * 16_384, d)
    assert step.blocks >= 132
    assert bk.plan_act(40 * 16_384, d).blocks == 5 * step.blocks
    assert bk.plan_act(8 * 3712 * 16_384, d).blocks == 3712 * step.blocks


@pytest.mark.parametrize("dt", list(DTS))
@pytest.mark.parametrize("case", list(ACT_CASES))
def test_act_entry_takes_the_planners_plan(case, dt, act_rule):
    """The C rule plans what ``plan_act`` plans, and the entry's check
    launches it."""
    rows, f = ACT_CASES[case]
    n = rows * f
    plan = bk.plan_act(n, DTS[dt])
    assert act_rule.plan(n, DTS[dt]) == tuple(plan)
    assert act_rule.accepts(plan, n, DTS[dt])


MUTATIONS = {
    "blocks + 1": lambda p: p._replace(blocks=p.blocks + 1),
    "blocks - 1": lambda p: p._replace(blocks=p.blocks - 1),
    "threads x 2": lambda p: p._replace(threads=2 * p.threads),
    "threads / 2": lambda p: p._replace(threads=p.threads // 2),
    "16-byte vectors": lambda p: p._replace(vec_bytes=16),
    "4-byte vectors": lambda p: p._replace(vec_bytes=4),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
@pytest.mark.parametrize("dt", list(DTS))
@pytest.mark.parametrize("case", ["gemma_2b decode", "gemma_2b verify", "gemma_2b prefill",
                                  "mistral_7b prefill", "ragged [3 x 7]"])
def test_act_entry_refuses_another_plan(case, dt, mutation, act_rule):
    """The C entry's check refuses a plan with any field other than its
    rule's."""
    rows, f = ACT_CASES[case]
    n = rows * f
    plan = bk.plan_act(n, DTS[dt])
    assert not act_rule.accepts(MUTATIONS[mutation](plan), n, DTS[dt])


@pytest.mark.parametrize("dt", list(DTS))
def test_act_plan_ends_where_its_indices_do(dt, act_rule):
    """The largest n whose threads fit 32-bit indices takes a plan, in
    Python and in the C rule; one vector more is refused by both."""
    per = bk.ACT_VEC_BYTES // torch.empty((), dtype=DTS[dt]).element_size()
    last = (bk.ACT_MAX_INDEX // bk.ACT_THREADS) * bk.ACT_THREADS * per
    assert act_rule.accepts(bk.plan_act(last, DTS[dt]), last, DTS[dt])
    with pytest.raises(ValueError, match="32-bit"):
        bk.plan_act(last + 1, DTS[dt])
    assert act_rule.plan(last + 1, DTS[dt]) is None
    assert act_rule.plan(0, DTS[dt]) == tuple(bk.plan_act(0, DTS[dt]))
