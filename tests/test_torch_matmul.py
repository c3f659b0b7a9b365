"""The w8a16 product (probing_rag_tpu_torch.ops.matmul) against the JAX
package's ``ops/pallas_matmul.py::matmul_int8`` in interpret mode and
against ``models/gemma.py::_mm``'s XLA form, on the CPU, where the wrapper
takes its plain version.

Inputs are drawn with numpy from a seed. Tolerances: f32 rtol/atol 1e-5
(the same f32 sums in another order); bf16 rtol/atol 0.05, the bound of
``tests/test_pallas_matmul.py`` (one bf16 rounding of the product and one
of the scaled result, each up to 2^-8 relative).

The planner (``plan_matmul``), which picks the kernel's regime, tiles and
K splits from the shapes, is checked here too: its regime at every
Gemma-2B product, tiles that cover the output once, non-empty splits, and
the split-order sum of the partials."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models.gemma import _mm as jax_mm
from probing_rag_tpu.ops.pallas_matmul import matmul_int8 as jax_matmul_int8
from probing_rag_tpu_torch.ops.matmul import (
    MAX_SPLITS, WGMMA_MIN_M, matmul_int8, matmul_int8_plain, plan_matmul,
)

torch.set_num_threads(1)

CASES = [(8, 128, 256), (100, 256, 300), (1, 128, 640)]
BF16_TOL = dict(rtol=0.05, atol=0.05)


def operands(m, k, n, transpose_rhs):
    rng = np.random.default_rng(m * 7 + n + transpose_rhs)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (n, k) if transpose_rhs else (k, n)).astype(np.int8)
    s = ((rng.random((1, n)) + 0.5) / 100).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("m,k,n", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(m, k, n, transpose_rhs, dt):
    x, q, s = operands(m, k, n, transpose_rhs)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_matmul_int8(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s), dt=jdt,
                                      interpret=True, transpose_rhs=transpose_rhs), np.float32)
    got = matmul_int8_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                            dt=tdt, transpose_rhs=transpose_rhs)
    assert got.dtype == tdt and got.shape == (m, n)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the wrapper takes the plain version for CPU tensors
    wrapped = matmul_int8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), dt=tdt,
                          transpose_rhs=transpose_rhs)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("m,k,n", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_jax_mm(m, k, n, dt):
    """gemma._mm's int8 branch, ``(x @ q.astype(dt)) * s.astype(dt)`` in
    XLA, and the tied head's transposed form of it."""
    x, q, s = operands(m, k, n, False)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_mm(jnp.asarray(x, jdt), {"q": jnp.asarray(q), "s": jnp.asarray(s)}, jdt),
                      np.float32)
    got = matmul_int8_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), dt=tdt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    qt = np.ascontiguousarray(q.T)  # [N, K] with the [N, 1] scale of the tied head
    head = (jnp.asarray(x, jdt) @ jnp.asarray(qt).astype(jdt).T) * jnp.asarray(s.T).astype(jdt).T
    got_t = matmul_int8_plain(torch.from_numpy(x), torch.from_numpy(qt),
                              torch.from_numpy(np.ascontiguousarray(s.T)), dt=tdt,
                              transpose_rhs=True)
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(head, np.float32), **tol)


def test_bf16_rounds_before_scaling():
    """The product is rounded to bf16 before the scale multiplies it in
    bf16 (scaling in f32 first would differ by a bf16 ulp)."""
    x = torch.tensor([[1.0, 1.0]], dtype=torch.bfloat16)
    q = torch.tensor([[1], [2]], dtype=torch.int8)  # x @ q = 3
    s = torch.tensor([[1.0 / 3.0]])
    got = matmul_int8_plain(x, q, s, dt=torch.bfloat16)
    want = torch.tensor(3.0, dtype=torch.bfloat16) * s.to(torch.bfloat16)
    assert torch.equal(got, want.reshape(1, 1))


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((4, 32))
    q = torch.zeros((32, 16), dtype=torch.int8)
    s = torch.ones((1, 16))
    with pytest.raises(TypeError):
        matmul_int8(x, q.float(), s, dt=torch.float32)
    with pytest.raises(ValueError):
        matmul_int8(x, q, s, dt=torch.float32, transpose_rhs=True)  # K disagrees
    with pytest.raises(ValueError):
        matmul_int8(x, q, torch.ones((1, 8)), dt=torch.float32)
    with pytest.raises(TypeError):
        matmul_int8(x, q, s, dt=torch.float16)


# Gemma-2B's products as (K, N): the decode step's M is the batch, 8; the
# prefill's 8 x the padded prompt length (3712 in the probing loop)
GEMMA_2B = {"wq/wo": (2048, 2048), "wk/wv": (2048, 256), "w_gate/w_up": (2048, 16384),
            "w_down": (16384, 2048)}
TIED_HEAD = (2048, 256_000)
DECODE_M, PREFILL_M = 8, 8 * 3712
# (tile width, K splits) of each decode product on 132 SMs
DECODE_PLAN = {"wq/wo": (64, 7), "wk/wv": (64, 16), "w_gate/w_up": (64, 1), "w_down": (64, 16)}


@pytest.mark.parametrize("name", list(GEMMA_2B))
def test_plan_gemma_2b(name):
    k, n = GEMMA_2B[name]
    dec = plan_matmul(DECODE_M, n, k)
    assert (dec.regime, dec.bm, dec.bn, dec.splits) == ("small_m", 16, *DECODE_PLAN[name])
    pre = plan_matmul(PREFILL_M, n, k)
    assert (pre.regime, pre.bm, pre.bn, pre.splits, pre.grid) == ("wgmma", 128, 256, 1, 132)
    # the tied head reads the [V, D] embedding transposed
    head = plan_matmul(DECODE_M, TIED_HEAD[1], TIED_HEAD[0], transpose_rhs=True)
    assert (head.regime, head.bn, head.splits, head.grid) == ("small_m", 128, 1, 2000)
    assert plan_matmul(PREFILL_M, n, k, transpose_rhs=True).regime == "wgmma"


@pytest.mark.parametrize("m,k,n,transpose_rhs,x_ptr,q_ptr,regime", [
    (37, 2048, 1000, False, 0, 0, "tail"),      # N % 16 with [K, N]
    (37, 2048, 1000, True, 0, 0, "small_m"),    # [N, K] takes any N
    (5, 200, 300, False, 0, 0, "tail"),         # K % 16
    (5, 200, 300, True, 0, 0, "tail"),
    (29701, 2048, 16384, False, 0, 0, "wgmma"),  # M not a multiple of 128
    (29696, 2048, 1000, True, 0, 0, "wgmma"),
    (29696, 2048, 1000, False, 0, 0, "tail"),   # a [K, N] row pitch TMA cannot take
    (29696, 200, 2048, False, 0, 0, "wgmma"),   # K % 8 suffices for [K, N]
    (29696, 200, 2048, True, 0, 0, "tail"),     # [N, K] needs K % 16
    (29696, 2048, 2048, False, 8, 0, "tail"),   # unaligned bases
    (29696, 2048, 2048, True, 0, 4, "tail"),
    (8, 2048, 2048, False, 2, 0, "tail"),
    (WGMMA_MIN_M, 2048, 2048, False, 0, 0, "small_m"),
    (WGMMA_MIN_M, 2048, 16384, False, 0, 0, "small_m"),
    (WGMMA_MIN_M + 1, 2048, 16384, False, 0, 0, "wgmma"),     # 64 tiles
    (WGMMA_MIN_M + 1, 2048, 2048, False, 0, 0, "small_m"),    # 8 tiles: K splits
    (512, 16384, 2048, False, 0, 0, "wgmma"),                 # WGMMA_MIN_TILES
    (384, 16384, 2048, False, 0, 0, "small_m"),
    (384, 16384, 1000, False, 0, 0, "tail"),
])
def test_plan_regime(m, k, n, transpose_rhs, x_ptr, q_ptr, regime):
    plan = plan_matmul(m, n, k, transpose_rhs=transpose_rhs, x_ptr=x_ptr, q_ptr=q_ptr)
    assert plan.regime == regime
    assert plan_matmul(m, n, k, dt=torch.float32).regime == "f32"


def plan_blocks(plan):
    """Every block's work as the kernels index it, from the plan's fields:
    ``(block, row0, col0, k0, k1)`` for each output tile it computes over
    depth ``[k0, k1)``. A wgmma block walks tiles ``block, block + grid,
    ...`` (N fastest); the other regimes' block ``(x, y, z)`` is tile
    ``(y, x)``, split ``z``."""
    tiles_m, tiles_n = math.ceil(plan.m / plan.bm), math.ceil(plan.n / plan.bn)
    if plan.regime == "wgmma":
        for b in range(plan.grid):
            for t in range(b, tiles_m * tiles_n, plan.grid):
                yield b, (t // tiles_n) * plan.bm, (t % tiles_n) * plan.bn, 0, plan.k
        return
    depth = math.ceil(math.ceil(plan.k / plan.bk) / plan.splits) * plan.bk
    for z in range(plan.splits):
        for y in range(tiles_m):
            for x in range(tiles_n):
                b = (z * tiles_m + y) * tiles_n + x
                yield b, y * plan.bm, x * plan.bn, z * depth, min(plan.k, (z + 1) * depth)


COVER_CASES = [(DECODE_M, *GEMMA_2B["w_down"]), (DECODE_M, *GEMMA_2B["w_gate/w_up"]),
               (PREFILL_M, *GEMMA_2B["wk/wv"]), (29701, 2048, 16384), (37, 2048, 1000),
               (5, 200, 300), (1000, 64, 100), (3, 16, 16)]


@pytest.mark.parametrize("m,k,n", COVER_CASES)
@pytest.mark.parametrize("sm_count", [132, 7])
def test_plan_tiles_cover_the_output_once(m, k, n, sm_count):
    plan = plan_matmul(m, n, k, sm_count=sm_count)
    depth = {}
    blocks = set()
    for block, row0, col0, k0, k1 in plan_blocks(plan):
        assert 0 <= row0 < m and 0 <= col0 < n and 0 <= k0 < k1 <= k, "an empty split"
        assert row0 % plan.bm == 0 and col0 % plan.bn == 0 and k0 % plan.bk == 0
        depth.setdefault((row0, col0), []).append((k0, k1))
        blocks.add(block)
    assert blocks == set(range(plan.grid))
    assert sorted(depth) == [(r, c) for r in range(0, m, plan.bm) for c in range(0, n, plan.bn)]
    for ranges in depth.values():  # each tile's depth split into contiguous pieces once
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) == plan.splits
    assert plan.splits <= MAX_SPLITS  # a tile's splits are one cluster


@pytest.mark.parametrize("name", ["wk/wv", "w_down", "wq/wo"])
def test_split_order_sum_is_a_serial_sum(name):
    """The kernel sums a tile's f32 partials (one per split of the
    cluster) in split order from 0: emulated over whole tiles with numpy
    f32 arithmetic, it equals the per-element serial loop bit for bit (and
    so the same on every run), where another order differs."""
    k, n = GEMMA_2B[name]
    plan = plan_matmul(DECODE_M, n, k)  # the decode product's depth split
    n = 256  # over a few of its output tiles
    rng = np.random.default_rng(3)
    x = rng.normal(size=(DECODE_M, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.float32)
    ranges = sorted({(k0, k1) for _, _, _, k0, k1 in plan_blocks(plan)})
    assert len(ranges) == plan.splits > 2  # two summands commute
    # splits of very different magnitudes, so that the order of the sum shows
    scale = 10.0 ** rng.uniform(-4, 4, (len(ranges), 1, 1))
    parts = (np.stack([x[:, a:b] @ w[a:b] for a, b in ranges]) * scale).astype(np.float32)
    tiled = np.zeros((DECODE_M, n), np.float32)
    for p in parts:
        tiled = tiled + p
    serial = np.empty_like(tiled)
    for i in range(DECODE_M):
        for j in range(n):
            v = np.float32(0.0)
            for z in range(plan.splits):
                v = np.float32(v + parts[z, i, j])
            serial[i, j] = v
    assert tiled.tobytes() == serial.tobytes()
    backwards = np.zeros_like(tiled)
    for p in parts[::-1]:
        backwards = backwards + p
    assert backwards.tobytes() != tiled.tobytes()
