"""The w4a16 product (probing_rag_tpu_torch.ops.matmul.matmul_int4) against
the JAX package's ``models/gemma.py::_mm`` on the CPU, where the wrapper
takes its plain version, and the CPU checks of ``matmul_int4.cu``'s
arithmetic and of its planner.

The leaves come from both packages' ``quantize_lm_params`` applied to one
numpy tree (inputs drawn with numpy from a seed), at tiny widths: K 64-256,
group 32-128, N 16-512. Tolerances: f32 rtol 1e-5 and atol 1e-5 of the
largest output (the same f32 sums in another order: their rounding scales
with the terms, not with an output that cancels); bf16 rtol 2^-6 and atol
2^-6 of the largest output (one bf16 rounding of the product and one of
the scaled result, each up to 2^-8 relative, where XLA and PyTorch round
alike); the grouped kernel's op order
within ``int4_grouped_tolerance`` (one bf16 step of each group partial,
scaled, and the final rounding).

The kernel cannot run here; what it computes can: its nibble widening
(the byte permutes and the bf16 fma, carried out on the bits) into the
small-M regime's mma fragments and into the wgmma regime's swizzled tile,
each weight held once at its value; the rank-1 fold of ``rs`` into x; and
the grouped order (16-deep products summed per group, rounded, scaled,
the warps of a block and the splits of the plan summed in order)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.ops.attention import pack_int4, unpack_int4
from probing_rag_tpu_torch.ops.matmul import (
    INT4_SCHEMES, MAX_SHARED, MAX_SPLITS, WGMMA_MIN_M, int4_grouped_tolerance, matmul_int4,
    matmul_int4_plain, plan_matmul_int4,
)

torch.set_num_threads(1)

FAMILIES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@functools.lru_cache(maxsize=None)
def leaves(k, n, group, scheme, seed=0):
    """One numpy [K, N] matrix quantized by both packages'
    ``quantize_lm_params`` (as every layer family of a one-layer tree, and
    its transpose as an int4 embedding): the port's layer leaf and int4
    embedding as torch tensors, JAX's with ``q`` unpacked to int8 as its
    forward unpacks them."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * rng.uniform(0.2, 2.0, size=(k // group, 1, 1))
         .repeat(group, 0).reshape(k, 1)).astype(np.float32)
    emb = np.ascontiguousarray(w.T)  # [V = N, D = K]
    kw = dict(bits=4, group_size=group, int4_scheme=scheme, embed_bits=4)
    ported = tg.quantize_lm_params(
        {"embed": torch.from_numpy(emb),
         "layers": {f: torch.from_numpy(w[None]) for f in FAMILIES}}, **kw)
    jax_tree = jg.quantize_lm_params({"embed": jnp.asarray(emb),
                                      "layers": {f: jnp.asarray(w[None]) for f in FAMILIES}}, **kw)
    leaf = {name: v[0] for name, v in ported["layers"]["w_gate"].items()}
    jleaf = {name: np.asarray(v)[0] for name, v in jax_tree["layers"]["w_gate"].items()}
    jleaf["q"] = np.asarray(jg._unpack_int4(jnp.asarray(jleaf.pop("qp")))).astype(np.int8)
    jemb = {"q": np.asarray(jg._unpack_int4(jax_tree["embed"]["qp"])).astype(np.int8),
            "s": np.asarray(jax_tree["embed"]["s"])}
    return leaf, jleaf, ported["embed"], jemb


def jax_leaf(jleaf):
    return {name: jnp.asarray(v.astype(np.int8) if name == "q" else v).astype(
        jnp.int4 if name == "q" else v.dtype) for name, v in jleaf.items()}


def activations(m, k, seed):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


def dtypes(dt):
    return (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)


def assert_close(got, want, dt):
    got = got.float().numpy()
    rtol = 1e-5 if dt == "f32" else 2**-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def scheme_kwargs(leaf, scheme):
    if scheme == "grouped":
        return dict(gs=leaf["gs"])
    return dict(rs=leaf["rs"], s=leaf["s"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("scheme", ["rank1", "grouped"])
@pytest.mark.parametrize("m", [1, 8, 40, 1024, 1025])
def test_mm_matches_jax_across_the_dequant_rows(m, scheme, dt):
    """The port's ``_mm`` against JAX's on the same leaves at decode,
    verify and both sides of ``_INT4_DEQUANT_ROWS``, and the plain version
    bit-equal to ``_mm`` wherever ``_mm`` takes ``matmul_int4`` (rank-1
    everywhere, grouped up to 1,024 rows)."""
    k, n, group = 256, 160, 64
    leaf, jleaf, _, _ = leaves(k, n, group, scheme)
    jdt, tdt = dtypes(dt)
    x = activations(m, k, seed=m)
    want = np.asarray(jg._mm(jnp.asarray(x, jdt), jax_leaf(jleaf), jdt), np.float32)
    xt = torch.from_numpy(x).to(tdt)
    got = tg._mm(xt, leaf, tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    assert_close(got, want, dt)
    if scheme == "rank1" or m <= tg._INT4_DEQUANT_ROWS:
        plain = matmul_int4_plain(xt, leaf["qp"], dt=tdt, scheme=scheme,
                                  **scheme_kwargs(leaf, scheme))
        assert torch.equal(plain, got)
        assert torch.equal(matmul_int4(xt, leaf, dt=tdt, scheme=scheme), plain)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("scheme", ["rank1", "grouped"])
@pytest.mark.parametrize("k,n,group", [(64, 16, 32), (128, 48, 128), (192, 512, 64),
                                       (96, 16, 96)])
def test_plain_matches_jax_at_other_widths(k, n, group, scheme, dt):
    """Other K, N and group sizes (N 48: a ragged 16-column multiple; a
    group of 96, which is no power of two), at 8 and 40 rows."""
    leaf, jleaf, _, _ = leaves(k, n, group, scheme, seed=k + n)
    jdt, tdt = dtypes(dt)
    for m in (8, 40):
        x = activations(m, k, seed=7 * m + k)
        want = np.asarray(jg._mm(jnp.asarray(x, jdt), jax_leaf(jleaf), jdt), np.float32)
        got = matmul_int4_plain(torch.from_numpy(x).to(tdt), leaf["qp"], dt=tdt, scheme=scheme,
                                **scheme_kwargs(leaf, scheme))
        assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_tied_head_of_an_int4_embedding_matches_jax(m, dt):
    """The channel scheme: the [V, D/2] embedding read along D, its per-row
    scale the per-logit column scale, against JAX's tied head on the
    unpacked embedding (``tests/test_torch_quant.py`` runs the forward
    with it)."""
    k, n = 128, 320
    _, _, emb, jemb = leaves(k, n, 64, "rank1", seed=3)
    jdt, tdt = dtypes(dt)
    x = activations(m, k, seed=11 + m)
    jx = jnp.asarray(x, jdt)
    want = np.asarray((jx @ jnp.asarray(jemb["q"]).astype(jdt).T)
                      * jnp.asarray(jemb["s"]).astype(jdt).T, np.float32)
    got = matmul_int4(torch.from_numpy(x).to(tdt), emb, dt=tdt, scheme="channel",
                      transpose_rhs=True)
    assert got.shape == (m, n)
    assert_close(got, want, dt)


# ------------------------------------------------------ the kernel's arithmetic


def bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16_f32(v):
    """f32 values rounded to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays (selector values 0-7)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def nib_pair(v):
    """nib_pair: the bf16 pair of (v's bits 0-3, bits 16-19) after the fma
    (x 1, - 136), as two f32 arrays (low, high)."""
    t = (v & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    lo, hi = bf16_bits_to_f32(t & 0xFFFF), bf16_bits_to_f32(t >> 16)
    # bf16 fma of small integers: exact in f32, so its bf16 rounding is too
    return f32_to_bf16_f32(lo * 1.0 - 136.0), f32_to_bf16_f32(hi * 1.0 - 136.0)


def out_col(nt, j, g, e):
    """matmul_int4.cu::out_col: the block column of element e of tile j in
    lane row g."""
    return 16 * j + g + (e >> 1) * 8 if nt else 2 * (4 * g + j) + (e >> 1)


def kslot(r):
    """matmul_int4.cu::kslot: the stage row of depth row r of a step."""
    return (r & ~7) | ((r & 6) >> 1) | ((r & 1) << 2)


def stage_nibbles(tile, nt):
    """The warp's nibble stage as the kernel's copies lay it out: ``[K,
    N/2]`` depth rows at ``kslot``; channel rows as they are, padded to 80
    bytes."""
    if nt:
        out = np.zeros((tile.shape[0], tile.shape[1] + 16), np.uint8)
        out[:, : tile.shape[1]] = tile
        return out
    out = np.zeros_like(tile)
    for r in range(tile.shape[0]):
        out[kslot(r)] = tile[r]
    return out


def a_fragments(stage, kk, lane, nt):
    """matmul_int4.cu::a_fragments for one lane over the warp's nibble stage
    (``stage_nibbles``), reading it where the kernel reads it: af[j][i], each
    the (low, high) f32 pair of register i of tile j."""
    g, t = lane >> 2, lane & 3
    af = []
    if not nt:
        word = lambda r: np.array([int.from_bytes(stage[r, 4 * g : 4 * g + 4].tobytes(),  # noqa: E731
                                                  "little")], np.uint32)
        w = [word(kk + t + d) for d in (0, 4, 8, 12)]
        h = [x >> np.uint32(4) for x in w]
        for j in range(4):
            sel = j | ((4 + j) << 8)
            af.append([nib_pair(byte_perm(w[0], w[1], sel)), nib_pair(byte_perm(h[0], h[1], sel)),
                       nib_pair(byte_perm(w[2], w[3], sel)), nib_pair(byte_perm(h[2], h[3], sel))])
        return af
    for j in range(4):
        r = 16 * j + g
        us = [stage[r, kk // 2 + t], stage[r + 8, kk // 2 + t], stage[r, kk // 2 + 4 + t],
              stage[r + 8, kk // 2 + 4 + t]]
        af.append([nib_pair(np.array([int(u) | (int(u) << 12)], np.uint32)) for u in us])
    return af


def sw128(r, c):
    return r * 128 + ((c ^ (r & 7)) << 4)


def widen_kn4(q4, bn):
    """matmul_int4.cu::wg::widen_kn4 over every thread of the 256 that widen:
    the [64, bn/2] nibble tile into the 128B-swizzled K-major bf16 tile,
    returned unswizzled as [bn, 64] f32."""
    bk, nb_count = 64, bn // 8
    words = q4.reshape(bk, bn // 8, 4).copy().view(np.uint32).reshape(bk, bn // 8)
    tile = np.full(bn * 64, np.nan, np.float32)  # bf16 slots of the swizzled tile
    for wt in range(256):
        rot = wt & 7
        for i in range(math.ceil(bk // 8 * nb_count / 256)):
            b = wt + i * 256
            if b >= bk // 8 * nb_count:
                break
            nb, kb = b % nb_count, b // nb_count
            u = [words[kb * 8 + kk, nb] for kk in range(8)]
            h = [x >> np.uint32(4) for x in u]
            for it in range(8):
                c = it ^ rot
                sel = (c >> 1) | ((4 + (c >> 1)) << 8)
                src = h if c & 1 else u
                vals = []
                for p in range(4):
                    lo, hi = nib_pair(byte_perm(np.array([src[2 * p]], np.uint32),
                                                np.array([src[2 * p + 1]], np.uint32), sel))
                    vals += [lo[0], hi[0]]
                at = sw128(nb * 8 + c, kb) // 2
                tile[at : at + 8] = vals
    out = np.empty((bn, 64), np.float32)
    for r in range(bn):
        for c in range(8):
            at = sw128(r, c) // 2
            out[r, c * 8 : c * 8 + 8] = tile[at : at + 8]
    return out


@pytest.mark.parametrize("nt", [False, True])
def test_small_m_fragments_hold_each_weight_once(nt):
    """The small-M regime's A fragments, built lane by lane from a warp's
    nibble tile as the kernel builds them and read back through mma's A
    layout (a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g, 2t + 8), a3 = (g + 8,
    2t + 8), each a pair along k), with the tiles' rows mapped to block
    columns by ``out_col``: every weight of the 16 depths x 64 columns
    appears once, at its value, for each 16-deep slice of a 128-deep step."""
    rng = np.random.default_rng(int(nt))
    q = rng.integers(-8, 8, size=(64, 128) if nt else (128, 64)).astype(np.int8)
    stage = stage_nibbles(pack_int4(torch.from_numpy(q)).numpy(), nt)  # channel [n, k/2]; [k, n/2]
    w = q.T if nt else q  # [k, n]
    for kk in range(0, 128, 16):
        got = np.full((16, 64), np.nan, np.float32)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j, regs in enumerate(a_fragments(stage, kk, lane, nt)):
                for i, (lo, hi) in enumerate(regs):
                    row = g + 8 * (i & 1)            # the tile row: a1, a3 are rows g + 8
                    k = 2 * t + 8 * (i >> 1)         # a2, a3 are depths + 8
                    col = out_col(nt, j, g, 2 * (i & 1))
                    assert row == g + 8 * (i & 1)
                    for d, v in ((0, lo[0]), (1, hi[0])):
                        assert np.isnan(got[k + d, col]), "a weight held twice"
                        got[k + d, col] = v
        np.testing.assert_array_equal(got, w[kk : kk + 16].astype(np.float32))


def test_stage_loads_are_conflict_free_and_x_fragments_hold_x():
    """The stage layouts' fragment loads: each load instruction of a warp
    (32 lanes) touches 32 different banks, or one word per bank (a
    broadcast); and the x fragments read through the XOR swizzle of the
    copies are mma's B pairs, x[g][kk + 2t, + 1] and x[g][kk + 2t + 8, + 9]."""
    def banks_ok(addrs):
        words = {}
        for a in addrs:
            words.setdefault((a // 4) % 32, set()).add(a // 4)
        return all(len(v) == 1 for v in words.values())

    for kk in range(0, 128, 16):
        for d in (0, 4, 8, 12):  # the four word loads of [K, N/2]: rows kk + t + d, byte 4 g
            assert banks_ok([(kk + (lane & 3) + d) * 32 + 4 * (lane >> 2) for lane in range(32)])
        for j in range(4):  # channel: bytes kk / 2 + t (+ 4) of rows 16 j + g (+ 8), 80-byte rows
            for dr, db in ((0, 0), (8, 0), (0, 4), (8, 4)):
                assert banks_ok([(16 * j + (lane >> 2) + dr) * 80 + kk // 2 + (lane & 3) + db
                                 for lane in range(32)])
        for h in (0, 1):  # x: chunk kk / 8 + h of row g, XOR-swizzled, word t
            assert banks_ok([(lane >> 2) * 256 + ((((kk >> 3) + h) ^ (lane >> 2)) << 4)
                             + 4 * (lane & 3) for lane in range(32)])
    x = np.arange(8 * 128, dtype=np.int64).reshape(8, 128)
    stage = np.zeros_like(x)
    for r in range(8):
        for c in range(16):
            stage[r, 8 * (c ^ r) : 8 * (c ^ r) + 8] = x[r, 8 * c : 8 * c + 8]
    for kk in range(0, 128, 16):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in (0, 1):
                at = 8 * (((kk >> 3) + h) ^ g) + 2 * t  # in bf16 elements of the row
                assert list(stage[g, at : at + 2]) == [x[g, kk + 2 * t + 8 * h],
                                                      x[g, kk + 2 * t + 8 * h + 1]]


def test_nibble_pair_widen_is_exact():
    """nib_pair (mask, or 0x4300, fma x 1 - 136) on every byte value gives
    the two signed values unpack_int4 gives."""
    q = np.arange(-8, 8, dtype=np.int8)
    grid = np.stack(np.meshgrid(q, q, indexing="ij"), -1).reshape(-1)  # all 256 pairs
    b = pack_int4(torch.from_numpy(grid)).numpy().astype(np.uint32)
    lo, hi = nib_pair(b | (b << np.uint32(12)))
    np.testing.assert_array_equal(np.stack([lo, hi], -1).reshape(-1), grid.astype(np.float32))


@pytest.mark.parametrize("bn", [128, 256])
def test_wgmma_widen_transposes_the_tile(bn):
    """The wgmma regime's widening of a [64, bn/2] nibble tile: each k row's
    columns land in the K-major tile's row n, depth k, every slot written."""
    rng = np.random.default_rng(bn)
    q = rng.integers(-8, 8, size=(64, bn)).astype(np.int8)
    qp = pack_int4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(widen_kn4(qp, bn), q.T.astype(np.float32))


def emulate_rank1(x, qp, rs, s, group):
    """The small-M and wgmma kernels' rank-1 arithmetic: x scaled by rs (one
    scale per 16 depths) and rounded to bf16, the f32 product with the
    widened weights, rounded, times the bf16 scale."""
    m, k = x.shape
    xb = x.float().numpy()
    rsn = rs.reshape(-1).numpy()
    xs = np.empty_like(xb)
    for c in range(0, k, 16):
        xs[:, c : c + 16] = f32_to_bf16_f32(xb[:, c : c + 16] * rsn[c // group])
    q = unpack_int4(qp).float()
    acc = torch.from_numpy(xs) @ q  # the plain version's f32 product
    return acc.to(torch.bfloat16) * s.reshape(1, -1).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,group", [(8, 256, 160, 64), (40, 128, 64, 32), (3, 384, 96, 128)])
def test_rank1_emulation_is_bit_equal(m, k, n, group):
    leaf, _, _, _ = leaves(k, n, group, "rank1", seed=m)
    x = torch.from_numpy(activations(m, k, seed=5)).to(torch.bfloat16)
    want = matmul_int4_plain(x, leaf["qp"], dt=torch.bfloat16, scheme="rank1", rs=leaf["rs"],
                             s=leaf["s"])
    got = emulate_rank1(x, leaf["qp"], leaf["rs"], leaf["s"], group)
    assert torch.equal(got, want)


def emulate_grouped(x, qp, gs, group, plan):
    """The small-M kernel's grouped order under ``plan``: a warp's 16-deep
    products summed in f32 into the group partial, which at the group's end
    is rounded to bf16, scaled by gs and added to the warp's f32 sum; the
    block's 4 warps take its steps in turn and their sums are added in
    warp order; the splits are summed in split order; then the rounding."""
    m, k = x.shape
    xb = x.float().numpy()
    q = unpack_int4(qp).numpy().astype(np.float32)
    gsn = gs.numpy()
    steps = math.ceil(k / plan.bk)
    per = math.ceil(steps / plan.splits)
    total = np.zeros((m, q.shape[1]), np.float32)
    for z in range(plan.splits):
        block = None
        for w in range(4):
            tot = np.zeros_like(total)
            part = np.zeros_like(total)
            for st in range(z * per + w, min(steps, (z + 1) * per), 4):
                for c in range(st * plan.bk, min(k, (st + 1) * plan.bk), 16):
                    part = part + xb[:, c : c + 16] @ q[c : c + 16]
                    if (c + 16) % group == 0:
                        tot = tot + f32_to_bf16_f32(part) * gsn[c // group]
                        part = np.zeros_like(part)
            block = tot if block is None else block + tot
        total = total + block
    return torch.from_numpy(total).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,group", [(8, 512, 96, 128), (40, 256, 64, 64), (8, 2048, 32, 32),
                                         (16, 1024, 64, 128), (8, 2304, 64, 96)])
def test_grouped_emulation_within_its_tolerance(m, k, n, group):
    """The grouped order of the plan (K split over a cluster at these
    shapes) within ``int4_grouped_tolerance`` of the plain version, and a
    fault that must exceed it: the partials scaled by the next group's
    scales."""
    leaf, _, _, _ = leaves(k, n, group, "grouped", seed=k)
    x = torch.from_numpy(activations(m, k, seed=9)).to(torch.bfloat16)
    plan = plan_matmul_int4(m, n, k, scheme="grouped", group=group)
    if k >= 2048:
        assert plan.splits > 1
    want = matmul_int4_plain(x, leaf["qp"], dt=torch.bfloat16, scheme="grouped", gs=leaf["gs"])
    tol = int4_grouped_tolerance(x, leaf["qp"], leaf["gs"])
    got = emulate_grouped(x, leaf["qp"], leaf["gs"], group, plan)
    assert ((got.float() - want.float()).abs() <= tol).all()
    rolled = torch.roll(leaf["gs"], 1, dims=0)
    bad = emulate_grouped(x, leaf["qp"], rolled, group, plan)
    assert ((bad.float() - want.float()).abs() > tol).any()


# ----------------------------------------------------------------- the planner

GEMMA_2B = {"wq/wo": (2048, 2048), "wk/wv": (2048, 256), "w_gate/w_up": (2048, 16384),
            "w_down": (16384, 2048)}
PREFILL_M = 8 * 3712


@pytest.mark.parametrize("m,k,n,scheme,x_ptr,q_ptr,regime", [
    (8, 2048, 16384, "rank1", 0, 0, "small_m"),
    (8, 16384, 2048, "grouped", 0, 0, "small_m"),
    (40, 2048, 16384, "rank1", 0, 0, "small_m"),
    (40, 2048, 16384, "grouped", 0, 0, "small_m"),
    (WGMMA_MIN_M, 2048, 16384, "rank1", 0, 0, "small_m"),
    (WGMMA_MIN_M + 1, 2048, 16384, "rank1", 0, 0, "wgmma"),
    (WGMMA_MIN_M + 1, 2048, 2048, "rank1", 0, 0, "small_m"),     # 8 tiles
    (PREFILL_M, 2048, 16384, "rank1", 0, 0, "wgmma"),
    (PREFILL_M, 16384, 2048, "rank1", 0, 0, "wgmma"),
    (8 * 1536, 2048, 256, "rank1", 0, 0, "wgmma"),
    (1024, 2048, 16384, "grouped", 0, 0, "small_m"),             # never wgmma
    (8, 2048, 256000, "channel", 0, 0, "small_m"),
    (PREFILL_M, 2048, 256000, "channel", 0, 0, "small_m"),
    (PREFILL_M, 2048, 1000, "rank1", 0, 0, "tail"),              # N % 32
    (8, 2048, 2048, "rank1", 8, 0, "tail"),                      # unaligned x
    (8, 2048, 2048, "grouped", 0, 4, "tail"),
    (8, 200, 300, "channel", 0, 0, "tail"),                      # K % 32
    (8, 2048, 2048, "grouped", 0, 0, "small_m"),
    (8, 2048, 2048, "grouped", 0, 8, "tail"),                    # gs unaligned (q_ptr 8: gs_ptr)
])
def test_plan_regime(m, k, n, scheme, x_ptr, q_ptr, regime):
    group = 0 if scheme == "channel" else 128 if k % 128 == 0 else 8
    gs_ptr = q_ptr if q_ptr == 8 else 0
    q_ptr = 0 if q_ptr == 8 else q_ptr
    plan = plan_matmul_int4(m, n, k, scheme=scheme, group=group, x_ptr=x_ptr, q_ptr=q_ptr,
                            gs_ptr=gs_ptr)
    assert plan.regime == regime
    assert plan_matmul_int4(m, n, k, scheme=scheme, group=group,
                            dt=torch.float32).regime == "f32"


def plan_blocks(plan):
    """Every block's work as the kernels index it: ``(block, row0, col0,
    k0, k1)`` for each output tile over depth ``[k0, k1)`` (as
    ``tests/test_torch_matmul.py`` reads ``plan_matmul``'s)."""
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


COVER_CASES = [(8, *GEMMA_2B["w_down"], "grouped", 128), (8, *GEMMA_2B["w_gate/w_up"], "rank1", 128),
               (40, *GEMMA_2B["w_down"], "grouped", 128), (40, *GEMMA_2B["wk/wv"], "rank1", 128),
               (PREFILL_M, *GEMMA_2B["wk/wv"], "rank1", 128), (1024, 4096, 1024, "grouped", 128),
               (8, 14336, 4096, "grouped", 128), (8, 2048, 256000, "channel", 0),
               (37, 2048, 1000, "rank1", 64), (5, 192, 96, "grouped", 96), (3, 16, 16, "grouped", 16),
               (12, 4096, 512, "grouped", 96), (20, 2048, 96, "grouped", 64)]


@pytest.mark.parametrize("m,k,n,scheme,group", COVER_CASES)
@pytest.mark.parametrize("sm_count", [132, 7])
def test_plan_tiles_cover_the_output_once(m, k, n, scheme, group, sm_count):
    plan = plan_matmul_int4(m, n, k, scheme=scheme, group=group, sm_count=sm_count)
    depth, blocks = {}, set()
    for block, row0, col0, k0, k1 in plan_blocks(plan):
        assert 0 <= row0 < m and 0 <= col0 < n and 0 <= k0 < k1 <= k, "an empty split"
        assert row0 % plan.bm == 0 and col0 % plan.bn == 0 and k0 % plan.bk == 0
        if scheme == "grouped":
            assert k0 % group == 0, "a group straddles two splits"
        depth.setdefault((row0, col0), []).append((k0, k1))
        blocks.add(block)
    assert blocks == set(range(plan.grid))
    assert sorted(depth) == [(r, c) for r in range(0, m, plan.bm) for c in range(0, n, plan.bn)]
    for ranges in depth.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) == plan.splits
    assert plan.splits <= MAX_SPLITS
    if plan.regime in ("small_m", "tail"):
        assert plan.bn == 64 and plan.bm in (8, 16, 32) and plan.bm >= min(m, 32)
        assert plan.bk % max(group, 1) == 0 and plan.bk <= 128


def test_decode_products_fill_the_card():
    """At a Gemma-2B decode step every int4 product launches a block per SM
    where its column tiles times a cluster's 16 splits allow that many (so
    that every SM streams weights)."""
    for scheme in ("rank1", "grouped"):
        for k, n in GEMMA_2B.values():
            plan = plan_matmul_int4(8, n, k, scheme=scheme, group=128)
            assert plan.regime == "small_m"
            tiles = math.ceil(n / plan.bn)
            if n * k >= 2048 * 2048:
                assert plan.grid >= min(132, tiles * MAX_SPLITS), (scheme, k, n, plan)


# ---------------------------------------------------------- wrapper and routing


def test_wrapper_rejects_bad_operands():
    leaf, _, emb, _ = leaves(128, 64, 64, "rank1")
    gleaf, _, _, _ = leaves(128, 64, 64, "grouped")
    x = torch.zeros((4, 128), dtype=torch.bfloat16)
    bf16 = torch.bfloat16
    ok = dict(dt=bf16, scheme="rank1")
    assert matmul_int4(x, leaf, **ok).shape == (4, 64)
    with pytest.raises(TypeError):  # int8 values, not nibble pairs
        matmul_int4(x, dict(leaf, qp=unpack_int4(leaf["qp"])), **ok)
    with pytest.raises(TypeError):
        matmul_int4(x, leaf, **dict(ok, dt=torch.float16))
    with pytest.raises(ValueError):
        matmul_int4(x, leaf, **dict(ok, scheme="rank2"))
    with pytest.raises(ValueError):  # K disagrees
        matmul_int4(x[:, :64], leaf, **ok)
    with pytest.raises(ValueError):  # rank-1 without rs
        matmul_int4(x, {"qp": leaf["qp"], "s": leaf["s"]}, **ok)
    with pytest.raises(ValueError):  # rs that does not divide K
        matmul_int4(x, dict(leaf, rs=torch.ones(3, 1)), **ok)
    with pytest.raises(ValueError):  # s of the wrong width
        matmul_int4(x, dict(leaf, s=leaf["s"][..., :32]), **ok)
    with pytest.raises(ValueError):  # transpose_rhs belongs to the channel scheme
        matmul_int4(x, leaf, **ok, transpose_rhs=True)
    with pytest.raises(ValueError):
        matmul_int4(x, emb, dt=bf16, scheme="channel")
    with pytest.raises(ValueError):  # gs of the wrong width
        matmul_int4(x, dict(gleaf, gs=gleaf["gs"][:, :32]), dt=bf16, scheme="grouped")
    with pytest.raises(ValueError):  # gs in bf16
        matmul_int4(x, dict(gleaf, gs=gleaf["gs"].to(bf16)), dt=bf16, scheme="grouped")
    assert set(INT4_SCHEMES) == {"rank1", "grouped", "channel"}


def test_kernel_is_registered():
    """The C entry's argument types (pointers as c_void_p, the 64-bit M)
    and its launch count."""
    sig = kernels._SIGNATURES["matmul_int4"]
    assert len(sig) == 20 and sig[:7] == [kernels._P] * 7 and sig[7] is kernels._I
    assert sig[8] is kernels._P and sig[12] is kernels._LL
    assert sig[-1] is kernels._P and "matmul_int4" in kernels.LAUNCHES


def test_mm_unpacks_only_where_jax_dequantizes(monkeypatch):
    """``_mm`` and the tied head call ``unpack_int4`` themselves only for
    grouped int4 above ``_INT4_DEQUANT_ROWS`` rows and rank-1's w4a8 rows;
    every other int4 product goes to ``matmul_int4`` (which, on the card,
    reads the packed weight)."""
    calls = []
    real = tg.unpack_int4
    monkeypatch.setattr(tg, "unpack_int4", lambda qp: calls.append(tuple(qp.shape)) or real(qp))
    bf16 = torch.bfloat16
    leaf, _, emb, _ = leaves(256, 160, 64, "rank1")
    gleaf, _, _, _ = leaves(256, 160, 64, "grouped")
    for m in (8, 40, 1024, 3000):
        tg._mm(torch.ones((m, 256), dtype=bf16), leaf, bf16)
    for m in (8, 40, 1024):
        tg._mm(torch.ones((m, 256), dtype=bf16), gleaf, bf16)
    assert calls == []
    tg._mm(torch.ones((1025, 256), dtype=bf16), gleaf, bf16)
    tg._mm(torch.ones((20, 256), dtype=bf16), leaf, bf16, act8_rows=16)
    assert calls == [tuple(gleaf["qp"].shape), tuple(leaf["qp"].shape)]


# ------------------------------------------------------- products sharing x


@pytest.mark.parametrize("scheme", ["rank1", "grouped"])
@pytest.mark.parametrize("m", [8, 40])
def test_shared_launch_equals_each_product(m, scheme):
    """matmul_int4 of a list of weights (on the card one launch for a
    layer's wq, wk and wv, or its w_gate and w_up) gives each product's
    matmul_int4 result, and
    ``_mm_shared`` gives ``_mm``'s, bit for bit on the CPU; its plan tiles
    each weight's columns once."""
    bf16 = torch.bfloat16
    ws = [leaves(256, n, 64, scheme, seed=n)[0] for n in (160, 32, 32)]
    x = torch.from_numpy(activations(m, 256, seed=3)).to(bf16)
    kw = lambda w: {key: v for key, v in w.items() if key != "qp"}  # noqa: E731
    got = matmul_int4(x, ws, dt=bf16, scheme=scheme)
    for g_, w in zip(got, ws):
        assert torch.equal(g_, matmul_int4_plain(x, w["qp"], dt=bf16, scheme=scheme, **kw(w)))
    shared = tg._mm_shared(x.reshape(2, m // 2, 256), ws, bf16)
    for y, w in zip(shared, ws):
        assert torch.equal(y, tg._mm(x.reshape(2, m // 2, 256), w, bf16))
    plan = plan_matmul_int4(m, (160, 32, 32), 256, scheme=scheme, group=64)
    single = [plan_matmul_int4(m, n, 256, scheme=scheme, group=64) for n in (160, 32, 32)]
    tiles = sum(math.ceil(p.n / p.bn) for p in single) * math.ceil(m / plan.bm)
    assert plan.regime == "small_m" and plan.n == 224 and plan.grid == tiles * plan.splits


def test_shared_routing_keeps_every_other_product():
    """``_mm_shared`` passes the weights to one ``matmul_int4`` call only
    where ``_mm`` would send each there in one scheme (the call shares a
    launch at up to WGMMA_MIN_M rows); bf16, int8 and w4a8 rows go through
    ``_mm`` one by one (its values either way)."""
    bf16 = torch.bfloat16
    rank1 = [leaves(256, n, 64, "rank1", seed=n)[0] for n in (64, 32)]
    for m, a8 in ((8, 0), (WGMMA_MIN_M + 1, 0), (20, 16)):
        x = torch.from_numpy(activations(m, 256, seed=m)).to(bf16)
        for y, w in zip(tg._mm_shared(x, rank1, bf16, a8), rank1):
            assert torch.equal(y, tg._mm(x, w, bf16, a8))
    plain = [torch.from_numpy(activations(256, n, seed=n)) for n in (64, 32)]
    x = torch.from_numpy(activations(8, 256, seed=1)).to(bf16)
    for y, w in zip(tg._mm_shared(x, plain, bf16), plain):
        assert torch.equal(y, tg._mm(x, w, bf16))


def test_shared_launch_rejects_bad_weights():
    """A list of weights: any count (more than ``MAX_SHARED`` take more
    launches on the card), each its own product; never the channel scheme
    or an empty list; one K and one group."""
    bf16 = torch.bfloat16
    x = torch.from_numpy(activations(8, 256, seed=5)).to(bf16)
    r = leaves(256, 32, 64, "rank1")[0]
    got = matmul_int4(x, [r] * (MAX_SHARED + 1), dt=bf16, scheme="rank1")
    assert len(got) == MAX_SHARED + 1
    assert all(torch.equal(g_, matmul_int4(x, r, dt=bf16, scheme="rank1")) for g_ in got)
    with pytest.raises(ValueError):  # the channel scheme takes one weight
        matmul_int4(x, [r], dt=bf16, scheme="channel")
    with pytest.raises(ValueError):
        matmul_int4(x, [], dt=bf16, scheme="rank1")
    other_k = leaves(128, 32, 64, "rank1")[0]
    with pytest.raises(ValueError):  # weights on different K
        matmul_int4(x, [r, other_k], dt=bf16, scheme="rank1")
    other_group = leaves(256, 32, 128, "rank1")[0]
    with pytest.raises(ValueError):  # weights of different groups
        matmul_int4(x, [r, other_group], dt=bf16, scheme="rank1")
