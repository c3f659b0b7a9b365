"""The plans of the port's CUDA dense searches, and their plain versions on
the inputs those designs find hard.

``ops/dense.py::plan_dense`` tiles the queries and splits the store into
chunks for ``dense_topk.cu``; ``ops/ivf.py::plan_ivf`` splits each tile's
(descriptor, 64-row piece) work items over blocks for ``ivf_topk.cu``. The
CUDA kernels run only on the card (chip_smoke.py holds them to the plain
versions there); here each plan is checked for coverage and carried out in
torch on the CPU, block by block, with a top-k per partial list and the
kernels' merge order (score descending, then column or id ascending), and
must give what the plain versions give. Then the plain versions are held
to the JAX Pallas kernels (interpret mode) on the same inputs.

Inputs are numpy draws from a seed. Equal scores are made on purpose
(duplicated store rows straddling chunk and piece boundaries); where the
Pallas kernels order ties differently, ids are compared where the scores
are distinct. Tolerances: rtol 1e-5, atol 1e-4 on f32 sums of the same
exact products taken in another order; int8 x int8 sums are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops import pallas_dense as jpd
from probing_rag_tpu.ops import pallas_ivf as jpi
from probing_rag_tpu_torch.ops import dense as dense_mod
from probing_rag_tpu_torch.ops import ivf as ivf_mod
from probing_rag_tpu_torch.ops.dense import (
    CAPS, SMEM_LIMIT, WGMMA_MAX_N, WGMMA_ROWS, dense_topk_plain, plan_dense,
    prepare_dense_store,
)
from probing_rag_tpu_torch.ops.ivf import PIECE, QT, TOPK_MAX, ivf_topk_plain, plan_ivf

torch.set_num_threads(1)

SM = 132  # the H100's SMs
INT_MAX = 2**31 - 1
BF16, I8, F32 = torch.bfloat16, torch.int8, torch.float32


def merge_lists(vals, ids, k):
    """Partial lists [L, Q, kp] -> the best k of each query by (score desc,
    id asc), empty slots (-inf, -1): topk_merge.cuh's order."""
    v = torch.cat(list(vals), 1)
    i = torch.cat(list(ids), 1)
    by_id = torch.sort(i, dim=1, stable=True).indices
    v, i = torch.gather(v, 1, by_id), torch.gather(i, 1, by_id)
    top, pos = torch.sort(v, dim=1, descending=True, stable=True)
    top, out = top[:, :k], torch.gather(i, 1, pos[:, :k])
    return top, torch.where(torch.isneginf(top), -1, out).to(torch.int32)


def topk_rows(scores, cols, kp):
    """Top-kp of each row of [Q, R] scores by (score desc, column asc), the
    columns ascending along R; short rows padded with (-inf, INT_MAX)."""
    q, r = scores.shape
    if r < kp:
        scores = torch.cat([scores, scores.new_full((q, kp - r), float("-inf"))], 1)
        cols = torch.cat([cols, cols.new_full((q, kp - r), INT_MAX)], 1)
    top, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :kp], torch.gather(cols, 1, pos[:, :kp])


# ---------------------------------------------------------------- plan_dense


def chunk_rows_of(plan, n):
    return [(y * plan.chunk_rows, min((y + 1) * plan.chunk_rows, n))
            for y in range(plan.nchunks)]


@pytest.mark.parametrize("nq", [1, 7, 8, 9, 64, 65, 128, 129, 256, 257, 1000])
def test_plan_dense_width_is_the_tile_rounded_up_to_8(nq):
    """Up to WGMMA_MAX_N queries run as one tile at the smallest multiple
    of 8 that holds them; more are split evenly over the fewest tiles."""
    plan = plan_dense(nq, 500_000, 768, BF16, 16, False, SM, (0, 256))
    assert plan.regime == "wgmma"
    tiles = -(-nq // WGMMA_MAX_N)
    assert plan.qtiles == tiles and plan.qt == -(-nq // tiles)
    assert plan.ntile == -(-plan.qt // 8) * 8 <= WGMMA_MAX_N
    if nq <= WGMMA_MAX_N:
        assert plan.ntile == -(-nq // 8) * 8
    assert plan.qt * plan.qtiles >= nq > plan.qt * (plan.qtiles - 1)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 20_011, 100_000, 499_937, 500_000])
@pytest.mark.parametrize("nq", [8, 256])
def test_plan_dense_chunks_cover_every_row_once(n, nq):
    for dtype, mxu in ((BF16, False), (I8, False), (I8, True), (F32, False)):
        plan = plan_dense(nq, n, 768, dtype, 16, mxu, SM, (0, 256))
        rows = chunk_rows_of(plan, n)
        assert rows[0][0] == 0 and rows[-1][1] == n
        assert all(a < b for a, b in rows) and all(rows[i][1] == rows[i + 1][0]
                                                    for i in range(len(rows) - 1))
        assert plan.nchunks <= 1024
        step = WGMMA_ROWS if plan.regime == "wgmma" else 64
        assert plan.chunk_rows % step == 0
        # one block per SM for wgmma: a whole number of waves
        if plan.regime == "wgmma":
            assert plan.nchunks * plan.qtiles <= SM * -(-plan.qtiles // SM)


@pytest.mark.parametrize("d,dtype,mxu,regime", [
    (768, F32, False, "staged"),  # exact f32 FMAs for the coarse quantizer
    (100, BF16, False, "staged"),  # a 200-byte pitch
    (40, I8, False, "staged"),  # a 40-byte pitch
    (40, I8, True, "staged"),
    (32, BF16, False, "wgmma"),  # 64 bytes
    (48, I8, True, "wgmma"),
    (768, I8, False, "wgmma"),
])
def test_plan_dense_regime_by_type_and_pitch(d, dtype, mxu, regime):
    assert plan_dense(37, 20_011, d, dtype, 16, mxu, SM, (0, 256)).regime == regime


def test_plan_dense_unaligned_pointers_take_the_staged_regime():
    assert plan_dense(8, 1000, 64, BF16, 16, False, SM, (8, 256)).regime == "staged"
    assert plan_dense(8, 1000, 64, BF16, 16, False, SM, (0, 272)).regime == "wgmma"


@pytest.mark.parametrize("kp", [1, 16, 32, 128, 256])
@pytest.mark.parametrize("dtype,mxu", [(BF16, False), (I8, False), (I8, True)])
@pytest.mark.parametrize("d", [32, 768, 1024])
def test_plan_dense_shared_memory_fits(kp, dtype, mxu, d):
    plan = plan_dense(256, 500_000, d, dtype, kp, mxu, SM, (0, 256))
    assert plan.regime == "wgmma"
    assert plan.smem <= SMEM_LIMIT == 227 * 1024
    assert plan.smem == dense_mod._wgmma_smem(dense_mod._mode(dtype, mxu), plan.ntile, kp, d,
                                              plan.stages, plan.boxes, plan.cap, plan.resident)
    assert 3 <= plan.stages <= 6 and plan.boxes in (1, 2) and plan.cap in CAPS
    if dtype == I8 and not mxu:  # its depth order is permuted as the tile is written
        assert plan.resident


def carry_out_dense(qc, store, *, k, n, sq_norms, scales, mxu_int8):
    """A sweep for ``ops/dense.py::_dense_topk`` that carries out the plan
    as the kernel does: every (query tile, chunk) block keeps its top-k by
    (score desc, column asc), the partial lists are merged."""
    nq, d = qc.shape
    plan = plan_dense(nq, n, d, store.dtype, k, mxu_int8, SM, (0, 256))
    q = qc.double() if mxu_int8 else qc.float()
    lists_v, lists_i = [], []
    for r0, r1 in chunk_rows_of(plan, n):
        pv = torch.empty((nq, k))
        pi = torch.empty((nq, k), dtype=torch.int64)
        for x in range(plan.qtiles):
            q0, q1 = x * plan.qt, min((x + 1) * plan.qt, nq)
            sc = (q[q0:q1] @ store[r0:r1].to(q.dtype).T).float()
            if scales is not None:
                sc = sc * scales[r0:r1][None]
            if sq_norms is not None:
                sc = 2.0 * sc - sq_norms[r0:r1][None]
            cols = torch.arange(r0, r1).expand(q1 - q0, -1)
            pv[q0:q1], pi[q0:q1] = topk_rows(sc, cols, k)
        lists_v.append(pv)
        lists_i.append(pi)
    return merge_lists(lists_v, lists_i, k)


def tie_store(n, d, seed, stride):
    """Normal rows with duplicates every ``stride`` rows: row j * stride is
    a copy of row j * stride - 1, so equal scores straddle each boundary."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[stride::stride] = emb[stride - 1:-1:stride][: len(emb[stride::stride])]
    return emb


# int8 x int8 scores inner products only
SEARCHES = [(m, dt, False) for m in ("ip", "l2") for dt in ("bf16", "int8", "f32")]
SEARCHES.append(("ip", "int8", True))


@pytest.mark.parametrize("metric,dt,mxu", SEARCHES)
@pytest.mark.parametrize("nq", [3, 9, 130])
def test_dense_plan_carried_out_equals_plain(metric, dt, mxu, nq):
    """n = 1000 rows in chunks of 128 (wgmma) or 64 (staged), duplicates
    straddling every chunk boundary; 130 queries take two tiles."""
    stride = 128 if dt != "f32" else 64
    emb = tie_store(1000, 64, 3, stride)
    q = np.random.default_rng(4).normal(size=(nq, 64)).astype(np.float32)
    # the strongest candidates are the duplicated pairs: a query near them
    q[0] = emb[stride] * 3.0
    st = prepare_dense_store(torch.from_numpy(emb), metric=metric,
                             store_dtype={"bf16": BF16, "int8": I8, "f32": None}[dt])
    kw = dict(k=10, metric=metric, sq_norms=st.sq_norms, scales=st.scales, n_total=st.n_docs,
              k_pad=16, mxu_int8=mxu)
    plan = plan_dense(nq, 1000, 64, st.embeddings.dtype, 10, mxu, SM, (0, 256))
    assert plan.nchunks > 1 and plan.chunk_rows == stride
    got = dense_mod._dense_topk(carry_out_dense, torch.from_numpy(q), st.embeddings, **kw)
    ref = dense_topk_plain(torch.from_numpy(q), st.embeddings, **kw)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    if mxu:  # exact sums: the same bits
        np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    else:
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-5, atol=1e-4)
    # the tie at the first boundary resolves by column ascending
    row0 = ref[1][0].tolist()
    assert stride - 1 in row0 and stride in row0
    assert row0.index(stride - 1) + 1 == row0.index(stride)


def assert_same_where_distinct(got, ref):
    gv, gi = got
    rv, ri = ref
    np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-4)
    fin = np.where(np.isfinite(rv), rv, 0.0)
    gap = np.abs(np.diff(fin, axis=1)) > 1e-4
    distinct = np.ones_like(ri, bool)
    distinct[:, 1:] &= gap
    distinct[:, :-1] &= gap
    np.testing.assert_array_equal(gi[distinct], ri[distinct])


@pytest.mark.parametrize("metric,dt,mxu", [s for s in SEARCHES if s[1] != "f32"])
def test_dense_plain_matches_pallas_on_tie_inputs(metric, dt, mxu):
    emb = tie_store(700, 64, 5, 128)
    q = np.random.default_rng(6).normal(size=(9, 64)).astype(np.float32)
    q[0] = emb[128] * 3.0
    st = prepare_dense_store(torch.from_numpy(emb), metric=metric,
                             store_dtype={"bf16": BF16, "int8": I8}[dt])
    got = dense_topk_plain(torch.from_numpy(q), st.embeddings, k=5, metric=metric,
                           sq_norms=st.sq_norms, scales=st.scales, n_total=st.n_docs,
                           mxu_int8=mxu)
    js = jpd.prepare_dense_store(jnp.asarray(emb), tile_n=256, metric=metric,
                                 store_dtype={"bf16": jnp.bfloat16, "int8": jnp.int8}[dt])
    ref = jpd.dense_topk_pallas(jnp.asarray(q), js.embeddings, k=5, metric=metric, tile_n=256,
                                tile_q=8, sq_norms=js.sq_norms, scales=js.scales,
                                n_total=js.n_docs, mxu_int8=mxu, interpret=True)
    assert_same_where_distinct((got[0].numpy(), got[1].numpy()),
                               (np.asarray(ref[0]), np.asarray(ref[1])))


# ------------------------------------------------------------------ plan_ivf


def ivf_blocks(plan, t, pb):
    """(tile, list, descriptor j, piece p) of every work item, as the
    kernel walks them: block y of a tile takes items [y * items // nsplit,
    (y + 1) * items // nsplit), its pipeline w those with i % 2 == w."""
    out = []
    items = pb * plan.pieces
    for ti in range(t):
        for y in range(plan.nsplit):
            if plan.regime == "wgmma":
                i0, i1 = y * items // plan.nsplit, (y + 1) * items // plan.nsplit
                for i in range(i0, i1):
                    out.append((ti, 2 * y + i % 2, i // plan.pieces, i % plan.pieces))
            else:
                for j in range(y * plan.per_split, min((y + 1) * plan.per_split, pb)):
                    out.append((ti, y, j, 0))
    return out


@pytest.mark.parametrize("t,pb,block", [(1, 400, 256), (8, 300, 256), (9, 317, 256),
                                        (1, 3, 48), (5, 30, 48), (200, 40, 256), (1, 1, 256)])
@pytest.mark.parametrize("dtype", [BF16, I8, F32])
def test_plan_ivf_items_cover_every_piece_once(t, pb, block, dtype):
    plan = plan_ivf(t, pb, block, 768 if dtype != I8 else 768, dtype, SM, (0, 256))
    assert plan.regime == ("staged" if dtype == F32 else "wgmma")
    items = ivf_blocks(plan, t, pb)
    want = sorted((ti, j, p) for ti in range(t) for j in range(pb) for p in range(plan.pieces))
    assert sorted((ti, j, p) for ti, _, j, p in items) == want
    assert plan.lists <= 1024
    assert max(li for _, li, _, _ in items) < plan.lists
    if plan.regime == "wgmma":
        assert plan.pieces == -(-block // PIECE)
        assert plan.smem <= SMEM_LIMIT and 3 <= plan.stages <= 6


def test_plan_ivf_one_tile_fills_the_card():
    """The loop's Q 8 over 1M x 768 (nprobe 32: ~400 probed blocks of 256)
    is one tile; its items still make at least one block per SM."""
    plan = plan_ivf(1, 400, 256, 768, BF16, SM, (0, 256))
    assert plan.pieces * 400 >= SM and plan.nsplit == SM
    per = [len([1 for _, li, _, _ in ivf_blocks(plan, 1, 400) if li // 2 == y])
           for y in range(plan.nsplit)]
    assert max(per) - min(per) <= 1


@pytest.mark.parametrize("d,dtype,regime", [(40, BF16, "wgmma"), (40, I8, "staged"),
                                            (100, BF16, "staged"), (40, F32, "staged")])
def test_plan_ivf_regime_by_type_and_pitch(d, dtype, regime):
    assert plan_ivf(5, 30, 48, d, dtype, SM, (0, 256)).regime == regime


def ivf_store(seed, nb, block, d, pad_rows):
    """A cell-sorted, block-padded store: nb blocks of ``block`` rows, the
    last all pad; ``pad_rows`` ids of -1 at the tail of each real block.
    Rows 63 and 64 of each block (a piece boundary) are equal, and ids run
    down, so the tie resolves by id against row order."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(nb * block, d)).astype(np.float32)
    ids = np.arange(nb * block, dtype=np.int32)[::-1].copy()
    for b in range(nb):
        base = b * block
        if block > 64:
            emb[base + 64] = emb[base + 63]
        ids[base + block - pad_rows: base + block] = -1
    emb[(nb - 1) * block:] = 0.0
    ids[(nb - 1) * block:] = -1
    return emb, ids


def carry_out_ivf(qc, desc, store, ids, *, k, block, sq_norms, scales):
    """A sweep for ``ops/ivf.py::_ivf_topk`` that carries out plan_ivf as
    the kernel does: each list scores its items' 64-row pieces (rows past
    the block and pad rows -inf, the pad block and descriptors outside the
    store skipped), keeps a top-16 by (score desc, id asc); the lists of
    each query are merged."""
    t, pb = desc.shape
    rows, d = store.shape
    pad_block = rows // block - 1
    plan = plan_ivf(t, pb, block, d, store.dtype, SM, (0, 256))
    q = qc.float()
    lists = {}
    for ti, li, j, p in ivf_blocks(plan, t, pb):
        b = int(desc[ti, j])
        key = (ti, li)
        lists.setdefault(key, [])
        if b < 0 or b >= pad_block:
            continue
        lo = p * PIECE if plan.regime == "wgmma" else 0
        hi = min(lo + PIECE, block) if plan.regime == "wgmma" else block
        r = torch.arange(b * block + lo, b * block + hi)
        sc = q[ti * QT:(ti + 1) * QT] @ store[r].float().T
        if scales is not None:
            sc = sc * scales[r][None]
        if sq_norms is not None:
            sc = 2.0 * sc - sq_norms[r][None]
        rid = ids[r].long()
        sc = torch.where(rid[None] >= 0, sc, float("-inf"))
        lists[key].append((sc, torch.where(rid >= 0, rid, INT_MAX).expand(QT, -1)))
    out_v, out_i = [], []
    for ti in range(t):
        parts_v, parts_i = [], []
        for li in range(plan.lists):
            got = lists.get((ti, li), [])
            if got:
                sc = torch.cat([g[0] for g in got], 1)
                gid = torch.cat([g[1] for g in got], 1)
                by_id = torch.sort(gid, dim=1, stable=True).indices
                sc, gid = torch.gather(sc, 1, by_id), torch.gather(gid, 1, by_id)
                v, i = topk_rows(sc, gid, TOPK_MAX)
            else:
                v = torch.full((QT, TOPK_MAX), float("-inf"))
                i = torch.full((QT, TOPK_MAX), INT_MAX, dtype=torch.int64)
            parts_v.append(v)
            parts_i.append(i)
        v, i = merge_lists(parts_v, parts_i, k)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("block,pad_rows", [(256, 5), (48, 7)])
def test_ivf_plan_carried_out_equals_plain(metric, dt, block, pad_rows):
    """Three tiles over 6 real blocks with holes (the pad block) and a
    descriptor repeated in no tile; block 48 (a 64-row piece reaches into
    the next block) and pad rows at each block's tail."""
    d = 64
    emb, ids = ivf_store(7, 7, block, d, pad_rows)
    rng = np.random.default_rng(8)
    q = rng.normal(size=(3 * QT, d)).astype(np.float32)
    q[0] = emb[63] * 3.0  # its best pair is the tie across the piece boundary
    desc = np.array([[0, 3, 6, 1], [6, 6, 6, 6], [5, 2, 4, 6]], np.int32)  # 6: the pad block
    tdt = {"bf16": BF16, "int8": I8, "f32": F32}[dt]
    from probing_rag_tpu_torch.retrieval import ivf as tivf
    temb, tscl, tsqn = tivf.host_store_prep(emb, metric, tdt, "cpu")
    args = (torch.from_numpy(q), torch.from_numpy(desc), temb, torch.from_numpy(ids))
    kw = dict(k=10, metric=metric, block=block, sq_norms=tsqn, scales=tscl)
    got = ivf_mod._ivf_topk(carry_out_ivf, *args, **kw)
    ref = ivf_topk_plain(*args, **kw)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-5, atol=1e-4)
    assert (ref[1][QT:2 * QT] == -1).all()  # the all-hole tile
    if block == 256:  # equal scores, ids 63 and 64 rows apart: the lower id first
        row0 = ref[1][0].tolist()
        a, b = int(ids[64]), int(ids[63])
        assert row0.index(a) + 1 == row0.index(b)
    # and the JAX Pallas kernel (interpret mode) on the same inputs
    from probing_rag_tpu.retrieval import ivf as jivf
    jdt = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}[dt]
    jemb, jscl, jsqn = jivf.host_store_prep(emb, metric, jdt)  # [8, N] norms and scales
    ids8 = np.broadcast_to(ids[None], (8, ids.size)).copy()
    jref = jpi.ivf_topk_pallas(jnp.asarray(q), jnp.asarray(desc), jnp.asarray(jemb),
                               jnp.asarray(ids8), k=10, metric=metric, block=block,
                               sq_norms=None if jsqn is None else jnp.asarray(jsqn),
                               scales=None if jscl is None else jnp.asarray(jscl),
                               interpret=True)
    assert_same_where_distinct((ref[0].numpy(), ref[1].numpy()),
                               (np.asarray(jref[0]), np.asarray(jref[1])))
