"""The plans of the port's CUDA sort and segment top-k, and their plain
versions on the inputs those designs find hard.

``ops/sort.py::sort_schedule`` plans the sort's passes (a tile pass, then
merge passes that double the sorted runs) and ``ops/sparse.py::
segment_plan`` splits segment top-k rows into chunks. The CUDA kernels run
only on the card (chip_smoke.py holds them to the plain versions there);
here each plan is carried out in numpy, pass by pass and chunk by chunk,
with the kernels' rules, and must give what the plain versions give. Then
the plain versions are held to the JAX Pallas kernels (interpret mode) on
duplicate-heavy keys, runs across chunk boundaries and equal scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops.pallas_sort import sort_pairs_pallas, sort_pairs_pallas_wide
from probing_rag_tpu.ops.pallas_sparse import segment_topk_pallas
from probing_rag_tpu.ops.sparse import sorted_segment_topk
from probing_rag_tpu_torch.ops import sort as sort_mod
from probing_rag_tpu_torch.ops.sort import (
    MAX_SORT_WIDTH, SORT_TILE, sort_pairs, sort_pairs_plain, sort_schedule,
)
from probing_rag_tpu_torch.ops.sparse import (
    SEG_CHUNK, SEG_MAX_PARTS, segment_plan, segment_topk, segment_topk_plain,
)

torch.set_num_threads(1)


def alternating_blocks(keys, vals, block):
    """Each ``block`` sorted, ascending at even block index, descending at
    odd: the k_start = 2 * block precondition."""
    q, p = keys.shape
    kb, vb = keys.reshape(q, p // block, block), vals.reshape(q, p // block, block)
    o = np.argsort(kb, axis=2, kind="stable")
    kb, vb = np.take_along_axis(kb, o, 2), np.take_along_axis(vb, o, 2)
    kb[:, 1::2], vb[:, 1::2] = kb[:, 1::2, ::-1], vb[:, 1::2, ::-1]
    return kb.reshape(q, p).copy(), vb.reshape(q, p).copy()


def pairs_by_block(keys, vals, block):
    """Each ``block`` of each row's (key, value) pairs in a canonical order,
    to compare pair multisets (the order of values within a key is free)."""
    kb, vb = keys.reshape(-1, block), vals.reshape(-1, block)
    o = np.stack([np.lexsort((vb[r], kb[r])) for r in range(kb.shape[0])])
    return np.take_along_axis(kb, o, 1), np.take_along_axis(vb, o, 1)


# ------------------------------------------------------------ sort schedule


def tile_pass(keys, vals, s):
    """The tile pass as the bitonic network defines it: stages s.k_lo ..
    s.k_hi on each tile of s.tile pairs, each block's direction by its
    position in the row, or in the tile when s.tile_asc. (The kernel runs
    the low stages in registers and merges the high ones; either leaves
    what the network leaves.)"""
    q, p = keys.shape
    k, v = keys.copy(), vals.copy()
    pos = np.arange(p)
    dirpos = pos % s.tile if s.tile_asc else pos
    kk = s.k_lo
    while kk <= s.k_hi:
        j = min(kk, s.tile) // 2
        while j >= 1:
            lo = pos[(pos & j) == 0]
            hi = lo + j
            asc = (dirpos[lo] & kk) == 0
            a, b = k[:, lo], k[:, hi]
            swap = np.where(asc, a > b, a < b)
            k[:, lo], k[:, hi] = np.where(swap, b, a), np.where(swap, a, b)
            va, vb = v[:, lo], v[:, hi]
            v[:, lo], v[:, hi] = np.where(swap, vb, va), np.where(swap, va, vb)
            j //= 2
        kk *= 2
    return k, v


def merge_pass(keys, vals, s):
    """One merge pass with the kernel's rules: runs 2m and 2m + 1 of length
    s.run merge, ties from run 2m first; odd input runs are read from their
    end when s.desc_odd; odd output runs are written reversed when
    s.rev_odd. Every input run must be sorted in the direction the pass
    reads it: that is what the schedule promises."""
    q, p = keys.shape
    r = s.run
    kb, vb = keys.reshape(q, p // r, r), vals.reshape(q, p // r, r)
    if s.desc_odd:
        kb, vb = kb.copy(), vb.copy()
        kb[:, 1::2], vb[:, 1::2] = kb[:, 1::2, ::-1], vb[:, 1::2, ::-1]
    assert (np.diff(kb.astype(np.int64), axis=2) >= 0).all(), "an input run is not sorted"
    km = kb.reshape(q, p // (2 * r), 2 * r)
    vm = vb.reshape(q, p // (2 * r), 2 * r)
    o = np.argsort(km, axis=2, kind="stable")  # run a's pairs come first: ties from a
    km, vm = np.take_along_axis(km, o, 2), np.take_along_axis(vm, o, 2)
    if s.rev_odd:
        km[:, 1::2], vm[:, 1::2] = km[:, 1::2, ::-1], vm[:, 1::2, ::-1]
    return km.reshape(q, p), vm.reshape(q, p)


def run_schedule(keys, vals, passes, in_place):
    """Carry out ``passes`` on numpy buffers as the wrapper does: "out" is
    "in" itself when sorting in place; a merge must not read the rows it
    writes. Returns "out"."""
    bufs = {"in": [keys.copy(), vals.copy()],
            "scratch": [np.empty_like(keys), np.empty_like(vals)]}
    bufs["out"] = bufs["in"] if in_place else [np.empty_like(keys), np.empty_like(vals)]
    for s in passes:
        src, dst = bufs[s.src], bufs[s.dst]
        if s.kind == "copy":
            got = (src[0].copy(), src[1].copy())
        elif s.kind == "tile":
            got = tile_pass(src[0], src[1], s)
        else:
            assert src is not dst, f"merge {s} reads the rows it writes"
            got = merge_pass(src[0], src[1], s)
        dst[0][:], dst[1][:] = got
    return bufs["out"]


# (row width, tile, k_start, k_stop): below the tile; k_stop inside it; a
# full sort from 2 and from a k_start inside the tile; k_start past the
# tile (the first merge reads odd runs backwards), at the row width (one
# merge); k_stop between the tile and the row (odd blocks written
# reversed), alone and with a k_start past the tile
SCHEDULE_CASES = [
    (64, 256, 2, None), (1024, 256, 2, 64), (4096, 256, 2, None), (4096, 256, 64, None),
    (4096, 256, 1024, None), (4096, 256, 4096, None), (4096, 256, 2, 1024),
    (4096, 256, 1024, 2048), (2048, 16, 2, None),
]


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("p,tile,k_start,k_stop", SCHEDULE_CASES)
def test_schedule_carried_out_equals_plain_sort(p, tile, k_start, k_stop, in_place,
                                                monkeypatch):
    """Keys equal exactly and each row's (each k_stop block's) pairs equal
    as multisets: the plan's directions, reversals and buffer parity are
    right. Keys from 8 values, so equal keys cross every tile and run. The
    tile is cut from 16K pairs so that narrow rows have many of them."""
    monkeypatch.setattr(sort_mod, "SORT_TILE", tile)
    rng = np.random.default_rng(p + k_start)
    keys = rng.integers(0, 8, (3, p)).astype(np.int32)
    vals = rng.random((3, p)).astype(np.float32)
    if k_start > 2:
        keys, vals = alternating_blocks(keys, vals, k_start // 2)
    k_last = p if k_stop is None else min(p, k_stop)
    passes = sort_schedule(p, k_start, k_last, in_place=in_place)
    got_k, got_v = run_schedule(keys, vals, passes, in_place)
    ref_k, ref_v = sort_pairs_plain(torch.from_numpy(keys), torch.from_numpy(vals),
                                    k_start=k_start, k_stop=k_stop)
    np.testing.assert_array_equal(got_k, ref_k.numpy())
    for a, b in zip(pairs_by_block(got_k, got_v, k_last),
                    pairs_by_block(ref_k.numpy(), ref_v.numpy(), k_last)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", [1 << 11, 1 << 15, 1 << 21, MAX_SORT_WIDTH])
@pytest.mark.parametrize("k_start", [2, 2048, 1 << 15, 1 << 16])
@pytest.mark.parametrize("in_place", [False, True])
def test_schedule_round_trips_and_parity(p, k_start, in_place):
    """At most log2(P / T) + 1 round trips through device memory (plus one
    copy when sorting in place needs it), passes chained buffer to buffer,
    the last one writing "out", no merge reading what it writes."""
    if k_start > p:
        assert sort_schedule(p, k_start, p) == []
        return
    passes = sort_schedule(p, k_start, p, in_place=in_place)
    t = min(p, SORT_TILE)
    work = [s for s in passes if s.kind != "copy"]
    assert len(work) <= (p // t).bit_length() - 1 + 1
    assert passes[-1].dst == "out"
    assert passes[0].src == "in"
    for a, b in zip(passes, passes[1:]):
        assert b.src == a.dst
    for s in passes:
        if s.kind == "merge":
            assert s.src != s.dst
            assert not (in_place and {s.src, s.dst} == {"in", "out"})
    copies = len(passes) - len(work)
    assert copies <= int(in_place)
    tiles = [s for s in work if s.kind == "tile"]
    assert len(tiles) == (1 if k_start <= t else 0)
    if tiles and p > t:
        assert tiles[0].tile_asc and tiles[0].k_hi == t
    runs = [s.run for s in work if s.kind == "merge"]
    assert runs == [max(t, k_start // 2) << i for i in range(len(runs))]
    if runs:
        assert runs[0] * 2 ** len(runs) == p


def test_schedule_of_the_table_shapes():
    """The round trips the source note of bitonic_sort.cu states."""
    def trips(q, p, k_start):
        return len(sort_schedule(p, k_start, p))

    assert SORT_TILE == 16384
    assert trips(8, 1 << 21, 2048) == 8  # the global bitonic stages took 45
    assert trips(2, 1 << 21, 2048) == 8
    assert trips(1, 1 << 23, 2) == 10  # was 66
    assert trips(64, 1 << 15, 2048) == 2
    assert trips(256, 1 << 14, 2) == 1


class RecordingLib:
    """Stands in for the CUDA library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("p,k_start,k_stop,in_place", [
    (1 << 15, 2048, None, False),  # tile pass, one merge
    (1 << 16, 1 << 16, None, True),  # a copy, then one merge reading odd runs backwards
    (1 << 16, 2, 1 << 15, False),  # the last merge writes odd blocks reversed
])
def test_launch_pass_hands_each_c_entry_its_arguments(p, k_start, k_stop, in_place):
    """``launch_pass`` gives each C entry as many arguments as
    ``kernels._SIGNATURES`` declares, in the entry's order: the pass's
    buffers, the shape, both row strides, the pass's fields, the stream. A
    copy pass copies on the card without a C entry."""
    from probing_rag_tpu_torch.kernels import _SIGNATURES

    q = 2
    keys = torch.arange(q * p, dtype=torch.int32).reshape(q, p)
    wide = torch.zeros((q, 2 * p), dtype=torch.float32)
    bufs = {"in": (keys, wide[:, :p], 2 * p),
            "scratch": (torch.empty_like(keys), torch.empty((q, p)), p)}
    bufs["out"] = bufs["in"] if in_place else (torch.empty_like(keys), torch.empty((q, p)), p)
    lib = RecordingLib()
    passes = sort_schedule(p, k_start, min(p, k_stop or p), in_place=in_place)
    for s in passes:
        sort_mod.launch_pass(lib, s, bufs, q, p, stream=7)
    work = [s for s in passes if s.kind != "copy"]
    assert [name for name, _ in lib.calls] == [f"sort_{s.kind}_pass" for s in work]
    for s, (name, args) in zip(work, lib.calls):
        assert len(args) == len(_SIGNATURES[name])
        src, dst = bufs[s.src], bufs[s.dst]
        assert args[:8] == (src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                            dst[1].data_ptr(), q, p, src[2], dst[2])
        fields = ((s.tile, s.k_lo, s.k_hi, int(s.tile_asc)) if s.kind == "tile"
                  else (s.run, int(s.desc_odd), int(s.rev_odd)))
        assert args[8:] == (*fields, 7)
    if len(work) < len(passes):
        assert torch.equal(bufs["scratch"][0], keys)


# ------------------------------------------------------- segment top-k plan


@pytest.mark.parametrize("q,p,k,want", [
    (1918, 16384, 5, (SEG_CHUNK, 2)),
    (8, 1 << 21, 5, (SEG_CHUNK, 256)),
    (1, MAX_SORT_WIDTH, 16, (SEG_CHUNK, 1024)),
    (1, 1 << 24, 16, (2 * SEG_CHUNK, 1024)),  # the chunk doubles: at most 1024 lists
    (4, 100, 3, (SEG_CHUNK, 1)),
    (4, 0, 3, (SEG_CHUNK, 1)),  # an empty row still has its (empty) list
])
def test_segment_plan(q, p, k, want):
    chunk, n, shape = segment_plan(q, p, k)
    assert (chunk, n) == want
    assert shape == (n, q, k)
    assert n <= SEG_MAX_PARTS and chunk % 4 == 0
    assert (n - 1) * chunk < max(p, 1) <= n * chunk or p == 0


def chunked_segment_topk(doc, imp, k, sentinel, chunk):
    """segment_topk.cu's design in numpy: each chunk of each row keeps the
    top-k of the runs whose head it holds (a chunk that starts with the
    sentinel is empty), summing a run forward from its head in slot order,
    past the chunk's end if it goes on; then each row's partial lists are
    merged. Ranked by (score desc, doc asc); empty slots (0, -1)."""
    q, p = doc.shape
    out_v = np.zeros((q, k), np.float32)
    out_i = np.full((q, k), -1, np.int32)
    for r in range(q):
        parts = []
        for c0 in range(0, max(p, 1), chunk):
            if c0 >= p or doc[r, c0] == sentinel:
                continue
            cands = []
            for i in range(c0, min(c0 + chunk, p)):
                d = doc[r, i]
                if d == sentinel:
                    break
                if i > 0 and doc[r, i - 1] == d:
                    continue  # not a head: the run began before, or is summed already
                s, j = np.float32(imp[r, i]), i + 1
                while j < p and doc[r, j] == d:
                    s = np.float32(s + imp[r, j])
                    j += 1
                cands.append((-s, d))
            parts.append(sorted(cands)[:k])
        best = sorted(x for part in parts for x in part)[:k]
        for n, (s, d) in enumerate(best):
            out_v[r, n], out_i[r, n] = -s, d
    return out_v, out_i


def boundary_rows(p, chunks, sentinel, seed):
    """Sorted (doc, impact) rows whose runs cross the given chunk
    boundaries: row 0 pairs every even slot with the one before it (a run
    across every boundary); row 1's real part ends mid-chunk; row 2 is the
    sentinel only; row 3 has runs of 1-3 postings of dyadic impacts (exact
    sums) with six equal top scores, heads in different chunks, one of them
    a run across a boundary; row 4 has runs of 1-16 postings."""
    rng = np.random.default_rng(seed)
    doc = np.full((5, p), sentinel, np.int32)
    imp = np.zeros((5, p), np.float32)
    doc[0] = (np.arange(p) + 1) // 2
    imp[0] = rng.random(p) * 3

    def runs(max_len):
        lens = rng.integers(1, max_len + 1, p)
        return np.repeat(np.arange(p) * 3 + rng.integers(0, 3, p), lens)[:p].astype(np.int32)

    real = p // 2 + 1234
    doc[1, :real] = runs(4)[:real]
    imp[1, :real] = rng.random(real) * 3
    doc[3] = runs(3)
    imp[3] = (rng.integers(0, 12, p) / 4).astype(np.float32)  # at most 2.75
    b = max(chunks)
    doc[3, b] = doc[3, b - 1]  # the run at slot b - 1 goes on over the boundary
    heads = np.flatnonzero(np.r_[True, doc[3, 1:] != doc[3, :-1]])
    starts = [int(heads[np.searchsorted(heads, f * p // 7)]) for f in range(1, 6)]
    cross = int(heads[np.searchsorted(heads, b, side="right") - 1])
    for h in starts + [cross]:
        end = h + 1
        while end < p and doc[3, end] == doc[3, h]:
            end += 1
        imp[3, h:end] = 0.0
        imp[3, h] = 2.5
        imp[3, h + 1 if end > h + 1 else h] += 7.5  # 10.0 exactly
    doc[4] = runs(16)
    imp[4] = rng.random(p) * 3
    return doc, imp


@pytest.mark.parametrize("chunk", [4096, 8192, 16384])
@pytest.mark.parametrize("k", [5, 16])
def test_chunked_design_equals_plain_segment_topk(chunk, k):
    """The chunk-ownership rule over rows with runs across every boundary:
    equal to the plain version in ids and scores (both sum each run's f32
    postings in slot order, so the scores are equal, not just close)."""
    sentinel = 1 << 20
    doc, imp = boundary_rows(1 << 15, (chunk,), sentinel, seed=chunk + k)
    got_v, got_i = chunked_segment_topk(doc, imp, k, sentinel, chunk)
    ref_v, ref_i = segment_topk_plain(torch.from_numpy(doc), torch.from_numpy(imp), k=k,
                                      sentinel=sentinel)
    np.testing.assert_array_equal(got_v, ref_v.numpy())
    np.testing.assert_array_equal(got_i, ref_i.numpy())
    assert (got_i[2] == -1).all() and (got_v[2] == 0).all()  # the sentinel-only row
    assert (got_v[3, :min(k, 6)] == 10.0).all()  # equal top scores, ranked by doc id
    assert (np.diff(got_i[3, :min(k, 6)]) > 0).all()


# ------------------------------------- plain versions against Pallas kernels


@pytest.mark.parametrize("k_start", [2, 2048])
def test_plain_sort_matches_pallas_on_duplicate_keys(k_start):
    """[2, 32768] rows of keys from 64 values (equal runs across every tile
    and merge window), from k_start 2048 as the BM25 gather leaves them:
    keys equal exactly, pairs equal as multisets."""
    rng = np.random.default_rng(k_start)
    keys = rng.integers(0, 64, (2, 1 << 15)).astype(np.int32)
    vals = rng.random((2, 1 << 15)).astype(np.float32)
    if k_start > 2:
        keys, vals = alternating_blocks(keys, vals, k_start // 2)
    jk, jv = sort_pairs_pallas(jnp.asarray(keys), jnp.asarray(vals), interpret=True,
                               k_start=k_start)
    tk, tv = sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals), k_start=k_start)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(pairs_by_block(tk.numpy(), tv.numpy(), 1 << 15),
                    pairs_by_block(np.asarray(jk), np.asarray(jv), 1 << 15)):
        np.testing.assert_array_equal(a, b)


def test_plain_wide_sort_matches_pallas_wide_on_duplicate_keys():
    """The TPU's wide kernel on a [1, 65536] row of keys from 64 values:
    keys equal exactly, pairs equal as multisets."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 64, (1, 1 << 16)).astype(np.int32)
    vals = rng.random((1, 1 << 16)).astype(np.float32)
    jk, jv = sort_pairs_pallas_wide(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    tk, tv = sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(pairs_by_block(tk.numpy(), tv.numpy(), 1 << 16),
                    pairs_by_block(np.asarray(jk), np.asarray(jv), 1 << 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [5, 16])
def test_plain_segment_topk_matches_pallas_across_boundaries(k):
    """Rows with runs across the 4096, 8192 and 16384 boundaries and equal
    top scores, against the Pallas kernel and the XLA reference. Scores
    within rtol 1e-5 / atol 1e-4 of the Pallas kernel's (it adds a run's
    postings in tile order, the plain version in scatter order), and equal
    on the row of exact dyadic sums; ids equal where the scores are
    distinct. The Pallas kernel ranks equal scores in another order, so on
    that row the ids are held to the XLA reference (doc id ascending)."""
    sentinel = 1 << 20
    doc, imp = boundary_rows(1 << 15, (4096, 8192, 16384), sentinel, seed=k)
    tv, ti = segment_topk(torch.from_numpy(doc), torch.from_numpy(imp), k=k, sentinel=sentinel)
    tv, ti = tv.numpy(), ti.numpy()
    pv, pi = segment_topk_pallas(jnp.asarray(doc), jnp.asarray(imp), k=k, sentinel=sentinel,
                                 interpret=True)
    pv, pi = np.asarray(pv), np.asarray(pi)
    np.testing.assert_allclose(tv, pv, rtol=1e-5, atol=1e-4)
    for r in range(tv.shape[0]):
        for j in range(k):
            if (np.abs(pv[r] - pv[r, j]) <= 1e-4).sum() == 1:
                assert ti[r, j] == pi[r, j], (r, j)
    np.testing.assert_array_equal(tv[3], pv[3])
    _, xi = sorted_segment_topk(jnp.asarray(doc), jnp.asarray(imp), k, sentinel=sentinel,
                                presorted=True)
    np.testing.assert_array_equal(ti[3], np.asarray(xi)[3])
    assert (tv[3, :min(k, 6)] == 10.0).all()
    assert (ti[2] == -1).all() and (tv[2] == 0).all()
