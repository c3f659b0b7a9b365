"""The port's IVF index (``retrieval/ivf.py``, ``ops/ivf.py``) against the
JAX package: k-means and cell assignment, the block layout, the probe plan,
``ivf_topk_plain`` against ``ivf_topk_pallas`` in interpret mode and
``ivf_topk_xla``, and ``IVFEngine`` over index files that the other
package saved.

Inputs are numpy draws from a seed on separable clusters (so no point lies
near a cell boundary). Tolerances: centroids rtol/atol 1e-5 (f32 means of
the same points, summed in another order); scores rtol 1e-5, atol 1e-4
(the same exact products summed in another order). Ties: the port ranks
equal scores by doc id ascending, the Pallas merge puts a later equal value
first, so ids are compared where the scores are distinct."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops import pallas_ivf as jpi
from probing_rag_tpu.retrieval import ivf as jivf
from probing_rag_tpu_torch.ops.ivf import ivf_topk, ivf_topk_plain
from probing_rag_tpu_torch.retrieval import ivf as tivf

torch.set_num_threads(1)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def clustered(rng, n_clusters=8, per=64, d=32, spread=0.05):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    pts = (centers[:, None, :]
           + spread * rng.normal(size=(n_clusters, per, d)).astype(np.float32)).reshape(-1, d)
    return pts, centers


def assert_same_topk(got_v, got_i, ref_v, ref_i):
    np.testing.assert_allclose(got_v, ref_v, rtol=1e-5, atol=1e-4)
    fin = np.where(np.isfinite(ref_v), ref_v, 0.0)
    gap = np.abs(np.diff(fin, axis=1)) > 1e-4
    distinct = np.ones_like(ref_i, bool)
    distinct[:, 1:] &= gap
    distinct[:, :-1] &= gap
    np.testing.assert_array_equal(got_i[distinct], ref_i[distinct])


def test_kmeans_and_assign_match_jax():
    rng = np.random.default_rng(0)
    pts, _ = clustered(rng)
    ref = jivf.kmeans(pts, 8, iters=15, seed=1)
    got = tivf.kmeans(pts, 8, iters=15, seed=1, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tivf.assign_cells(pts, got, device="cpu"), jivf.assign_cells(pts, ref))


def test_kmeans_subsample_follows_the_same_draws():
    """nlist * sample_per_list < n: both subsample with the same rng
    draws."""
    rng = np.random.default_rng(1)
    pts, _ = clustered(rng, n_clusters=4, per=50, d=8)
    np.testing.assert_allclose(tivf.kmeans(pts, 4, iters=5, seed=2, sample_per_list=16, device="cpu"),
                               jivf.kmeans(pts, 4, iters=5, seed=2, sample_per_list=16),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(2)
    pts, _ = clustered(rng, n_clusters=16, per=40, d=64)
    q = rng.normal(size=(13, 64)).astype(np.float32) * 2.0  # not a multiple of 8
    out = {"pts": pts, "q": q}
    for metric in ("ip", "l2"):
        out[metric] = (jivf.IVFDenseIndex.build(pts, nlist=16, block=32, metric=metric, seed=0),
                       tivf.IVFDenseIndex.build(pts, nlist=16, block=32, metric=metric, seed=0,
                                                device="cpu"))
    return out


def test_build_layout_matches_jax(built):
    j, t = built["l2"]
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5, atol=1e-5)
    for name in ("ids_blocked", "list_block_start", "list_nblocks", "emb_blocked"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert (t.pad_block, t.nlist, t.n_docs) == (j.pad_block, j.nlist, j.n_docs)
    assert t.imbalance_factor() == j.imbalance_factor()
    for n in (10, 1000, 100_000, 1_000_000):
        assert tivf.IVFDenseIndex.default_nlist(n) == jivf.IVFDenseIndex.default_nlist(n)


@pytest.mark.parametrize("nprobe", [3, 16])
def test_probe_and_plan_match_jax(built, nprobe):
    j, t = built["ip"]
    q = built["q"]
    jeng = jivf.IVFEngine(j, nprobe=nprobe, store_dtype=jnp.float32)
    teng = tivf.IVFEngine(t, nprobe=nprobe, store_dtype=torch.float32, device="cpu")
    probes = teng.probe_cells(q)
    np.testing.assert_array_equal(probes, jeng.probe_cells(q))
    np.testing.assert_array_equal(teng.plan(probes), jeng.plan(probes))
    tiles, keep, nt = tivf.tile_union(probes)
    jtiles, jkeep, jt = jivf.tile_union(probes)
    np.testing.assert_array_equal(tiles, jtiles)
    np.testing.assert_array_equal(keep, jkeep)
    assert nt == jt == 2
    starts = t.list_block_start[tiles]
    nb = np.where(keep, t.list_nblocks[tiles], 0)
    np.testing.assert_array_equal(tivf.expand_tile_blocks(starts, nb, 64, t.pad_block),
                                  jivf.expand_tile_blocks(starts, nb, 64, t.pad_block))


def store_args(ix, dt, device="cpu"):
    emb, scl, sqn = tivf.host_store_prep(ix.emb_blocked, ix.metric, TDT[dt], device)
    return emb, torch.from_numpy(ix.ids_blocked), scl, sqn


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_ivf_topk_plain_matches_pallas_and_xla(built, metric, dt):
    j, t = built[metric]
    q = built["q"]
    eng = tivf.IVFEngine(t, nprobe=3, store_dtype=torch.float32, device="cpu")
    desc = eng.plan(eng.probe_cells(q))
    qpad = np.concatenate([q, np.broadcast_to(q[:1], (16 - 13, q.shape[1]))])
    emb, ids, scl, sqn = store_args(t, dt)
    got_v, got_i = ivf_topk_plain(torch.from_numpy(qpad), torch.from_numpy(desc), emb, ids,
                                  k=5, metric=metric, block=32, sq_norms=sqn, scales=scl)
    jemb, jscl, jsqn = jivf.host_store_prep(j.emb_blocked, metric, JDT[dt])
    ids8 = np.broadcast_to(j.ids_blocked[None], (8, j.ids_blocked.size)).copy()
    jargs = (jnp.asarray(qpad), jnp.asarray(desc), jnp.asarray(jemb), jnp.asarray(ids8))
    jkw = dict(k=5, metric=metric, block=32,
               sq_norms=None if jsqn is None else jnp.asarray(jsqn),
               scales=None if jscl is None else jnp.asarray(jscl))
    for ref in (jpi.ivf_topk_pallas(*jargs, interpret=True, **jkw), jpi.ivf_topk_xla(*jargs, **jkw)):
        assert_same_topk(got_v.numpy(), got_i.numpy(), np.asarray(ref[0]), np.asarray(ref[1]))
    np.testing.assert_array_equal(ivf_topk(torch.from_numpy(qpad), torch.from_numpy(desc), emb,
                                           ids, k=5, metric=metric, block=32, sq_norms=sqn,
                                           scales=scl)[1].numpy(), got_i.numpy())


def test_all_hole_tile_and_short_candidates():
    """A tile whose descriptors are all holes returns (-inf, -1) rows; a
    tile with fewer real candidates than k fills its tail with -1."""
    rng = np.random.default_rng(12)
    block = 32
    emb = np.zeros((2 * block, 64), np.float32)
    emb[:3] = rng.normal(size=(3, 64))
    ids = np.full((2 * block,), -1, np.int32)
    ids[:3] = [7, 8, 9]
    q = rng.normal(size=(16, 64)).astype(np.float32)
    desc = np.array([[0, 1], [1, 1]], np.int32)
    v, i = ivf_topk_plain(torch.from_numpy(q), torch.from_numpy(desc), torch.from_numpy(emb),
                          torch.from_numpy(ids), k=5, metric="ip", block=block)
    v, i = v.numpy(), i.numpy()
    jv, ji = jpi.ivf_topk_pallas(
        jnp.asarray(q), jnp.asarray(desc), jnp.asarray(emb),
        jnp.asarray(np.broadcast_to(ids[None], (8, 2 * block)).copy()),
        k=5, metric="ip", block=block, interpret=True)
    assert_same_topk(v, i, np.asarray(jv), np.asarray(ji))
    assert (np.sort(i[:8, :3], axis=1) == [7, 8, 9]).all()
    assert (i[:8, 3:] == -1).all() and np.isneginf(v[:8, 3:]).all()
    assert (i[8:] == -1).all() and np.isneginf(v[8:]).all()
    with pytest.raises(ValueError, match="descriptors"):
        ivf_topk_plain(torch.from_numpy(q), torch.from_numpy(desc + 1), torch.from_numpy(emb),
                       torch.from_numpy(ids), k=5, metric="ip", block=block)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_ivf_engine_matches_jax_across_files(tmp_path, built, metric, dt):
    """Each package searches the index files the other saved."""
    j, t = built[metric]
    q = built["q"]
    j.save(tmp_path / "jax" / "ivf")
    t.save(tmp_path / "torch" / "ivf")
    jeng = jivf.IVFEngine(jivf.IVFDenseIndex.load(tmp_path / "torch" / "ivf"), nprobe=4,
                          store_dtype=JDT[dt], force_kernel=True)
    teng = tivf.IVFEngine(tivf.IVFDenseIndex.load(tmp_path / "jax" / "ivf"), nprobe=4,
                          store_dtype=TDT[dt], device="cpu")
    ref, got = jeng.search_embeddings(q, k=5), teng.search_embeddings(q, k=5)
    assert_same_topk(got.scores, got.doc_indices, ref.scores, ref.doc_indices)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(5)
    pts, _ = clustered(rng, n_clusters=128, per=8, d=16)
    q = rng.normal(size=(11, 16)).astype(np.float32) * 2.0
    return (q, jivf.IVFDenseIndex.build(pts, nlist=128, block=8, metric="l2", seed=0),
            tivf.IVFDenseIndex.build(pts, nlist=128, block=8, metric="l2", seed=0,
                                     device="cpu"))


@pytest.mark.parametrize("nprobe", [64, 128])
def test_wide_nprobe_matches_jax(wide, nprobe):
    """nprobe above 32 (common faiss settings): the coarse probe, the plan
    and the search equal the JAX package's."""
    q, j, t = wide
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5, atol=1e-5)
    jeng = jivf.IVFEngine(j, nprobe=nprobe, store_dtype=jnp.float32)
    teng = tivf.IVFEngine(t, nprobe=nprobe, store_dtype=torch.float32, device="cpu")
    probes = teng.probe_cells(q)
    assert probes.shape == (11, nprobe)
    np.testing.assert_array_equal(probes, jeng.probe_cells(q))
    np.testing.assert_array_equal(teng.plan(probes), jeng.plan(probes))
    ref, got = jeng.search_embeddings(q, k=5), teng.search_embeddings(q, k=5)
    assert_same_topk(got.scores, got.doc_indices, ref.scores, ref.doc_indices)


@pytest.mark.parametrize("nprobe", [300, 512, 1000])
def test_probe_above_256_matches_jax(nprobe):
    """Probes wider than ``dense_topk``'s 256-long lists (a full score row
    and a stable sort) give the JAX ``probe_cells_host``'s cells, up to
    nprobe = nlist."""
    rng = np.random.default_rng(8)
    nlist = 1000
    cent = rng.normal(size=(nlist, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    tcent = torch.from_numpy(cent)
    got = tivf.probe_cells_host(q, tcent, (tcent * tcent).sum(-1), nprobe, nlist)
    want = jivf.probe_cells_host(q, jnp.asarray(cent), nprobe, "l2", nlist)
    assert got.shape == (9, nprobe) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_full_probe_equals_flat_bruteforce(built):
    """Probing every cell of an f32 store gives the exact flat answer."""
    _, t = built["l2"]
    pts, q = built["pts"], built["q"]
    res = tivf.IVFEngine(t, nprobe=16, store_dtype=torch.float32,
                         device="cpu").search_embeddings(q, k=7)
    d = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    np.testing.assert_allclose(res.scores, np.sort(d, axis=1)[:, :7], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(res.doc_indices, np.argsort(d, axis=1)[:, :7])
