"""The port's flat dense search (``ops/dense.py``, ``retrieval/dense.py``)
against the JAX package: ``dense_topk_plain`` against ``dense_topk_pallas``
in interpret mode and against ``matmul_topk``; ``prepare_dense_store``;
``dense_topk_rerank``; ``DenseEngine`` and its index files, saved by one
package and loaded by the other.

Inputs are numpy draws from a seed, handed to both sides. Scores are f32
sums of the same exact products (bf16 x bf16 and int8-as-bf16 products are
exact in f32), taken in another order: rtol 1e-5, atol 1e-4 on scores of
magnitude up to ~150 (l2 at D = 64). The seeds give top-k lists with no
ties, so ids must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.ops import pallas_dense as jpd
from probing_rag_tpu.ops.dense_topk import matmul_topk
from probing_rag_tpu.retrieval import dense as jdense
from probing_rag_tpu_torch.ops.dense import (
    dense_topk,
    dense_topk_plain,
    dense_topk_rerank,
    prepare_dense_store,
)
from probing_rag_tpu_torch.retrieval.dense import WINDOW_BATCHES, DenseEngine, DenseIndex

torch.set_num_threads(1)

D = 64
JDT = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def data(n, nq=9, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, D)).astype(np.float32), rng.normal(size=(nq, D)).astype(np.float32)


def jax_search(emb, q, *, k, metric, dt, k_pad=0, mxu_int8=False):
    js = jpd.prepare_dense_store(jnp.asarray(emb), tile_n=256, metric=metric, store_dtype=JDT[dt])
    v, i = jpd.dense_topk_pallas(
        jnp.asarray(q), js.embeddings, k=k, metric=metric, tile_n=256, tile_q=8,
        sq_norms=js.sq_norms, scales=js.scales, n_total=js.n_docs, k_pad=k_pad,
        mxu_int8=mxu_int8, interpret=True,
    )
    return np.asarray(v), np.asarray(i)


def port_search(emb, q, *, k, metric, dt, k_pad=0, mxu_int8=False, fn=dense_topk_plain):
    ts = prepare_dense_store(torch.from_numpy(emb), metric=metric, store_dtype=TDT[dt])
    v, i = fn(torch.from_numpy(q), ts.embeddings, k=k, metric=metric, sq_norms=ts.sq_norms,
              scales=ts.scales, n_total=ts.n_docs, k_pad=k_pad, mxu_int8=mxu_int8)
    return v.numpy(), i.numpy()


def assert_same(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,k_pad", [(700, 0), (700, 32), (3, 0)])
def test_dense_topk_plain_matches_pallas(metric, dt, n, k_pad):
    """n = 700 is a multiple of no tile; n = 3 < k leaves two empty slots
    (id -1, score -inf for ip and +inf for l2)."""
    emb, q = data(n)
    got = port_search(emb, q, k=5, metric=metric, dt=dt, k_pad=k_pad)
    ref = jax_search(emb, q, k=5, metric=metric, dt=dt, k_pad=k_pad)
    assert_same(got, ref)
    if n < 5:
        assert (got[1][:, n:] == -1).all()
        assert (got[0][:, n:] == (np.inf if metric == "l2" else -np.inf)).all()


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_topk_plain_matches_matmul_topk(metric, dt):
    emb, q = data(700, seed=1)
    jq, je = jnp.asarray(q), jnp.asarray(emb)
    if dt == "bf16":  # the wrapper's cast, done on the XLA side by hand
        jq, je = jq.astype(jnp.bfloat16), je.astype(jnp.bfloat16)
    v, i = matmul_topk(jq, je, k=5, metric=metric, tile_n=256)
    got = port_search(emb, q, k=5, metric=metric, dt=dt)
    assert_same(got, (np.asarray(v), np.asarray(i)))


@pytest.mark.parametrize("k,k_pad", [(64, 64), (100, 256)])
def test_dense_topk_plain_wide_k_matches_matmul_topk(k, k_pad):
    """Lists wider than the rerank pool's 32: the IVF coarse probe at a
    faiss nprobe of 64 to 256 (f32 centroids, l2), against matmul_topk,
    which the JAX probe uses."""
    emb, q = data(700, seed=3)
    v, i = matmul_topk(jnp.asarray(q), jnp.asarray(emb), k=k, metric="l2", tile_n=256)
    got = port_search(emb, q, k=k, metric="l2", dt="f32", k_pad=k_pad)
    assert_same(got, (np.asarray(v), np.asarray(i)))
    with pytest.raises(ValueError, match="k_pad"):
        port_search(emb, q, k=k, metric="l2", dt="f32", k_pad=257)


def test_dense_topk_wrapper_takes_plain_on_cpu():
    emb, q = data(300, seed=2)
    assert_same(port_search(emb, q, k=5, metric="l2", dt="bf16", fn=dense_topk),
                port_search(emb, q, k=5, metric="l2", dt="bf16"))


def test_mxu_int8_matches_pallas():
    """int8 x int8 sums are exact on both sides; the row scale and the
    per-document scale are the same f32 products."""
    emb, q = data(700, seed=3)
    got = port_search(emb, q, k=5, metric="ip", dt="int8", mxu_int8=True)
    ref = jax_search(emb, q, k=5, metric="ip", dt="int8", mxu_int8=True)
    assert_same(got, ref)
    with pytest.raises(ValueError, match="mxu_int8"):
        port_search(emb, q, k=5, metric="l2", dt="int8", mxu_int8=True)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_prepare_dense_store_matches_jax(metric, dt):
    emb, _ = data(300, seed=4)
    emb[7] = 0.0  # an all-zero vector takes scale 1
    js = jpd.prepare_dense_store(jnp.asarray(emb), tile_n=300, metric=metric,
                                 store_dtype=JDT[dt])
    ts = prepare_dense_store(torch.from_numpy(emb), metric=metric, store_dtype=TDT[dt])
    if dt == "int8":  # bitwise equal
        np.testing.assert_array_equal(ts.embeddings.numpy(), np.asarray(js.embeddings))
        np.testing.assert_array_equal(ts.scales.numpy(), np.asarray(js.scales)[0])
    else:
        np.testing.assert_array_equal(ts.embeddings.float().numpy(),
                                      np.asarray(js.embeddings.astype(jnp.float32)))
    if metric == "l2":
        np.testing.assert_allclose(ts.sq_norms.numpy(), np.asarray(js.sq_norms)[0], rtol=1e-6)
    else:
        assert ts.sq_norms is None


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_rerank_matches_jax(metric):
    emb, q = data(700, seed=5)
    js = jpd.prepare_dense_store(jnp.asarray(emb), tile_n=256, metric=metric, store_dtype=jnp.int8)
    jv, ji = jpd.dense_topk_rerank(
        jnp.asarray(q), js.embeddings, jnp.asarray(emb, jnp.bfloat16), k=5, metric=metric,
        tile_n=256, sq_norms=js.sq_norms, scales=js.scales, n_total=700, k_pad=32,
        interpret=True,
    )
    ts = prepare_dense_store(torch.from_numpy(emb), metric=metric, store_dtype=torch.int8)
    tv, ti = dense_topk_rerank(
        torch.from_numpy(q), ts.embeddings, torch.from_numpy(emb).to(torch.bfloat16), k=5,
        metric=metric, sq_norms=ts.sq_norms, scales=ts.scales, n_total=700, k_pad=32,
    )
    assert_same((tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji)))


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_dense_engine_matches_jax_across_files(tmp_path, metric, dt):
    """Each package searches an index saved by the other; both give the
    same results (the int8 engines re-rank by default)."""
    emb, q = data(256, nq=6, seed=6)
    jdense.DenseIndex(emb, metric=metric).save(tmp_path / "jax" / "dense")
    DenseIndex(emb, metric=metric).save(tmp_path / "torch" / "dense")
    jeng = jdense.DenseEngine(jdense.DenseIndex.load(tmp_path / "torch" / "dense"),
                              store_dtype=JDT[dt], use_pallas=True)
    teng = DenseEngine(DenseIndex.load(tmp_path / "jax" / "dense"), device="cpu",
                       store_dtype=TDT[dt])
    assert teng.index.metric == metric and teng.index.n_docs == 256
    ref, got = jeng.search_embeddings(q, k=5), teng.search_embeddings(q, k=5)
    assert_same((got.scores, got.doc_indices), (ref.scores, ref.doc_indices))


def test_dense_index_build_encodes_in_batches():
    """The build hands the encoder windows of WINDOW_BATCHES batches in
    passage order, with the batch size, and stores what comes back in
    that order."""
    calls = []

    def encode(texts, batch_size=None):
        calls.append((len(texts), batch_size))
        return np.stack([[float(t), len(calls)] for t in texts]).astype(np.float32)

    texts = [str(i) for i in range(1100)]
    ix = DenseIndex.build(texts, encode)
    assert calls == [(1100, 512)] and ix.embeddings.shape == (1100, 2) and ix.metric == "l2"
    calls.clear()
    window = WINDOW_BATCHES * 32
    ix = DenseIndex.build(texts, encode, batch_size=32)
    assert calls == [(window, 32), (window, 32), (1100 - 2 * window, 32)]
    np.testing.assert_array_equal(ix.embeddings[:, 0], np.arange(1100))
    np.testing.assert_array_equal(ix.embeddings[2 * window:, 1], 3.0)


def test_dense_topk_rejects_bad_arguments():
    emb, q = data(20, seed=7)
    store = torch.from_numpy(emb)
    with pytest.raises(ValueError, match="k_pad"):
        dense_topk(torch.from_numpy(q), store, k=300, k_pad=300)
    with pytest.raises(ValueError, match="scales"):
        dense_topk(torch.from_numpy(q), store.to(torch.int8), k=5)
    with pytest.raises(ValueError, match=r"\[Q, D\]"):
        dense_topk(torch.from_numpy(q[:, :8]), store, k=5)
