"""The port's parallel package (probing_rag_tpu_torch.parallel) and the TP
forward and decode against the JAX package, with the ranks as processes
over gloo on the CPU (``run_ranks``), S = 4 (mesh (2, 2)) and S = 2 (mesh
(1, 2)).

Each mesh runs once (a module fixture spawning its ranks, which return
their results); the JAX references run in this process on the virtual
8-device mesh of conftest.py. Spawned ranks re-import this module, so it
imports nothing of JAX at its top: JAX and the JAX package are imported
inside the fixtures and tests.

Tolerances: BM25 scores within rel 1e-5 / abs 1e-6 of the JAX engines
(f32 run sums in another order), ids compared through the exact oracle's
scores (ties order freely); dense and IVF scores rel 1e-4 / abs 1e-5 (f32
matmuls, another summation order), ids equal (the fixtures' top-k hold no
ties); the TP forward's logits and captures within 1e-4 of JAX's
unsharded forward (f32 partial sums all-reduced in another order; JAX's
own test's bound); TP decode tokens and lengths equal, pooled captures
within 5e-2 (JAX's test's bound: an int8 or int4 KV cache rounds its
values)."""

import dataclasses

import numpy as np
import pytest
import torch

from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.decode import generate
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.ops.dense import dense_topk, prepare_dense_store
from probing_rag_tpu_torch.parallel import mesh as pmesh
from probing_rag_tpu_torch.parallel.mesh import (
    lm_param_shardings,
    make_mesh,
    mesh_shard,
    merge_shard_topk,
    run_ranks,
    shard_lm_params,
)
from probing_rag_tpu_torch.parallel.sharded_bm25 import ShardedBM25Engine, shard_index_by_docs
from probing_rag_tpu_torch.parallel.sharded_dense import shard_rows, sharded_dense_topk
from probing_rag_tpu_torch.parallel.sharded_ivf import (
    ShardedIVFEngine,
    shard_blocks,
    shard_ivf_layout,
)
from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine, trim_to_cap
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config, BM25Index
from probing_rag_tpu_torch.retrieval.ivf import IVFDenseIndex, IVFEngine
from probing_rag_tpu_torch.weights import lm_params_from_jax

torch.set_num_threads(1)

PLAIN = dict(stem=False, remove_stopwords=False)
TCFG = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)
# grouped-query attention (2 kv heads for 4 query heads) and an untied head
TCFG_MISTRAL = dataclasses.replace(tg.GemmaConfig.tiny_mistral(), compute_dtype=torch.float32)
PROMPTS = ["alpha beta", "another prompt"]
KV_MODES = ("bf16", "int8", "int4")
DENSE_TOL = dict(rtol=1e-4, atol=1e-5)


def corpus():
    """The 200-doc fixture of tests/test_sharding.py."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(150)]
    return [" ".join(rng.choice(vocab, size=rng.integers(5, 30))) for _ in range(200)]


def bm25_queries():
    """(name -> (queries, engine kwargs)): the random 3-term batch, the
    bitonic path's own cases, duplicate terms, and over-cap batches."""
    docs = corpus()
    index = BM25Index.build(docs, BM25Config(**PLAIN))
    rng = np.random.default_rng(1)
    rand = [" ".join(rng.choice([f"w{i}" for i in range(150)], size=3)) for _ in range(16)]
    lens = index.term_offsets[1:] - index.term_offsets[:-1]
    order = np.argsort(lens)
    heavy = " ".join(f"w{i}" for i in order[-6:])
    light = " ".join(f"w{i}" for i in order[: len(order) // 2][-2:])
    dups = ["w1 w1 w1 w2", "w3 w3 " + docs[5], "w2 w2 w2 w2 w2"]
    mixed = rand + [docs[3], docs[77] + " w3 w5", "w1 w2 w3", "zzz-oov"] + dups
    return {
        "bitonic": (mixed, {}),
        "overcap": ([heavy, light, "w1 w2", docs[5]] + dups, dict(max_pad=8)),
        "overcap_1024": ([heavy, "w1 w2", docs[5]], dict(max_pad=1024)),
        "dma": (mixed, dict(mode="dma")),
    }


# dma's trim: a cap of two aligned blocks keeps the most selective terms
DMA_TRIM_CAP = 2048
DMA_TRIM_QUERIES = [" ".join(f"w{i}" for i in range(j, 150, 23)) for j in range(6)]


def dense_data():
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(333, 32)).astype(np.float32)  # uneven over 2 and 4 shards
    q = rng.normal(size=(6, 32)).astype(np.float32)
    rng = np.random.default_rng(11)
    neg_emb = np.abs(rng.normal(size=(13, 16))).astype(np.float32)
    neg_q = -np.abs(rng.normal(size=(3, 16))).astype(np.float32)  # every q . emb < 0
    return emb, q, neg_emb, neg_q


def few_rows():
    """5 rows, k 4: with 2 or 4 shards each holds fewer rows than k."""
    rng = np.random.default_rng(12)
    return rng.normal(size=(5, 16)).astype(np.float32), rng.normal(size=(3, 16)).astype(np.float32)


def ivf_data():
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(16, 24)).astype(np.float32) * 3.0
    emb = (centers[rng.integers(0, 16, size=500)] + 0.1 * rng.normal(size=(500, 24))).astype(np.float32)
    q = rng.normal(size=(11, 24)).astype(np.float32)  # not a multiple of the 8-query tile
    return emb, q


def ivf_arrays(index: IVFDenseIndex):
    return (index.centroids, index.emb_blocked, index.ids_blocked, index.list_block_start,
            index.list_nblocks, index.metric, index.block, index.n_docs)


def tcfg(name: str, a8: int = 0):
    """The port's config of the LM tree ``name`` (lm_trees)."""
    return dataclasses.replace(TCFG_MISTRAL if name == "mistral" else TCFG, act_int8_rows=a8)


def forward_tokens():
    return np.random.default_rng(1).integers(0, TCFG.vocab_size, (4, 8))


def _no_max(x, group=None):
    """``_quant_acts`` without the MAX all-reduce (each rank quantizes with
    its own half-row's max): the failure the all-reduce prevents."""
    return _QUANT_ACTS(x)


_QUANT_ACTS = tg._quant_acts


def retrieval_rank(rank, world, dev, shape, ivf_indexes):
    mesh = make_mesh(shape, "cpu")
    shard, n_shards = mesh_shard(mesh)
    out = {"shard": shard, "default_mesh": tuple(make_mesh(None, "cpu").mesh.shape)}
    index = BM25Index.build(corpus(), BM25Config(**PLAIN))
    for name, (queries, kw) in bm25_queries().items():
        eng = ShardedBM25Engine(index, mesh, device=dev, **kw)
        res = eng.search(queries, k=5)
        out[name] = (res.doc_indices, res.scores, dict(eng.last_stats))
    eng = ShardedBM25Engine(index, mesh, device=dev, mode="dma", max_pad=DMA_TRIM_CAP)
    res = eng.search(DMA_TRIM_QUERIES, k=5)
    out["dma_trim"] = (res.doc_indices, res.scores, dict(eng.last_stats), eng._term_lens)

    emb, q, neg_emb, neg_q = dense_data()
    few_emb, few_q = few_rows()
    for name, e, qq, metric, k, dtype in (("ip", emb, q, "ip", 4, None), ("l2", emb, q, "l2", 4, None),
                                          ("neg", neg_emb, neg_q, "ip", 3, None),
                                          ("int8", emb, q, "ip", 4, torch.int8),
                                          ("few", few_emb, few_q, "l2", 4, None)):
        offs, counts = shard_rows(e.shape[0], n_shards)
        rows = torch.from_numpy(e[offs[shard]: offs[shard] + counts[shard]])
        store = prepare_dense_store(rows, metric=metric, store_dtype=dtype)
        v, i = sharded_dense_topk(torch.from_numpy(qq), store, k=k, offset=int(offs[shard]),
                                  metric=metric)
        out["dense", name] = (v.numpy(), i.numpy())

    _, q_ivf = ivf_data()
    for metric, arrays in ivf_indexes.items():
        eng = ShardedIVFEngine(IVFDenseIndex(*arrays), mesh, nprobe=5, device=dev,
                               store_dtype=torch.float32)
        res = eng.search_embeddings(q_ivf, k=4)
        out["ivf", metric] = (res.doc_indices, res.scores, eng.plan(eng.probe_cells(q_ivf)))
    return out


def lm_rank(rank, world, dev, shape, trees, decode):
    """The TP forward of each tree (dp rows split over the mesh's dp dim),
    and with ``decode`` the TP generate in each KV mode and the w8a8
    forward without its MAX all-reduce."""
    mesh = make_mesh(shape, "cpu")
    group = mesh.get_group("tp")
    dp, n_dp = mesh.get_local_rank("dp"), mesh["dp"].size()
    tokens = torch.from_numpy(forward_tokens()).chunk(n_dp)[dp]
    capture = tg.CaptureSpec.for_probing(TCFG)
    out = {}
    for name, (tree, a8) in trees.items():
        cfg = tcfg(name, a8)
        params = shard_lm_params(lm_params_from_jax(tree, cfg, device=dev), mesh)
        logits, _, caps = tg.forward(params, tokens, cfg, capture=capture, tp=group)
        out[name] = (logits.numpy(), caps.numpy())
        if decode and name == "w8a8":
            tg._quant_acts = _no_max
            try:
                out["w8a8_no_max"] = tg.forward(params, tokens, cfg, tp=group)[0].numpy()
            finally:
                tg._quant_acts = _QUANT_ACTS
    if decode:
        params = shard_lm_params(lm_params_from_jax(trees["f32"][0], TCFG, device=dev), mesh)
        for kv in KV_MODES:
            texts, res = generate(params, TCFG, ByteTokenizer(TCFG.vocab_size), PROMPTS,
                                  max_new_tokens=8, capture=capture, kv_int8=kv == "int8",
                                  kv_int4=kv == "int4", tp=group)
            out["decode", kv] = (texts, res.tokens, res.n_generated, res.pooled_captures)
    return out


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def jax_env(eight_devices):
    import jax
    import jax.numpy as jnp

    from probing_rag_tpu.models import gemma as jg
    from probing_rag_tpu.parallel import mesh as jmesh

    return jax, jnp, jg, jmesh, eight_devices


@pytest.fixture(scope="module")
def ivf_indexes():
    emb, _ = ivf_data()
    return {m: ivf_arrays(IVFDenseIndex.build(emb, nlist=16, block=32, metric=m, seed=0,
                                              device="cpu"))
            for m in ("ip", "l2")}


@pytest.fixture(scope="module")
def lm_trees(jax_env):
    """numpy trees in the JAX layout: f32, and quantized by the JAX
    quantizer (int8, rank-1 and grouped int4, int8 with w8a8)."""
    jax, jnp, jg, _, _ = jax_env
    from test_torch_gemma import numpy_params, to_jax

    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
    tree = numpy_params(jcfg, seed=0)

    def quant(**kw):
        return jax.tree_util.tree_map(np.asarray, jg.quantize_lm_params(to_jax(tree), **kw))

    int8 = quant(bits=8)
    mistral = dataclasses.replace(jg.GemmaConfig.tiny_mistral(), compute_dtype=jnp.float32)
    return {"f32": (tree, 0), "int8": (int8, 0),
            "rank1": (quant(bits=4, group_size=16, int4_scheme="rank1"), 0),
            "grouped": (quant(bits=4, group_size=16), 0), "w8a8": (int8, 1),
            "mistral": (numpy_params(mistral, seed=0), 0)}


@pytest.fixture(scope="module")
def ranks4(ivf_indexes, lm_trees):
    """Four ranks, mesh (2, 2): retrieval over 4 shards, the TP forward at
    (dp 2, tp 2)."""
    return run_ranks(_both, 4, "gloo", "cpu", (2, 2), ivf_indexes, lm_trees, False)


@pytest.fixture(scope="module")
def ranks2(ivf_indexes, lm_trees):
    """Two ranks, mesh (1, 2): retrieval over 2 shards, the TP forward and
    decode at tp 2."""
    return run_ranks(_both, 2, "gloo", "cpu", (1, 2), ivf_indexes, lm_trees, True)


def _both(rank, world, dev, shape, ivf_indexes, trees, decode):
    return {**retrieval_rank(rank, world, dev, shape, ivf_indexes),
            "lm": lm_rank(rank, world, dev, shape, trees, decode)}


@pytest.fixture(params=[4, 2], ids=["S4", "S2"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


# ---------------------------------------------------------------- host-side


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_index_by_docs_equals_jax(n_shards):
    from probing_rag_tpu.parallel.sharded_bm25 import shard_index_by_docs as jshard
    from probing_rag_tpu.retrieval.bm25_index import BM25Config as JCfg
    from probing_rag_tpu.retrieval.bm25_index import BM25Index as JIndex

    got = shard_index_by_docs(BM25Index.build(corpus(), BM25Config(**PLAIN)), n_shards)
    want = jshard(JIndex.build(corpus(), JCfg(**PLAIN)), n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_ivf_layout_equals_jax(ivf_indexes, n_shards):
    from probing_rag_tpu.parallel.sharded_ivf import shard_ivf_layout as jlayout
    from probing_rag_tpu.retrieval.ivf import IVFDenseIndex as JIVF

    index = IVFDenseIndex(*ivf_indexes["ip"])
    lay = shard_ivf_layout(index, n_shards)
    want = jlayout(JIVF(*ivf_indexes["ip"]), n_shards)
    np.testing.assert_array_equal(lay.owner, want.owner)
    np.testing.assert_array_equal(lay.local_start, want.local_start)
    assert lay.nb_max == want.nb_max
    blocks = [shard_blocks(index, lay, s) for s in range(n_shards)]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in blocks]), want.emb)
    np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks]), want.ids)
    assert sorted(want.ids[want.ids >= 0].tolist()) == list(range(index.n_docs))


def test_lm_param_shardings_equal_jax(jax_env, lm_trees):
    jax, jnp, jg, jmesh, devices = jax_env
    from test_torch_gemma import to_jax

    mesh = jmesh.make_mesh((2, 4), devices)
    for name, (tree, _) in lm_trees.items():
        want = jmesh.lm_param_shardings(to_jax(tree), mesh)
        got = lm_param_shardings(tree, 4)
        flat_w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: hasattr(x, "spec"))
        for path, sharding in flat_w:
            node = got
            for key in path:
                node = node[key.key]
            spec = tuple(sharding.spec) + (None,) * 8
            expect = next((i for i, a in enumerate(spec) if a == "tp"), None)
            assert node == expect, (name, path, node, sharding.spec)


def test_make_mesh_default_shape_equals_jax(jax_env, ranks):
    """With no shape, tp is the largest power of two up to min(4, n // 2)
    dividing n (JAX mesh.py:37-41)."""
    _, _, _, jmesh, devices = jax_env
    n = len(ranks)
    assert {r["default_mesh"] for r in ranks} == {jmesh.make_mesh(None, devices[:n]).devices.shape}


def test_shard_lm_params_refuses_a_group_across_shards():
    class Mesh:  # the two calls shard_lm_params makes
        def __getitem__(self, name):
            return self

        def size(self):
            return 4

        def get_local_rank(self, name):
            return 0

    cfg = dataclasses.replace(TCFG, d_model=48, d_ff=96, n_heads=2, head_dim=24)
    params = tg.quantize_lm_params(tg.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                   bits=4, group_size=16, int4_scheme="rank1")
    # wo's 48 rows split 12 a shard: its 3 groups of 16 cannot follow
    with pytest.raises(ValueError, match="group size"):
        shard_lm_params(params, Mesh())


def test_run_ranks_takes_the_backend_explicitly():
    with pytest.raises(ValueError, match="backend"):
        run_ranks(_both, 2, "mpi", "cpu")
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(_both, 2, "nccl", "cuda:0")
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(_both, 2, "nccl", "cpu")


def test_merge_shard_topk_is_the_jax_merge():
    """One rank (gloo world of 1): pad slots lose to every hit, rows with
    no hit are 0 / -1, equal scores keep the lower slot (jax.lax.top_k)."""
    assert pmesh.merge_shard_topk is merge_shard_topk
    out = run_ranks(_merge_rank, 1, "gloo", "cpu")[0]
    np.testing.assert_array_equal(out[1], [[7, 3, -1], [-1, -1, -1], [5, 6, 4]])
    np.testing.assert_array_equal(out[0], [[-1.0, -2.0, 0.0], [0.0, 0.0, 0.0], [2.0, 2.0, 1.0]])


def _merge_rank(rank, world, dev):
    s = torch.tensor([[-1.0, 9.0, -2.0], [5.0, 1.0, 0.0], [1.0, 2.0, 2.0]])
    i = torch.tensor([[7, -1, 3], [-1, -1, -1], [4, 5, 6]], dtype=torch.int32)
    v, ids = merge_shard_topk(s, i, 3)
    return v.numpy(), ids.numpy()


# ---------------------------------------------------------------- retrieval


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(first, r[key]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    return first


def _assert_bm25(index, queries, got, want_scores, want_ids):
    """Scores equal; ids through the oracle's scores (ties order freely)."""
    ids, scores = got[0], got[1]
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-6)
    an = BM25Config(**PLAIN).analyzer()
    for qi, q in enumerate(queries):
        dense = index.score_all(index.encode_query(an(q)))
        for a, b in zip(ids[qi], want_ids[qi]):
            assert (a >= 0) == (b >= 0)
            if a >= 0:
                np.testing.assert_allclose(dense[a], dense[b], rtol=1e-5)


def test_sharded_bm25_bitonic_equals_jax(jax_env, ranks):
    """Against JAX's BM25Engine and its ShardedBM25Engine on the 8-device
    mesh (their exact CPU path), and the port's single engine."""
    _, _, _, jmesh, devices = jax_env
    from probing_rag_tpu.parallel.sharded_bm25 import ShardedBM25Engine as JSharded
    from probing_rag_tpu.retrieval.bm25 import BM25Engine as JEngine
    from probing_rag_tpu.retrieval.bm25_index import BM25Config as JCfg
    from probing_rag_tpu.retrieval.bm25_index import BM25Index as JIndex

    queries, _ = bm25_queries()["bitonic"]
    got = _same_on_every_rank(ranks, "bitonic")
    assert got[2] == {"n_queries": len(queries), "n_fallback": 0, "n_trimmed": 0}
    jindex = JIndex.build(corpus(), JCfg(**PLAIN))
    index = BM25Index.build(corpus(), BM25Config(**PLAIN))
    for ref in (JEngine(jindex).search(queries, k=5),
                JSharded(jindex, jmesh.make_mesh((4, 2), devices)).search(queries, k=5),
                BM25Engine(index, device="cpu").search(queries, k=5)):
        _assert_bm25(index, queries, got, ref.scores, ref.doc_indices)


@pytest.mark.parametrize("case", ["overcap", "overcap_1024"])
def test_sharded_bm25_overcap_hybrid_equals_jax(jax_env, ranks, case):
    """Rows over max_pad on the worst shard take the sharded over-cap
    hybrid (duplicate terms too): equal to JAX's exact engine, the port's
    single engine and the per-occurrence oracle."""
    from probing_rag_tpu.retrieval.bm25 import BM25Engine as JEngine
    from probing_rag_tpu.retrieval.bm25_index import BM25Config as JCfg
    from probing_rag_tpu.retrieval.bm25_index import BM25Index as JIndex

    queries, kw = bm25_queries()[case]
    got = _same_on_every_rank(ranks, case)
    assert got[2]["n_fallback"] >= (len(queries) if case == "overcap" else 1)
    assert got[2]["n_trimmed"] == 0
    index = BM25Index.build(corpus(), BM25Config(**PLAIN))
    ref = JEngine(JIndex.build(corpus(), JCfg(**PLAIN))).search(queries, k=5)
    _assert_bm25(index, queries, got, ref.scores, ref.doc_indices)
    single = BM25Engine(index, device="cpu", max_pad=kw["max_pad"]).search(queries, k=5)
    _assert_bm25(index, queries, got, single.scores, single.doc_indices)


def test_sharded_bm25_dma_equals_jax(jax_env, ranks):
    from probing_rag_tpu.retrieval.bm25 import BM25Engine as JEngine
    from probing_rag_tpu.retrieval.bm25_index import BM25Config as JCfg
    from probing_rag_tpu.retrieval.bm25_index import BM25Index as JIndex

    queries, _ = bm25_queries()["dma"]
    got = _same_on_every_rank(ranks, "dma")
    assert got[2] == {"n_queries": len(queries), "n_fallback": 0, "n_trimmed": 0}
    ref = JEngine(JIndex.build(corpus(), JCfg(**PLAIN))).search(queries, k=5)
    _assert_bm25(BM25Index.build(corpus(), BM25Config(**PLAIN)), queries, got, ref.scores,
                 ref.doc_indices)


def test_sharded_bm25_dma_trim_keeps_one_term_set(ranks):
    """Rows over the dma cap keep ONE most-selective term set (trimmed
    against the worst shard's aligned lengths, the same table on every
    rank) and match the exact oracle on it (JAX test_sharding.py:623-652)."""
    ids, scores, stats, term_lens = _same_on_every_rank(ranks, "dma_trim")
    assert stats["n_trimmed"] == len(DMA_TRIM_QUERIES)
    index = BM25Index.build(corpus(), BM25Config(**PLAIN))
    lens = index.term_offsets[1:] - index.term_offsets[:-1]
    n_shards = len(ranks)
    per_shard = np.stack([(o[1:] - o[:-1]) for o in shard_index_by_docs(index, n_shards)[0]])
    np.testing.assert_array_equal(term_lens, (-(-per_shard // 1024) * 1024).max(0))
    an = BM25Config(**PLAIN).analyzer()
    for i, q in enumerate(DMA_TRIM_QUERIES):
        full = np.asarray(index.encode_query(an(q)), np.int64)
        kept, _, _, trimmed = trim_to_cap(term_lens, full, DMA_TRIM_CAP)
        assert trimmed and 0 < len(kept) < len(full)
        assert lens[kept].sum() > 0
        oracle = index.score_all(kept)
        got = scores[i][ids[i] >= 0]
        np.testing.assert_allclose(np.sort(got)[::-1], np.sort(oracle)[::-1][: len(got)],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(oracle[ids[i][ids[i] >= 0]], got, rtol=1e-4, atol=1e-5)


def test_sharded_bm25_refuses_xla_mode():
    with pytest.raises(ValueError, match="xla"):
        ShardedBM25Engine(BM25Index.build(corpus(), BM25Config(**PLAIN)), None, mode="xla")


@pytest.mark.parametrize("name", ["ip", "l2", "neg"])
def test_sharded_dense_equals_jax(jax_env, ranks, name):
    """333 rows split unevenly (and the all-negative-score case of JAX
    test_sharding.py:114-133): equal to JAX's sharded_dense_topk."""
    _, jnp, _, jmesh, devices = jax_env
    from probing_rag_tpu.parallel.sharded_dense import sharded_dense_topk as jsharded

    emb, q, neg_emb, neg_q = dense_data()
    e, qq, metric, k = (neg_emb, neg_q, "ip", 3) if name == "neg" else (emb, q, name, 4)
    v, i = _same_on_every_rank(ranks, ("dense", name))
    jv, ji = jsharded(jnp.asarray(qq), jnp.asarray(e), mesh=jmesh.make_mesh((4, 2), devices),
                      k=k, metric=metric, tile_n=128)
    np.testing.assert_allclose(v, np.asarray(jv), **DENSE_TOL)
    np.testing.assert_array_equal(i, np.asarray(ji))
    ref_v, ref_i = dense_topk(torch.from_numpy(qq), torch.from_numpy(e), k=k, metric=metric,
                              sq_norms=(torch.from_numpy(e) ** 2).sum(-1) if metric == "l2" else None)
    np.testing.assert_array_equal(i, ref_i.numpy())
    np.testing.assert_allclose(v, ref_v.numpy(), **DENSE_TOL)


def test_sharded_dense_shards_with_fewer_rows_than_k(ranks):
    """Shards holding fewer rows than k pad their lists with empty slots
    (-1), which the merge ranks below every real row."""
    e, q = few_rows()
    v, i = _same_on_every_rank(ranks, ("dense", "few"))
    rv, ri = dense_topk(torch.from_numpy(q), torch.from_numpy(e), k=4, metric="l2",
                        sq_norms=(torch.from_numpy(e) ** 2).sum(-1))
    np.testing.assert_array_equal(i, ri.numpy())
    np.testing.assert_allclose(v, rv.numpy(), **DENSE_TOL)
    assert (i >= 0).all()


def test_sharded_dense_int8_equals_single_store(ranks):
    """An int8 store carries its per-row scales: every shard ranks its
    rows with them, equal to the single int8 store."""
    emb, q, _, _ = dense_data()
    v, i = _same_on_every_rank(ranks, ("dense", "int8"))
    store = prepare_dense_store(torch.from_numpy(emb), store_dtype=torch.int8)
    rv, ri = dense_topk(torch.from_numpy(q), store.embeddings, k=4, scales=store.scales)
    np.testing.assert_array_equal(i, ri.numpy())
    np.testing.assert_allclose(v, rv.numpy(), **DENSE_TOL)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_ivf_equals_single_engine_and_jax_plan(jax_env, ranks, ivf_indexes, metric):
    _, jnp, _, jmesh, devices = jax_env
    from probing_rag_tpu.parallel.sharded_ivf import ShardedIVFEngine as JSharded
    from probing_rag_tpu.retrieval.ivf import IVFDenseIndex as JIVF

    emb, q = ivf_data()
    ids, scores, plan = _same_on_every_rank(ranks, ("ivf", metric))
    index = IVFDenseIndex(*ivf_indexes[metric])
    ref = IVFEngine(index, nprobe=5, device="cpu", store_dtype=torch.float32).search_embeddings(q, k=4)
    np.testing.assert_allclose(scores, ref.scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ids, ref.doc_indices)
    n = len(ranks)
    jeng = JSharded(JIVF(*ivf_indexes[metric]), jmesh.make_mesh((n // 2, 2), devices[:n]),
                    nprobe=5, store_dtype=jnp.float32)
    np.testing.assert_array_equal(plan, jeng.plan(jeng.probe_cells(q)))


# ----------------------------------------------------------------------- LM


def _jax_forward(jax_env, name, tree, a8, tokens):
    _, jnp, jg, _, _ = jax_env
    from test_torch_gemma import to_jax

    base = jg.GemmaConfig.tiny_mistral() if name == "mistral" else jg.GemmaConfig.tiny()
    jcfg = dataclasses.replace(base, compute_dtype=jnp.float32, act_int8_rows=a8)
    logits, _, caps = jg.forward(to_jax(tree), jnp.asarray(tokens), jcfg,
                                 capture=jg.CaptureSpec.for_probing(jcfg))
    return np.asarray(logits), np.asarray(caps)


def _tp_rows(ranks, name):
    """The full batch from the ranks' dp slices (rank r*tp holds dp row r),
    after checking the tp ranks agree."""
    n_dp = 2 if len(ranks) == 4 else 1
    tp = len(ranks) // n_dp
    for r in range(len(ranks)):
        lead = ranks[(r // tp) * tp]["lm"][name]
        for a, b in zip(lead, ranks[r]["lm"][name]):
            np.testing.assert_array_equal(a, b)
    logits = np.concatenate([ranks[d * tp]["lm"][name][0] for d in range(n_dp)])
    caps = np.concatenate([ranks[d * tp]["lm"][name][1] for d in range(n_dp)], axis=1)
    return logits, caps


@pytest.mark.parametrize("name", ["f32", "int8", "rank1", "grouped", "mistral"])
def test_tp_forward_equals_jax_unsharded(jax_env, ranks, lm_trees, name):
    """Gemma's tiny config (MQA, tied head) plain and quantized, and the
    tiny Mistral (grouped-query: each rank attends with its query heads'
    kv heads; the untied head split by vocab)."""
    logits, caps = _tp_rows(ranks, name)
    tree, a8 = lm_trees[name]
    ref_logits, ref_caps = _jax_forward(jax_env, name, tree, a8, forward_tokens())
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(caps, ref_caps, rtol=1e-4, atol=1e-4)


def test_tp_w8a8_takes_the_unsharded_scale(jax_env, ranks, lm_trees):
    """w8a8 under TP: the row max of a row-split product's activations is
    all-reduced (MAX), so the TP forward equals the port's unsharded w8a8
    forward; it also holds JAX's drift bound against JAX's unsharded w8a8
    (test_sharding.py:206-236)."""
    logits, _ = _tp_rows(ranks, "w8a8")
    tree, a8 = lm_trees["w8a8"]
    cfg = dataclasses.replace(TCFG, act_int8_rows=a8)
    ref = tg.forward(lm_params_from_jax(tree, cfg, device="cpu"),
                     torch.from_numpy(forward_tokens()), cfg)[0].numpy()
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-4)
    jref, _ = _jax_forward(jax_env, "w8a8", tree, a8, forward_tokens())
    spread = jref.std()
    assert np.sqrt(((logits - jref) ** 2).mean()) < 0.01 * spread
    assert np.abs(logits - jref).max() < 0.15 * spread


def test_tp_w8a8_without_the_max_all_reduce_differs(ranks2, lm_trees):
    """The same forward with each rank quantizing by its own half-row's
    max: another scale, other int8 values, logits off by far more than the
    tolerance the MAX all-reduce meets."""
    no_max = ranks2[0]["lm"]["w8a8_no_max"]
    tree, a8 = lm_trees["w8a8"]
    cfg = dataclasses.replace(TCFG, act_int8_rows=a8)
    ref = tg.forward(lm_params_from_jax(tree, cfg, device="cpu"),
                     torch.from_numpy(forward_tokens()), cfg)[0].numpy()
    assert np.abs(no_max - ref).max() > 1e-2


@pytest.mark.parametrize("kv", KV_MODES)
def test_tp_decode_equals_jax_unsharded(jax_env, ranks2, lm_trees, kv):
    """TP generate (tp 2, eager: the CPU never graphs) gives JAX's
    unsharded generate's texts, tokens and lengths; pooled captures within
    5e-2 (JAX test_sharding.py:551-587)."""
    _, jnp, jg, _, _ = jax_env
    from probing_rag_tpu.models.decode import generate as jgenerate
    from probing_rag_tpu.models.tokenizer import ByteTokenizer as JTok
    from test_torch_gemma import to_jax

    texts, tokens, n_gen, pooled = ranks2[0]["lm"]["decode", kv]
    for r in ranks2[1:]:
        assert r["lm"]["decode", kv][0] == texts
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
    jtexts, jres = jgenerate(to_jax(lm_trees["f32"][0]), jcfg, JTok(jcfg.vocab_size), PROMPTS,
                             max_new_tokens=8, capture=jg.CaptureSpec.for_probing(jcfg),
                             kv_int8=kv == "int8", kv_int4=kv == "int4")
    assert texts == jtexts
    np.testing.assert_array_equal(tokens, np.asarray(jres.tokens))
    np.testing.assert_array_equal(n_gen, np.asarray(jres.n_generated))
    np.testing.assert_allclose(pooled, np.asarray(jres.pooled_captures), rtol=5e-2, atol=5e-2)


def test_graphed_tp_decode_over_gloo_raises():
    """A CUDA graph cannot capture gloo collectives: the graphed step over
    a gloo group raises instead of running eagerly behind the caller's back."""
    out = run_ranks(_graphed_gloo_rank, 1, "gloo", "cpu")[0]
    assert "eager=True" in out


def _graphed_gloo_rank(rank, world, dev):
    from probing_rag_tpu_torch.models import decode as td

    group = torch.distributed.new_group([0])
    try:
        td._decode_loop({}, 1, 1, cfg=TCFG, capture=tg.CaptureSpec(), max_new_tokens=2,
                        eos_id=1, sampling=td.SamplingConfig(), kv_dtype=torch.float32,
                        device=torch.device("cuda"), eager=False, tp=group)
    except ValueError as e:
        return str(e)
    return "no error"
