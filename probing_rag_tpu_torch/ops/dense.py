"""Flat dense search: scores of every query against every stored vector,
with a running top-k per query. A CUDA kernel and its plain PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_dense.py`` (``prepare_dense_store``,
``dense_topk_pallas``, ``dense_topk_rerank``) and of
``ops/dense_topk.py::matmul_topk``, whose contract the kernel shares.
:func:`dense_topk` launches ``kernels/csrc/dense_topk.cu`` for CUDA tensors
and takes :func:`dense_topk_plain` for CPU tensors; there is no other
switch.

Stores are ``[N, D]`` bf16, f32, or int8 with per-vector scales (SQ8).
``ip`` returns inner products, descending; ``l2`` squared distances,
ascending, ranked internally by ``2 q.d - |d|^2``. Ties rank by column
ascending. Slots with no document come back as id -1 with score -inf (ip)
or +inf (l2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from probing_rag_tpu_torch import kernels

K_PAD = 16  # running-list width when the caller names none
MAX_K_PAD = 256  # kernels/csrc/topk_merge.cuh MAX_KP (the widest nprobe)
PLAIN_TILE_N = 16384  # rows per step of the plain sweep (bounds its memory)
_MAX_PARTS = 1024  # topk_merge.cuh: partial lists per query, 32 * MERGE_LISTS
# dense_topk.cu modes: bf16 store, int8 store with bf16 queries, f32, int8 x int8
BF16, INT8_DEQ, F32, INT8_MXU = 0, 1, 2, 3
REGIMES = {"staged": 0, "wgmma": 1}
# staged: 64 queries and 64 rows per tile, about 4 blocks per SM
STAGED_QT, STAGED_TN, STAGED_BLOCKS_PER_SM = 64, 64, 4
# wgmma: 128 store rows a step, product widths 8 .. 128 (dense_topk.cu
# dw::max_width: on an H100, 256 queries ran faster as two tiles of 128
# than as one of 256), one block per SM
WGMMA_ROWS = 128
WGMMA_MAX_N = 128
STAGES = (3, 6)  # the ring's depth, fewest and most
CAPS = (64, 32, 16, 8)  # candidate buffer entries per query, widest first
SMEM_LIMIT = 232448  # the H100's opt-in shared memory per block (227 KB)


class DensePlan(NamedTuple):
    """What :func:`plan_dense` chose: the regime, ``qtiles`` query tiles of
    ``qt`` queries (grid x) scored at product width ``ntile``, the store in
    ``nchunks`` chunks of ``chunk_rows`` rows (grid y), and for wgmma the
    ring's ``stages`` of ``boxes`` depth boxes each, the candidate buffer
    ``cap``, whether the query tile is ``resident`` in shared memory, and
    the dynamic ``smem`` bytes."""

    regime: str
    qt: int
    ntile: int
    qtiles: int
    chunk_rows: int
    nchunks: int
    stages: int = 0
    boxes: int = 0
    cap: int = 0
    resident: bool = False
    smem: int = 0


def _wgmma_smem(mode: int, ntile: int, kp: int, d: int, stages: int, boxes: int, cap: int,
                resident: bool) -> int:
    """dense_topk.cu ``dw::layout(...).bytes``: the ring, the resident
    query tile, the lists, kp-th scores, counters, candidate buffers and
    barriers, plus 1 KB to align the base. A box is 128 rows by 128 bytes
    of depth (64 for int8 stores with bf16 queries)."""
    kbox = 128 if mode == INT8_MXU else 64
    nbox = -(-d // kbox)
    a_box = WGMMA_ROWS * (64 if mode == INT8_DEQ else 128)
    b_box = 0 if resident else ntile * 128
    tile = nbox * ntile * 128 if resident else 0
    return (stages * boxes * (a_box + b_box) + tile + ntile * kp * 8 + 2 * ntile * 4
            + ntile * cap * 8 + 2 * stages * 8 + 1024)


def _fit(mode: int, ntile: int, kp: int, d: int):
    """(stages, boxes, cap, resident, smem) of the best layout at width
    ``ntile``, or None. In order: the query tile resident, else streamed
    (int8 stores with bf16 queries only take it resident: its depth order
    is permuted as it is written); stages of 2 boxes (where d has 2), else
    of 1; the most
    stages (at least 4 resident with 2 boxes, 3 otherwise), then the widest
    candidate buffer."""
    lo, hi = STAGES
    nbox = -(-d // (128 if mode == INT8_MXU else 64))
    tries = [(True, 2, lo + 1), (True, 1, lo), (False, 2, lo), (False, 1, lo)]
    for resident, boxes, fewest in tries:
        if (mode == INT8_DEQ and not resident) or boxes > nbox:
            continue
        for stages in range(hi, fewest - 1, -1):
            for cap in CAPS:
                smem = _wgmma_smem(mode, ntile, kp, d, stages, boxes, cap, resident)
                if smem <= SMEM_LIMIT:
                    return stages, boxes, cap, resident, smem
    return None


def _chunks(steps: int, step_rows: int, qtiles: int, blocks: int):
    """``steps`` row steps in chunks for about ``blocks`` blocks over
    ``qtiles`` query tiles: (chunk_rows, nchunks)."""
    nchunks = max(1, min(steps, _MAX_PARTS, blocks // qtiles or 1))
    per = -(-steps // nchunks)
    return per * step_rows, -(-steps // per)


def _mode(dtype: torch.dtype, mxu_int8: bool) -> int:
    if dtype == torch.int8:
        return INT8_MXU if mxu_int8 else INT8_DEQ
    return F32 if dtype == torch.float32 else BF16


def plan_dense(nq: int, n: int, d: int, dtype: torch.dtype, kp: int, mxu_int8: bool,
               sm_count: int, ptrs) -> DensePlan:
    """The launch of ``dense_topk.cu`` for ``nq`` queries over ``n`` rows of
    depth ``d`` in a ``dtype`` store, running lists of ``kp``, on a card of
    ``sm_count`` SMs, with the operands' data pointers ``ptrs``.

    wgmma where TMA can describe the store (bf16 or int8, a pitch that is
    a multiple of 16 bytes, 16-byte aligned pointers): the widest product
    whose layout fits sets the tile count, the queries are split evenly
    over the tiles, and ``ntile`` is the smallest multiple of 8 that holds a
    tile's queries. One block per SM: the row steps are split into chunks
    so that the tiles' blocks fill the card (a whole number of waves).
    staged otherwise (f32, other pitches, unaligned pointers)."""
    mode = _mode(dtype, mxu_int8)
    pitch = d * torch.empty((), dtype=dtype).element_size()
    if mode != F32 and pitch % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        nmax = next((w for w in range(WGMMA_MAX_N, 0, -8) if _fit(mode, w, kp, d)), 0)
        if nmax:
            qtiles = -(-nq // nmax)
            qt = -(-nq // qtiles)
            ntile = -(-qt // 8) * 8
            stages, boxes, cap, resident, smem = _fit(mode, ntile, kp, d)
            waves = -(-qtiles // sm_count)
            chunk_rows, nchunks = _chunks(-(-n // WGMMA_ROWS), WGMMA_ROWS, qtiles,
                                          sm_count * waves)
            return DensePlan("wgmma", qt, ntile, qtiles, chunk_rows, nchunks, stages, boxes,
                             cap, resident, smem)
    qtiles = -(-nq // STAGED_QT)
    chunk_rows, nchunks = _chunks(-(-n // STAGED_TN), STAGED_TN, 1,
                                  -(-STAGED_BLOCKS_PER_SM * sm_count // qtiles))
    return DensePlan("staged", STAGED_QT, STAGED_QT, qtiles, chunk_rows, nchunks)


class PreparedDenseStore(NamedTuple):
    """Store from :func:`prepare_dense_store`. ``sq_norms`` (l2 only) and
    ``scales`` (int8 only) are ``[N]`` f32."""

    embeddings: torch.Tensor  # [N, D] store dtype
    sq_norms: Optional[torch.Tensor]
    scales: Optional[torch.Tensor]
    n_docs: int


def prepare_dense_store(
    embeddings: torch.Tensor,  # [N, D]
    *,
    metric: str = "ip",
    store_dtype: Optional[torch.dtype] = None,
) -> PreparedDenseStore:
    """One-time store preparation. ``store_dtype=torch.int8`` quantizes per
    vector (symmetric, scale = max|v| / 127, round half to even: the faiss
    SQ8 layout); for ``l2`` the squared norms are taken from the
    dequantized vectors, so the ranking is the quantized store's."""
    scales = None
    if store_dtype == torch.int8:
        x = embeddings.float()
        absmax = x.abs().amax(dim=-1)
        scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        embeddings = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    elif store_dtype is not None:
        embeddings = embeddings.to(store_dtype)
    sq_norms = None
    if metric == "l2":
        deq = embeddings.float() if scales is None else embeddings.float() * scales[:, None]
        sq_norms = (deq * deq).sum(dim=-1)
    return PreparedDenseStore(embeddings, sq_norms, scales, embeddings.shape[0])


def _prepare(queries, store, *, k, metric, sq_norms, scales, n_total, k_pad, mxu_int8):
    """Checks, then the queries in the sweep's dtype. Returns (cast
    queries, per-row query scale or None, n). ``k_pad`` is only checked:
    the best k of a running top-k_pad are the best k of a running top-k,
    so both sweeps keep lists of k."""
    kp = k_pad or K_PAD
    if not 1 <= k <= kp <= MAX_K_PAD:
        raise ValueError(f"need 1 <= k ({k}) <= k_pad ({kp}) <= {MAX_K_PAD}")
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if queries.dim() != 2 or store.dim() != 2 or queries.shape[1] != store.shape[1]:
        raise ValueError(f"need [Q, D] queries and an [N, D] store, got "
                         f"{tuple(queries.shape)} and {tuple(store.shape)}")
    if not queries.is_floating_point():
        raise TypeError(f"queries must be floating point, got {queries.dtype}")
    if store.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise TypeError(f"store must be bf16, f32 or int8, got {store.dtype}")
    int8 = store.dtype == torch.int8
    rows = store.shape[0]
    n = n_total or rows
    if n > rows or n >= 2**31:
        raise ValueError(f"n_total {n} exceeds the store's {rows} rows (or int32 columns)")
    if int8 and (scales is None or scales.shape != (rows,) or scales.dtype != torch.float32):
        raise ValueError("an int8 store needs the [N] f32 scales of prepare_dense_store")
    dev = store.device
    if metric == "l2" and (sq_norms is None or sq_norms.shape != (rows,)
                           or sq_norms.dtype != torch.float32):
        raise ValueError("l2 needs the [N] f32 squared norms of prepare_dense_store")
    for name, t in (("queries", queries), ("sq_norms", sq_norms), ("scales", scales)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, store on {dev}")
    row_scale = None
    if mxu_int8:
        if not int8 or metric != "ip":
            raise ValueError("mxu_int8 needs an int8 store and metric='ip'")
        # per-row symmetric quantization; the row scale multiplies a row's
        # scores equally, so it is applied to the returned values
        x = queries.float()
        qmax = x.abs().amax(dim=-1)
        row_scale = torch.where(qmax > 0, qmax / 127.0, torch.ones_like(qmax))
        queries = torch.clamp(torch.round(x / row_scale[:, None]), -127, 127).to(torch.int8)
    elif store.dtype == torch.bfloat16 or int8:
        queries = queries.to(torch.bfloat16)
    else:
        queries = queries.float()
    return queries, row_scale, n


def _sweep_plain(qc, store, *, k, n, sq_norms, scales, mxu_int8):
    """Running top-``k`` of ``qc . store[:n]`` (the l2 key when
    ``sq_norms`` is given), by (score desc, column asc). Empty slots are
    (-inf, -1)."""
    nq = qc.shape[0]
    dev = qc.device
    # int8 x int8 sums are exact in f64, as the kernel's int32 sums are
    q = qc.double() if mxu_int8 else qc.float()
    run_v = torch.full((nq, k), float("-inf"), device=dev)
    run_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for s0 in range(0, n, PLAIN_TILE_N):
        s1 = min(s0 + PLAIN_TILE_N, n)
        tile = store[s0:s1]
        sc = (q @ tile.to(q.dtype).T).float()
        if scales is not None:
            sc = sc * scales[s0:s1][None]
        if sq_norms is not None:
            sc = 2.0 * sc - sq_norms[s0:s1][None]
        cols = torch.arange(s0, s1, device=dev).expand(nq, -1)
        # the running entries hold lower columns and come first, so a
        # stable sort ranks equal scores by column ascending
        top, pos = torch.sort(torch.cat([run_v, sc], 1), dim=1, descending=True, stable=True)
        run_v = top[:, :k]
        run_i = torch.gather(torch.cat([run_i, cols], 1), 1, pos[:, :k])
    run_i = torch.where(torch.isneginf(run_v), -1, run_i)
    return run_v, run_i.to(torch.int32)


last_plan: Optional[DensePlan] = None  # the plan of the last kernel launch


def _sweep_kernel(qc, store, *, k, n, sq_norms, scales, mxu_int8):
    global last_plan
    nq, d = qc.shape
    dev = qc.device
    if not all(t is None or t.is_contiguous() for t in (qc, store, sq_norms, scales)):
        raise ValueError("dense_topk kernel needs contiguous tensors")
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return out_v.fill_(float("-inf")), out_i.fill_(-1)
    plan = plan_dense(nq, n, d, store.dtype, k, mxu_int8, kernels.sm_count(dev),
                      (qc.data_ptr(), store.data_ptr()))
    part_v = torch.empty((plan.nchunks, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((plan.nchunks, nq, k), dtype=torch.int32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = kernels.library()
    with torch.cuda.device(dev):
        kernels.check(
            lib.dense_topk(
                qc.data_ptr(), store.data_ptr(), ptr(sq_norms), ptr(scales),
                _mode(store.dtype, mxu_int8),
                REGIMES[plan.regime], nq, n, d, plan.qt, plan.ntile, plan.chunk_rows,
                plan.nchunks, k, plan.stages, plan.boxes, plan.cap, int(plan.resident),
                plan.smem,
                part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                kernels.stream_ptr(dev),
            ),
            "dense_topk",
        )
    kernels.LAUNCHES["dense_topk"] += 1
    last_plan = plan
    return out_v, out_i


def _dense_topk(sweep, queries, store, *, k, metric, sq_norms, scales, n_total, k_pad,
                mxu_int8):
    qc, row_scale, n = _prepare(
        queries, store, k=k, metric=metric, sq_norms=sq_norms, scales=scales,
        n_total=n_total, k_pad=k_pad, mxu_int8=mxu_int8,
    )
    vals, idx = sweep(qc, store, k=k, n=n,
                      sq_norms=sq_norms if metric == "l2" else None,
                      scales=scales if store.dtype == torch.int8 else None,
                      mxu_int8=mxu_int8)
    if row_scale is not None:
        vals = vals * row_scale[:, None]
    if metric == "l2":
        # |q|^2 of the queries the sweep scored (cast to the store's dtype)
        vals = -vals + (qc.float() ** 2).sum(-1, keepdim=True)
    return vals, idx


def dense_topk_plain(
    queries: torch.Tensor,  # [Q, D] float
    store: torch.Tensor,  # [N, D] bf16 | f32 | int8
    *,
    k: int,
    metric: str = "ip",
    sq_norms: Optional[torch.Tensor] = None,  # [N] f32, required for l2
    scales: Optional[torch.Tensor] = None,  # [N] f32 (int8 store)
    n_total: int = 0,  # documents in the store (0: all rows)
    k_pad: int = 0,  # the reference's running-list width, checked k <= k_pad (0: K_PAD)
    mxu_int8: bool = False,  # int8 store, ip: int8 x int8 sweep
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`dense_topk`: matmuls over tiles of
    ``PLAIN_TILE_N`` rows, merged into the running list by a stable sort."""
    return _dense_topk(_sweep_plain, queries, store, k=k, metric=metric, sq_norms=sq_norms,
                       scales=scales, n_total=n_total, k_pad=k_pad, mxu_int8=mxu_int8)


def dense_topk(
    queries: torch.Tensor,
    store: torch.Tensor,
    *,
    k: int,
    metric: str = "ip",
    sq_norms: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    n_total: int = 0,
    k_pad: int = 0,
    mxu_int8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [Q, k] f32, ids [Q, k] int32) of the flat search.

    Queries are cast to bf16 for bf16 and int8 stores (the l2 |q|^2 is
    then taken from the cast queries). With ``mxu_int8`` the queries are
    quantized per row, the sweep sums int8 x int8 products, and the row
    scale multiplies the returned scores. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = store.device
    if dev.type == "cpu":
        sweep = _sweep_plain
    elif dev.type == "cuda":
        sweep = _sweep_kernel
    else:
        raise ValueError(f"no dense top-k for device {dev}")
    return _dense_topk(sweep, queries, store, k=k, metric=metric, sq_norms=sq_norms,
                       scales=scales, n_total=n_total, k_pad=k_pad, mxu_int8=mxu_int8)


def dense_topk_rerank(
    queries: torch.Tensor,  # [Q, D] f32
    store: torch.Tensor,  # sweep store (int8 from prepare_dense_store)
    rerank_emb: torch.Tensor,  # [N, D] bf16 copy for the refinement
    *,
    k: int,
    metric: str = "ip",
    sq_norms: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    n_total: int = 0,
    k_pad: int = 32,
    mxu_int8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized sweep + exact refinement (faiss ``IndexRefineFlat``): keep
    a ``k_pad``-deep candidate pool from the sweep, re-score the candidates
    against ``rerank_emb`` and return the top ``k``. -1 slots keep score
    -inf (ip) / +inf (l2)."""
    if k > k_pad:
        raise ValueError(f"k ({k}) > k_pad ({k_pad})")
    _, cand = dense_topk(queries, store, k=k_pad, metric=metric, sq_norms=sq_norms, scales=scales,
                     n_total=n_total, k_pad=k_pad, mxu_int8=mxu_int8)
    valid = cand >= 0
    rows = rerank_emb[cand.clamp(min=0).long()].float()  # [Q, R, D]
    q = queries.to(rerank_emb.dtype).float()
    dot = torch.einsum("qd,qrd->qr", q, rows)
    if metric == "l2":
        key = torch.where(valid, 2.0 * dot - (rows * rows).sum(-1), float("-inf"))
    else:
        key = torch.where(valid, dot, float("-inf"))
    vals, pos = torch.sort(key, dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    idx = torch.gather(cand, 1, pos)
    idx = torch.where(vals > float("-inf"), idx, -1)
    if metric == "l2":
        vals = -vals + (queries.float() ** 2).sum(-1, keepdim=True)
    return vals, idx
