"""The port's prefill attention (``probing_rag_tpu_torch/ops/attention.py::
prefill_attention``) on the CPU, where the wrapper takes its plain version
(the kernel, ``kernels/csrc/prefill_attention.cu``, runs only on the card,
where ``chip_smoke.py`` phase 9 holds it to this plain version).

- ``prefill_attention_plain`` against JAX's ``_attention``
  (``probing_rag_tpu/models/gemma.py:787``, reaching ``_attn_core`` ``:755``)
  over the same stored cache: f32, bf16, int8 and int4 caches, f32 and bf16
  compute, MQA, GQA and H = KV; the cache path with left pads and an all-pad
  row (the mean over all S), and the no-cache path with positions-style left
  pads, whose pad rows attend the first real token.
- The structured mask ``(kpos <= qpos) & valid`` equals the dense mask JAX's
  forward builds, on both paths.
- A CPU emulation of the kernel's arithmetic (blocks of two 64-row query
  tiles, K tiles of ``plan_prefill_attention``'s slots skipped by their
  least valid position, two sweeps with an online max and sum of raw scores
  in base 2, bf16 probabilities, all-pad rows from V summed once over all S)
  within ``rounding_tolerance`` of the plain version, visiting every slot a
  row attends, at tile edges.
- ``plan_prefill_attention`` for every cache kind and head dim the kernel
  instantiates, in each regime: its shared memory fits a block, its tile is
  whole wgmma N steps, its registers fit the block.
- The persistent regime (a bf16 cache of at most 4 tiles at head dim
  64-128): its choice, layout and grid held to ``pattn``'s rule compiled
  with g++ at the port's shapes (Gemma-2B's, Mistral-7B's, the capture's
  and the tiny configs' keep PR 15's plan, ``PR15_PLANS``); its walk over
  (batch row, kv head, query tile) items; its barriers carried out across
  items (``simulate_rings``); its items of three 64-row tiles in
  ``emulate_kernel`` at head dim 64 and 128.
- ``prefill_kernel_takes`` and the wrapper's checks.

Tolerances: f32 compute at 1e-5 (the same f32 math, sums in another order);
bf16 compute element by element at ``rounding_tolerance`` (a probability
within 1e-5 of itself of a bf16 rounding midpoint may round to the
neighbouring value; plus 1e-5 of the sum of |p v|), as in
``tests/test_torch_attention.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.weights import lm_params_from_jax

from test_torch_attention import CASES, DTS, jax_reference, stored
from test_torch_gemma import numpy_params, to_jax

torch.set_num_threads(1)

INT_MAX = 2 ** 31 - 1
HEADS = {"mqa": (8, 1), "gqa": (4, 2), "mha": (2, 2)}


def prefill_case(t: int, h: int, kvh: int, cache: bool, seed: int = 0, b: int = 3,
                 gen: int = 9, hd: int = 32, pad: int = 11):
    """numpy inputs of one prefill: q [B, T, H, hd], K/V [B, KV, S, hd] f32
    before storing, and the structured mask (qpos, kpos, valid). Row 1 is
    left-padded by ``pad`` tokens, row 2 is all pad. ``cache``: S = T + gen
    slots, the prompt's pad slots invalid and the generation slots valid,
    qpos = kpos = the slot (the cursor at 0). Else S = T and qpos = kpos =
    the positions ``cumsum(valid) - 1`` clamped at 0."""
    rng = np.random.default_rng(seed)
    s = t + gen if cache else t
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    kv = rng.standard_normal((2, b, kvh, s, hd)).astype(np.float32)
    prompt = np.ones((b, t), bool)
    prompt[1, :pad] = False
    prompt[2] = False
    if cache:
        valid = np.concatenate([prompt, np.ones((b, s - t), bool)], axis=1)
        qpos = np.broadcast_to(np.arange(t), (b, t))
        kpos = np.broadcast_to(np.arange(s), (b, s))
    else:
        valid = prompt
        qpos = kpos = np.maximum(np.cumsum(prompt, axis=1) - 1, 0)
    return q, kv, (qpos.astype(np.int64), kpos.astype(np.int64), valid)


def dense_mask(qpos, kpos, valid):
    """JAX's forward's mask from the same three arrays (numpy)."""
    return ((kpos[:, None, :] <= qpos[:, :, None]) & valid[:, None, :])[:, None]


def torch_mask(smask):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in smask)


# the no-cache forward's K and V are its own bf16 or f32 projections
PATHS = [(kind, dt, "cache") for kind, dt in CASES] + [
    (kind, dt, "nocache") for kind, dt in CASES if kind == dt]


@pytest.mark.parametrize("heads", list(HEADS), ids=list(HEADS))
@pytest.mark.parametrize("kind,dt,path", PATHS)
def test_prefill_attention_plain_matches_jax(kind, dt, path, heads):
    """The plain version (what the wrapper takes on the CPU) against JAX's
    ``_attention`` over the same stored cache and mask."""
    h, kvh = HEADS[heads]
    q, kv, smask = prefill_case(13, h, kvh, path == "cache", seed=len(kind) + h)
    jdt, tdt = DTS[dt]
    jstore, (k, v, ks, vs) = stored(kind, kv)
    want, _ = jax_reference(kind, jstore, q, dense_mask(*smask), jdt)
    qt = torch.from_numpy(q).to(tdt)
    qpos, kpos, valid = torch_mask(smask)
    got = at.prefill_attention(qt, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs, dt=tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        mask = at.structured_mask(qpos, kpos, valid)
        tol = at.rounding_tolerance(qt, k, v, mask, k_scale=ks, v_scale=vs, dt=tdt).numpy()
        assert (np.abs(got.numpy() - want) <= tol).all(), float(np.abs(got.numpy() - want).max())
    # row 2 is all pad: on the cache path every query row masks every slot
    # (the mean of bf16(1/S) v over all S); without a cache its queries sit
    # at position 0 and still attend no valid slot, the same mean
    vd = at.dequant_kv(v, vs, tdt).float().numpy()[2]  # [KV, S, hd]
    w = torch.tensor(1.0 / vd.shape[1]).to(tdt).float().item()
    mean = np.repeat(w * vd.sum(axis=1), h // kvh, axis=0).reshape(-1)
    np.testing.assert_allclose(got.numpy()[2], np.broadcast_to(mean, got.shape[1:]),
                               rtol=1e-5, atol=1e-6)


def test_prefill_pad_rows_match_jax():
    """The two kinds of pad row: on the cache path a left pad's query row
    attends no slot (the mean over all S); without a cache it sits at
    position 0 and attends the row's first real token alone (its output is
    that token's value row), both as JAX computes them."""
    h, kvh, pad = 4, 1, 5
    for cache in (True, False):
        q, kv, smask = prefill_case(12, h, kvh, cache, seed=2, pad=pad)
        jstore, (k, v, _, _) = stored("f32", kv)
        want, _ = jax_reference("f32", jstore, q, dense_mask(*smask), jnp.float32)
        qpos, kpos, valid = torch_mask(smask)
        got = at.prefill_attention(torch.from_numpy(q), k, v, qpos, kpos, valid,
                                   dt=torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        pad_rows = got[1, :pad].reshape(pad, h, -1)
        if cache:
            mean = kv[1, 1, 0].mean(axis=0)  # [hd]: all S slots at weight 1 / S
            np.testing.assert_allclose(pad_rows, np.broadcast_to(mean, pad_rows.shape),
                                       rtol=1e-5, atol=1e-5)
        else:
            first = kv[1, 1, 0, pad]  # the first real token's value row
            np.testing.assert_allclose(pad_rows, np.broadcast_to(first, pad_rows.shape),
                                       rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the forward's mask

V = 512
JCFG = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=V), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=V), compute_dtype=torch.float32)


@pytest.mark.parametrize("path", ["cache", "nocache"])
def test_structured_mask_equals_forward_dense_mask(path, monkeypatch):
    """The (qpos, kpos, valid) that ``forward`` hands ``_block`` give, element
    for element, the dense mask JAX's forward builds from the same inputs
    (left-padded prompts; over a cache at a cursor past 0 as well)."""
    seen = {"jax": [], "torch": []}
    j_block, t_block = jg._block, tg._block

    def j_spy(lp, x, positions, mask, *args, **kw):
        seen["jax"].append(np.asarray(mask))
        return j_block(lp, x, positions, mask, *args, **kw)

    def t_spy(lp, x, positions, mask, *args, smask=None, **kw):
        seen["torch"].append((mask.numpy(), at.structured_mask(*smask).numpy()))
        return t_block(lp, x, positions, mask, *args, smask=smask, **kw)

    monkeypatch.setattr(jg, "_block", j_spy)
    monkeypatch.setattr(tg, "_block", t_spy)
    tree = numpy_params(JCFG, seed=4)
    params = lm_params_from_jax(tree, TCFG, device="cpu")
    rng = np.random.default_rng(1)
    b, t = 3, 11
    tokens = rng.integers(0, V, (b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, :4] = False
    valid[2, :t - 1] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    if path == "cache":
        s = 20
        slot_valid = np.concatenate([valid, np.ones((b, s - t), bool)], axis=1)
        for pos in (0, 3):  # a prefill, then a block of t tokens at cursor 3
            jkv = jg.init_kv_cache(JCFG, b, s, jnp.float32)
            jkv = dict(jkv, pos=jnp.asarray(pos, jnp.int32))
            jg.forward(to_jax(tree), jnp.asarray(tokens), JCFG, kv_cache=jkv,
                       positions=jnp.asarray(positions), attn_valid=jnp.asarray(slot_valid))
            tkv = tg.init_kv_cache(TCFG, b, s, torch.float32, device="cpu")
            tkv = dict(tkv, pos=torch.tensor(pos))
            tg.forward(params, torch.from_numpy(tokens).long(), TCFG, kv_cache=tkv,
                       positions=torch.from_numpy(positions).long(),
                       attn_valid=torch.from_numpy(slot_valid))
    else:
        jg.forward(to_jax(tree), jnp.asarray(tokens), JCFG, positions=jnp.asarray(positions),
                   attn_valid=jnp.asarray(valid))
        tg.forward(params, torch.from_numpy(tokens).long(), TCFG,
                   positions=torch.from_numpy(positions).long(),
                   attn_valid=torch.from_numpy(valid))
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    for jm, (dense, structured) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(dense, jm)
        np.testing.assert_array_equal(structured, jm)


# ------------------------------------------------------------ the kernel's arithmetic


def emulate_kernel(q, k, v, qpos, kpos, valid, k_scale=None, v_scale=None):
    """``prefill_attention.cu`` written out in torch on the CPU, bf16
    compute: returns (out [B, T, H*hd] f32, the K tiles each block visited,
    keyed by (batch row, kv head, the block's first position)).

    Prep: keff (kpos of a valid slot, else INT_MAX, INT_MAX past S), each
    tile's least keff (tiles of ``plan_prefill_attention``'s slots), V
    (widened to bf16) summed over all S. A block: two consumer tiles of 64
    rows, each 64 / G positions x the G heads of one (batch row, kv head);
    it visits, in order, the tiles whose least keff is at most its largest
    qpos. Sweep 1: raw scores (f32 sums of bf16 products), -1e30 where keff
    > qpos, an online max m and sum l of 2^(x c2 - m c2), c2 = f32(1 /
    sqrt(hd)) x log2(e). Sweep 2: the same scores, p = bf16(2^(x c2 - m c2)
    x (1 / l)), f32 sums of p v. A row whose max stays at or under -1e30
    attends nothing: bf16(1 / S) times the V sum. The persistent regime's
    items (``plan.positions`` of 192 at G 1) take the same arithmetic."""
    dt = torch.bfloat16
    b, t, h, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    plan = at.plan_prefill_attention(k.dtype, hd, g, s)
    kd = at.dequant_kv(k, k_scale, dt).float()
    vd = at.dequant_kv(v, v_scale, dt).float()
    tile = plan.tile
    ntiles = -(-s // tile)
    pad = ntiles * tile - s
    keff = torch.where(valid, kpos.long(), torch.full_like(kpos.long(), INT_MAX))
    keff = torch.nn.functional.pad(keff, (0, pad), value=INT_MAX)  # [B, ntiles * tile]
    tmin = keff.reshape(b, ntiles, tile).amin(dim=-1)
    kd = torch.nn.functional.pad(kd, (0, 0, 0, pad))  # zeros past S
    vd_tiles = torch.nn.functional.pad(vd, (0, 0, 0, pad))
    vsum = vd.sum(dim=2)  # [B, KV, hd]
    w = torch.tensor(1.0 / s).to(dt).float()
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(np.sqrt(hd), dtype=torch.float32)
    c2 = scale * torch.tensor(np.log2(np.e), dtype=torch.float32)
    npos = plan.positions  # a block's: two consumer tiles of rows // G
    out = torch.zeros((b, t, h * hd))
    visited = {}
    for bi in range(b):
        for hi in range(kvh):
            for t0 in range(0, t, npos):
                t1 = min(t0 + npos, t)
                qrows = q[bi, t0:t1, hi * g:(hi + 1) * g].reshape(-1, hd).float()
                qp = qpos[bi, t0:t1].long().repeat_interleave(g)
                tiles = [j for j in range(ntiles) if tmin[bi, j] <= qp.max()]
                visited[(bi, hi, t0)] = tiles

                def scores(j):
                    sl = slice(j * tile, (j + 1) * tile)
                    sc = qrows @ kd[bi, hi, sl].T
                    return torch.where(keff[bi, sl][None, :] <= qp[:, None], sc,
                                       torch.tensor(-1e30))

                m = torch.full((qrows.shape[0],), -float("inf"))
                lsum = torch.zeros(qrows.shape[0])
                for j in tiles:
                    sc = scores(j)
                    new = torch.maximum(m, sc.amax(dim=1))
                    lsum = (lsum * torch.exp2((m - new) * c2)
                            + torch.exp2(sc * c2 - (new * c2)[:, None]).sum(dim=1))
                    m = new
                o = torch.zeros((qrows.shape[0], hd))
                for j in tiles:
                    p = torch.exp2(scores(j) * c2 - (m * c2)[:, None]) * (1.0 / lsum)[:, None]
                    o = o + p.to(dt).float() @ vd_tiles[bi, hi, j * tile:(j + 1) * tile]
                dead = m <= -1e30
                o[dead] = w * vsum[bi, hi]
                out[bi, t0:t1, hi * g * hd:(hi + 1) * g * hd] = o.reshape(t1 - t0, g * hd)
    return out, visited


EMULATED = [
    # (T, H, KV, cache, pad, kind) at head dim 32, tiles of 128 slots: T and S
    # off the tiles (S over one tile); blocks of 16 positions straddling row
    # 1's pad boundary; G 1 with two blocks of 128 positions
    (137, 8, 1, True, 11, "bf16"),
    (145, 4, 2, False, 13, "bf16"),
    (170, 2, 2, True, 29, "int8"),
    (133, 8, 1, False, 3, "bf16"),
    (140, 4, 2, True, 17, "int4"),
]


@pytest.mark.parametrize("t,h,kvh,cache,pad,kind", EMULATED)
def test_kernel_emulation_within_rounding_tolerance(t, h, kvh, cache, pad, kind):
    """The kernel's arithmetic (``emulate_kernel``) within ``rounding_tolerance``
    of the plain version; every slot any row of a block attends lies in a
    tile the block visits; rows with no attendable slot are the mean over
    all S slots (the plain softmax over -1e30), which no tile sweep covers."""
    check_emulation(t, h, kvh, cache, pad, kind, 32)


@pytest.mark.parametrize("t,h,kvh,cache,pad,hd", [
    (137, 2, 2, False, 13, 64),  # the encoder's G 1, T and S off the tiles
    (300, 2, 2, True, 29, 64),  # G 1 on the cache path, three tiles
    (129, 4, 2, True, 17, 128),  # G 2 at head dim 128
])
def test_persistent_emulation_within_rounding_tolerance(t, h, kvh, cache, pad, hd):
    """The same in the persistent regime (a bf16 cache of at most 4 tiles at
    head dim 64-128): items of three 64-row tiles."""
    check_emulation(t, h, kvh, cache, pad, "bf16", hd)


def check_emulation(t, h, kvh, cache, pad, kind, hd):
    q, kv, smask = prefill_case(t, h, kvh, cache, seed=t, pad=pad, hd=hd)
    _, (k, v, ks, vs) = stored(kind, kv)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    qpos, kpos, valid = torch_mask(smask)
    regime = at.plan_prefill_attention(k.dtype, hd, h // kvh, k.shape[2]).regime
    assert regime == ("persistent" if hd > 32 else "tiles")
    got, visited = emulate_kernel(qt, k, v, qpos, kpos, valid, ks, vs)
    ref = at.prefill_attention_plain(qt, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs)
    mask = at.structured_mask(qpos, kpos, valid)
    tol = at.rounding_tolerance(qt, k, v, mask, k_scale=ks, v_scale=vs)
    assert ((got - ref).abs() <= tol).all(), float((got - ref).abs().max())
    g = h // kvh
    plan = at.plan_prefill_attention(k.dtype, q.shape[-1], g, k.shape[2])
    dead = ~mask[:, 0].any(dim=-1)  # [B, T]
    assert bool(dead[2].all()) and bool(dead.any())
    for bi in range(dead.shape[0]):  # the prep's test of a batch row for such rows
        kmin = int(kpos[bi][valid[bi]].min()) if bool(valid[bi].any()) else INT_MAX
        assert bool(dead[bi].any()) == (int(qpos[bi].min()) < kmin)
    for (bi, hi, t0), tiles in visited.items():
        attended = mask[bi, 0, t0:t0 + plan.positions].any(dim=0).nonzero().flatten()
        assert set((attended // plan.tile).tolist()) <= set(tiles), (bi, hi, t0)
    vd = at.dequant_kv(v, vs, torch.bfloat16).float()
    w = torch.tensor(1.0 / vd.shape[2]).to(torch.bfloat16).float()
    mean = (w * vd.sum(dim=2)).repeat_interleave(g, dim=1).reshape(vd.shape[0], -1)  # [B, H*hd]
    torch.testing.assert_close(got[dead], mean[:, None].expand_as(got)[dead], rtol=1e-5,
                               atol=1e-6)


def test_kernel_emulation_skips_tiles_past_the_diagonal():
    """Tile skipping does real work on the cache path: a block of the first
    positions visits only the tiles up to its last position, and a block of
    pad rows (row 2, all pad) visits none of the prompt's tiles."""
    t, h, kvh = 200, 8, 1
    q, kv, smask = prefill_case(t, h, kvh, True, seed=1)
    _, (k, v, _, _) = stored("bf16", kv)
    qpos, kpos, valid = torch_mask(smask)
    _, visited = emulate_kernel(torch.from_numpy(q).to(torch.bfloat16), k, v, qpos, kpos, valid)
    # head dim 32: tiles of 128 slots, blocks of 2 x 64 / 8 = 16 positions
    assert visited[(0, 0, 0)] == [0]  # positions 0-15 reach slot 15 at most
    assert visited[(0, 0, 112)] == [0]  # positions 112-127: tile 0 alone
    assert visited[(0, 0, 192)] == [0, 1]  # positions 192-199: tiles 0 and 1
    assert visited[(2, 0, 0)] == []  # row 2's prompt slots are invalid, the rest lie ahead


# ------------------------------------------------------------ the kernel's plan

SMEM_PER_BLOCK = 232_448  # 227 KB, the H100's shared memory a block may use
WGMMA_N_STEP = 8
SMS = 132  # the H100's SMs


@pytest.mark.parametrize("hd", at.PREFILL_HEAD_DIMS)
@pytest.mark.parametrize("kind", [torch.bfloat16, torch.float32, torch.int8, torch.uint8],
                         ids=["bf16", "f32", "int8", "int4"])
def test_prefill_plan_fits_the_card(kind, hd):
    """Every instantiation's plan, in each regime it runs (a long cache and
    one of 512 slots): its shared memory (Q's buffers, the ring, the raw
    ring, the barriers, the alignment slack) fits a block; its tile is
    whole wgmma N steps and at most 256; its registers a role fit the
    block's 384 x 168 that setmaxnreg redistributes; a raw ring exists
    exactly for the caches that are not bf16, in whole raw stages a tile;
    two Q buffers exactly in the persistent regime."""
    for slots in (4096, 512):
        plan = at.plan_prefill_attention(kind, hd, 8, slots)
        assert plan.smem <= SMEM_PER_BLOCK
        assert plan.tile % WGMMA_N_STEP == 0 and plan.tile <= 256
        persistent = plan.regime == "persistent"
        assert plan.consumers == (3 if persistent else 2)
        assert plan.threads == 128 * (plan.consumers + 1) == (512 if persistent else 384)
        # the launch bound's registers a thread (65,536 over the threads, in
        # steps of 8: 168 at 384, 128 at 512), which setmaxnreg moves between roles
        per_thread = 65536 // plan.threads // 8 * 8
        assert (plan.consumers * plan.consumer_regs + plan.producer_regs
                <= (plan.consumers + 1) * per_thread)
        assert plan.rows == 64 and plan.positions == plan.consumers * (64 // 8)
        assert plan.stages >= 2
        assert plan.q_buffers == (2 if persistent else 1)
        if kind == torch.bfloat16:
            assert plan.raw_stages == plan.raw_slots == 0
        else:
            assert plan.raw_stages >= 2 and plan.raw_slots > 0 and plan.tile % plan.raw_slots == 0
        # one more ring stage would not fit, or the ring is at its cap
        bigger = at._prefill_smem(at._KINDS[kind], hd, plan.tile, plan.raw_slots,
                                  plan.stages + 1, plan.raw_stages, plan.q_buffers)
        cap = 8 if persistent else 6 if kind == torch.bfloat16 else 4
        assert bigger > SMEM_PER_BLOCK or plan.stages == cap


def test_prefill_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        at.plan_prefill_attention(torch.bfloat16, 96, 8, 512)
    with pytest.raises(ValueError):
        at.plan_prefill_attention(torch.bfloat16, 128, 65, 512)
    with pytest.raises(ValueError):
        at.plan_prefill_attention(torch.bfloat16, 64, 1, 0)


# PR 15's plans (tile, stages, raw_slots, raw_stages, smem) at G 8, as its
# planner gave them: every call outside the persistent regime keeps them
PR15_PLANS = {
    ("bf16", 32): (128, 6, 0, 0, 61544), ("bf16", 64): (128, 6, 0, 0, 118888),
    ("bf16", 128): (128, 5, 0, 0, 200280), ("bf16", 256): (64, 5, 0, 0, 231768),
    ("f32", 32): (128, 4, 128, 4, 111752), ("f32", 64): (128, 4, 64, 4, 151688),
    ("f32", 128): (128, 4, 32, 3, 216568), ("f32", 256): (64, 3, 16, 4, 231544),
    ("int8", 32): (128, 4, 128, 4, 64648), ("int8", 64): (128, 4, 128, 4, 121992),
    ("int8", 128): (128, 4, 128, 3, 219256), ("int8", 256): (64, 3, 64, 3, 216424),
    ("int4", 32): (128, 4, 128, 4, 56456), ("int4", 64): (128, 4, 128, 4, 107656),
    ("int4", 128): (128, 4, 128, 4, 210056), ("int4", 256): (64, 4, 64, 3, 230264),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8, "int4": torch.uint8}
# (kind, hd, G, slots, T, B x KV, regime) of the calls the port makes
REGIME_SHAPES = {
    "gemma prefill bf16": ("bf16", 256, 8, 3862, 3712, 8, "tiles"),
    "gemma prefill int8": ("int8", 256, 8, 3862, 3712, 8, "tiles"),
    "gemma prefill int4": ("int4", 256, 8, 3862, 3712, 8, "tiles"),
    "capture": ("bf16", 256, 8, 1536, 1536, 8, "tiles"),
    "gemma short prompt": ("bf16", 256, 8, 300, 140, 8, "tiles"),
    "mistral-7b int8": ("int8", 128, 4, 1174, 1024, 64, "tiles"),
    "mistral-7b bf16": ("bf16", 128, 4, 1174, 1024, 64, "tiles"),
    "mistral-7b short f32 cache": ("f32", 128, 4, 200, 40, 64, "tiles"),
    "tiny": ("bf16", 32, 2, 140, 137, 3, "tiles"),
    "tiny int4": ("int4", 32, 2, 170, 161, 3, "tiles"),
    "encoder build": ("bf16", 64, 1, 376, 376, 512 * 12, "persistent"),
    "encoder T 512": ("bf16", 64, 1, 512, 512, 512 * 12, "persistent"),
    "encoder T 513": ("bf16", 64, 1, 513, 513, 512 * 12, "tiles"),
    "encoder query": ("bf16", 64, 1, 40, 40, 8 * 12, "persistent"),
    "encoder one doc": ("bf16", 64, 1, 9, 9, 12, "persistent"),
    "encoder int8 cache": ("int8", 64, 1, 376, 376, 12, "tiles"),
    "hd 128 short": ("bf16", 128, 4, 300, 200, 16, "persistent"),
}

PATTN_SHIM = """
extern "C" int pattn_plan(int kind, int hd, int s, int* out) {
  const int regime = pattn::regime(kind, hd, s);
  const int r = pattn::ring_stages(kind, hd, regime), rd = pattn::raw_stages(kind, hd);
  out[0] = regime; out[1] = pattn::tile_slots(hd); out[2] = r;
  out[3] = pattn::raw_slots(kind, hd); out[4] = rd; out[5] = pattn::q_buffers(regime);
  out[6] = pattn::smem_bytes(kind, hd, r, rd, regime);
  out[7] = pattn::consumers(regime); out[8] = pattn::threads(regime);
  out[9] = pattn::consumer_regs(kind, regime); out[10] = pattn::producer_regs(kind, regime);
  return 1;
}
extern "C" int pattn_grid(int regime, int items, int sms) {
  return pattn::grid(regime, items, sms);
}
"""


@pytest.fixture(scope="module")
def pattn_rule(tmp_path_factory):
    """``prefill_attention.cu``'s plan rule (namespace pattn, host code),
    compiled with g++ from the source the card builds."""
    import ctypes
    import subprocess
    from pathlib import Path

    src = (Path(at.__file__).resolve().parents[1] / "kernels" / "csrc"
           / "prefill_attention.cu").read_text()
    body = src[src.index("namespace pattn {"):src.index("}  // namespace pattn\n")] + "}\n"
    head = ("#define __host__\n#define __device__\n"
            "namespace attn { enum Kind { kBf16 = 0, kF32 = 1, kInt8 = 2, kInt4 = 3 }; }\n")
    d = tmp_path_factory.mktemp("pattn_rule")
    cpp, so = d / "pattn.cpp", d / "pattn.so"
    cpp.write_text(head + body + PATTN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", str(cpp), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.pattn_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.pattn_grid.argtypes = [ctypes.c_int] * 3
    return lib


@pytest.mark.parametrize("shape", list(REGIME_SHAPES))
def test_prefill_regime_and_layout_are_the_entry_rule(shape, pattn_rule):
    """At the port's calls, ``plan_prefill_attention``'s regime, layout and
    grid are ``pattn``'s rule (the C entry's check, the kernel's layout):
    Gemma-2B's prefills and capture, Mistral-7B's, the tiny configs' and
    the encoder's over more than 512 keys or a cache that is not bf16 keep
    PR 15's plan and a block an item; the encoder's build, T 512, query and
    a one-doc batch, and head dim 128 over a short bf16 cache, run
    persistent, min(SMs, items) blocks of three consumer warpgroups."""
    import ctypes

    kind, hd, g, s, t, bkv, regime = REGIME_SHAPES[shape]
    plan = at.plan_prefill_attention(DTYPES[kind], hd, g, s, t, bkv, SMS)
    out = (ctypes.c_int * 11)()
    pattn_rule.pattn_plan(at._KINDS[DTYPES[kind]], hd, s, out)
    assert plan.regime == regime == ("persistent" if out[0] == 1 else "tiles")
    assert (plan.tile, plan.stages, plan.raw_slots, plan.raw_stages, plan.q_buffers, plan.smem,
            plan.consumers, plan.threads, plan.consumer_regs,
            plan.producer_regs) == tuple(out[1:])
    items = -(-t // plan.positions) * bkv
    assert plan.grid == pattn_rule.pattn_grid(out[0], items, SMS)
    assert plan.grid == (min(items, SMS) if regime == "persistent" else items)
    if regime == "tiles":
        g8 = at.plan_prefill_attention(DTYPES[kind], hd, 8, s)
        assert (g8.tile, g8.stages, g8.raw_slots, g8.raw_stages, g8.smem) == PR15_PLANS[(kind, hd)]
    else:
        assert plan.smem <= SMEM_PER_BLOCK and plan.q_buffers == 2


def persistent_walk(plan, qtiles: int, bkv: int):
    """``prefill_attn``'s persistent walk: block j takes items j, j + grid,
    ..., item it the (bk, qt) = divmod(it, qtiles). Returns each block's
    list of (bk, qt)."""
    items = qtiles * bkv
    return [[divmod(it, qtiles) for it in range(j, items, plan.grid)] for j in range(plan.grid)]


@pytest.mark.parametrize("b,t", [(1, 40), (8, 40), (11, 40), (11, 193), (16, 376), (512, 376),
                                 (30, 512)])
def test_persistent_walk_visits_every_item_once(b, t):
    """Below, at and above the SM count (12 items at one doc, 96 at a
    query batch, 132 at 11 docs, 264 at 11 docs of two query tiles, 384 at
    16 docs of 376, 12,288 at the build's 512): every (batch row, kv head,
    query tile) is visited exactly
    once, each block takes its share (the counts differ by at most one),
    and the items in flight at once (one a block) hold a (batch row, kv
    head)'s query tiles side by side, so its K and V are read from device
    memory once."""
    kv = 12
    plan = at.plan_prefill_attention(torch.bfloat16, 64, 1, t, t, b * kv, SMS)
    assert plan.regime == "persistent"
    qtiles = -(-t // plan.positions)
    walks = persistent_walk(plan, qtiles, b * kv)
    seen = [it for w in walks for it in w]
    assert sorted(seen) == [(bk, qt) for bk in range(b * kv) for qt in range(qtiles)]
    counts = [len(w) for w in walks]
    assert plan.grid == min(SMS, qtiles * b * kv) and min(counts) >= 1
    assert max(counts) - min(counts) <= 1
    first = [w[0] for w in walks]  # the first wave
    bks = sorted({bk for bk, _ in first})
    assert all(sum(1 for bk2, _ in first if bk2 == bk) == qtiles for bk in bks[:-1])


def simulate_rings(ns, stages: int, q_buffers: int):
    """The persistent regime's barriers carried out for one block whose
    items visit ``ns`` tiles each: the producer (Q into buffer u % 2 after
    its empty barrier, then each item's ring steps, sweep 1's K tiles and
    sweep 2's K and V) and the consumers (Q's full barrier, then each ring
    step's full barrier, releasing the stage; Q released after sweep 2),
    each waiting on the parity the kernel computes. A wait passes where the
    barrier's completed phases have the other parity (mbarrier's
    try_wait.parity), and every passing wait must see exactly the phase it
    means (never one ahead or behind). Returns the order in which ring
    steps were filled and read."""
    full, empty = [0] * stages, [0] * stages  # completed phases
    qfull, qempty = [0] * q_buffers, [0] * q_buffers

    def can(count, parity, use):
        ok = (count & 1) != parity
        if ok:
            assert count == use + 1 if parity == use & 1 else count == use, (count, use)
        return ok

    prod = []  # ("q", u) or ("k"/"v", g)
    for u, n in enumerate(ns):
        prod.append(("q", u))
        prod += [("k", None)] * n + [("k", None), ("v", None)] * n
    cons = []
    for u, n in enumerate(ns):
        cons.append(("q", u))
        cons += [("step", None)] * (3 * n)
        cons.append(("qdone", u))
    pi = ci = pg = cg = 0
    filled, read = [], []
    while pi < len(prod) or ci < len(cons):
        moved = False
        if pi < len(prod):
            what, u = prod[pi]
            if what == "q":
                qb = u % q_buffers
                if q_buffers == 1 or can(qempty[qb], ((u // q_buffers) & 1) ^ 1, u // q_buffers):
                    qfull[qb] += 1
                    pi += 1
                    moved = True
            else:
                st = pg % stages
                if can(empty[st], ((pg // stages) & 1) ^ 1, pg // stages):
                    full[st] += 1
                    filled.append(pg)
                    pg += 1
                    pi += 1
                    moved = True
        if ci < len(cons):
            what, u = cons[ci]
            if what == "q":
                qb = u % q_buffers
                if can(qfull[qb], (u // q_buffers) & 1, u // q_buffers):
                    ci += 1
                    moved = True
            elif what == "step":
                st = cg % stages
                if can(full[st], (cg // stages) & 1, cg // stages):
                    empty[st] += 1
                    read.append(cg)
                    cg += 1
                    ci += 1
                    moved = True
            else:
                if q_buffers > 1:
                    qempty[u % q_buffers] += 1
                ci += 1
                moved = True
        assert moved, f"deadlock at producer {pi}, consumers {ci}"
    return filled, read


@pytest.mark.parametrize("ns", [[3] * 140, [1, 3, 0, 2, 3, 0, 0, 1], [4] * 5, [0] * 4, [1],
                                [2, 0, 2, 0, 3]])
@pytest.mark.parametrize("stages", [8, 4])
def test_persistent_rings_run_across_items(ns, stages):
    """The ring's steps and phases and the two Q buffers run on across a
    block's items without a deadlock or a wait that sees another phase
    than its own, at the encoder's ring (8 stages at head dim 64) and head
    dim 128's (4), for items of 0-4 tiles; every step is filled and read
    once, in order."""
    filled, read = simulate_rings(ns, stages, 2)
    assert filled == read == list(range(3 * sum(ns)))


# ------------------------------------------------------------ what the kernel takes


@pytest.mark.parametrize("groups,hd,takes", [
    (8, 256, True),  # Gemma-2B
    (4, 128, True),  # Mistral-7B
    (2, 32, True),  # the tiny test model
    (1, 64, True),  # H = KV
    (64, 64, True),
    (65, 64, False),  # more heads a kv head than a block's 64 rows
    (2, 16, False),  # tiny_mistral: plain ops
    (8, 512, False),
    (8, 96, False),
])
def test_prefill_kernel_takes(groups, hd, takes):
    assert at.prefill_kernel_takes(groups, hd) is takes


def test_prefill_attention_rejects_what_it_does_not_take():
    q, kv, smask = prefill_case(9, 4, 2, True)
    _, (k, v, ks, vs) = stored("int8", kv)
    qt = torch.from_numpy(q)
    qpos, kpos, valid = torch_mask(smask)
    with pytest.raises(TypeError):  # a compute type other than bf16 or f32
        at.prefill_attention(qt, k, v, qpos, kpos, valid, k_scale=ks, v_scale=vs,
                             dt=torch.float16)
    with pytest.raises(ValueError):  # an int8 cache without its scales
        at.prefill_attention(qt, k, v, qpos, kpos, valid, dt=torch.float32)
    with pytest.raises(ValueError):  # kpos of another slot count
        at.prefill_attention(qt, k, v, qpos, kpos[:, :-1], valid, k_scale=ks, v_scale=vs,
                             dt=torch.float32)
    with pytest.raises(ValueError):  # qpos of another length
        at.prefill_attention(qt, k, v, qpos[:, :-1], kpos, valid, k_scale=ks, v_scale=vs,
                             dt=torch.float32)
    with pytest.raises(TypeError):  # positions as floats
        at.prefill_attention(qt, k, v, qpos.float(), kpos, valid, k_scale=ks, v_scale=vs,
                             dt=torch.float32)
    with pytest.raises(ValueError):  # valid not bool
        at.prefill_attention(qt, k, v, qpos, kpos, valid.int(), k_scale=ks, v_scale=vs,
                             dt=torch.float32)
    with pytest.raises(ValueError):  # neither the CPU nor a card
        meta = [x.to("meta") for x in (qt, k, v, qpos, kpos, valid, ks, vs)]
        at.prefill_attention(*meta[:6], k_scale=meta[6], v_scale=meta[7], dt=torch.float32)
