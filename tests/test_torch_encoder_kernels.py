"""The Contriever encoder's kernels' plain versions (``probing_rag_tpu_torch/
ops/encoder.py``) on the CPU, where each wrapper takes its plain version (the
kernels, ``kernels/csrc/layer_norm.cu``, ``bias_gelu.cu`` and
``qkv_heads.cu``, and ``prefill_attention.cu`` under the key-padding mask,
run only on the card, where ``chip_smoke.py`` phase 7a holds them to these
plain versions), against the JAX encoder they replace
(``probing_rag_tpu/models/encoder.py``):

- ``add_layer_norm_plain`` against JAX's ``_ln`` of ``x + f32(bf16(delta +
  bias))`` and of the embedding sum; ``bias_gelu_plain`` against
  ``jax.nn.gelu(approximate=False)`` of the biased bf16 input, evaluated in
  f32 on it (JAX's CPU backend evaluates a bf16 gelu op by op in bf16; the
  port's plain ops, like XLA's fused kernel, round once); ``qkv_heads_plain``
  against the reshape of the three biased products.
- the encoder's attention through ``prefill_attention`` (qpos = kpos = 0,
  valid the mask) against JAX ``:119-123`` at head dim 64, G 1, with ragged
  masks holding a length-1 row and an all-padding row.
- the plain versions in f32 compute (the encoder's checking mode) against
  JAX's f32 arithmetic.
- the whole encoder at d 128, 2 heads of 64, 2 layers, d_ff 256 (admitted
  to ``KERNEL_WIDTHS`` for the test: on the card only Contriever's width
  runs the kernels) in f32 and bf16, with the bf16 route's calls counted.
- the planners at the index build's, T 512's and a query batch's shapes
  (and ``plan_bias_gelu`` at edge shapes and SM counts), held to the C
  entries' own rules (compiled with g++), and the widths each refuses;
  qkv_heads.cu's indexing, layer_norm.cu's order of sums and bias_gelu.cu's
  walk carried out in numpy.
- ``bias_gelu.cu``'s table of the 65,536 exact results, its shared-memory
  window and its lookup, emulated: bit-equal to ``bias_gelu_plain`` on
  every bf16 input, +-0, +-inf, NaN (as NaN), subnormals and the window's
  edges.
- the CLI's dense encoder: Contriever's width under ``--checkpoint``.

Tolerances: f32 at rtol / atol 1e-5 (1e-6 for the attention), as the same
arithmetic summed in another order; bf16 outputs equal, or one bf16 step
apart on at most 2^-10 of the elements (an f32 ulp either side of a bf16
rounding midpoint); the attention's bf16 path within ``rounding_tolerance``;
the whole encoder at ``tests/test_torch_encoder.py``'s.
"""

import argparse
import ctypes
import dataclasses
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import encoder as je
from probing_rag_tpu_torch import kernels
from probing_rag_tpu_torch.models import encoder as te
from probing_rag_tpu_torch.ops import attention as at
from probing_rag_tpu_torch.ops import encoder as ek
from probing_rag_tpu_torch.weights import encoder_params_from_jax

torch.set_num_threads(1)

BF16_STEP_SHARE = 2.0 ** -10
# shapes of the main path: the index build's batch (512 docs at a batch's
# longest T, and at T 512) and a query batch (8 x ~40 tokens)
SHAPES = {"build": (512, 380), "build T 512": (512, 512), "query": (8, 40)}
CONTRIEVER = te.EncoderConfig.contriever()
D, H, HD, F = CONTRIEVER.d_model, CONTRIEVER.n_heads, 64, CONTRIEVER.d_ff


def bf16_np(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def jnp_bf16(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def assert_bf16_close(got: torch.Tensor, ref, what: str) -> None:
    """bf16 ``got`` equal to ``ref`` (bf16), or one bf16 step apart on at
    most ``BF16_STEP_SHARE`` of the elements."""
    g = got.float().numpy()
    r = np.asarray(ref, np.float32)
    diff = g != r
    if not diff.any():
        return
    # a bf16 step at the larger value: its f32 spacing times 2^16
    step = np.spacing(np.maximum(np.abs(g), np.abs(r)).astype(np.float32)) * 2.0 ** 16
    one = np.abs(g - r) <= step
    assert one[diff].all(), f"{what}: elements more than one bf16 step apart"
    assert diff.mean() <= BF16_STEP_SHARE, f"{what}: {diff.mean():.2e} of elements a step apart"


# --------------------------------------------------------- plain vs JAX


@pytest.mark.parametrize("delta", [True, False])
@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_add_layer_norm_plain_matches_jax(delta, wdt):
    """The residual (and bias) add and the norm against JAX's ``_ln`` of
    the same sum, as ``encoder_forward`` forms it; the bf16 copy against
    JAX's ``x.astype(bf16)``. The plain version takes the norm's weights
    in bf16 or f32 (the kernel's wrapper only f32)."""
    rng = np.random.default_rng(11)
    rows, d = 96, D
    resid = (3 * rng.standard_normal((rows, d))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    wt = torch.from_numpy(w) if wdt == "f32" else bf16_np(w)
    bt = torch.from_numpy(b) if wdt == "f32" else bf16_np(b)
    if delta:
        dl = bf16_np(rng.standard_normal((rows, d)))
        bias = bf16_np(0.1 * rng.standard_normal(d))
        xj = jnp.asarray(resid) + (jnp_bf16(dl) + jnp_bf16(bias)).astype(jnp.float32)
    else:
        dl = bias = None
        xj = jnp.asarray(resid)
    ref = np.asarray(je._ln(xj, jnp.asarray(wt.float().numpy()), jnp.asarray(bt.float().numpy()),
                            1e-12))
    out, xin = ek.add_layer_norm_plain(torch.from_numpy(resid), dl, bias, wt, bt, 1e-12)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert xin.dtype == torch.bfloat16
    assert_bf16_close(xin, np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32)),
                      "xin")


def test_bias_gelu_plain_matches_jax():
    """``gelu(bf16(h + b))`` against ``jax.nn.gelu(approximate=False)`` of
    JAX's bf16 sum, in f32 and rounded to bf16; the biased values span the
    negative tail where ``1 + erf`` would cancel."""
    rng = np.random.default_rng(12)
    h = bf16_np(2.5 * rng.standard_normal((128, 512)))
    bias = bf16_np(0.5 * rng.standard_normal(512))
    xj = (jnp_bf16(h) + jnp_bf16(bias)).astype(jnp.float32)
    ref = np.asarray(jax.nn.gelu(xj, approximate=False).astype(jnp.bfloat16).astype(jnp.float32))
    got = ek.bias_gelu(h, bias)
    assert got.dtype == torch.bfloat16 and got.shape == h.shape
    assert_bf16_close(got, ref, "bias_gelu")


def test_qkv_heads_plain_matches_jax():
    """One product of the concatenated ``wq | wk | wv`` split into q ``[B,
    T, H, hd]`` and k, v ``[B, H, T, hd]``, against JAX's three biased
    products reshaped to ``[B, T, H, hd]``; on the same product, equal bit
    for bit to JAX's bias adds."""
    rng = np.random.default_rng(13)
    b, t, d, h = 3, 11, 128, 2
    xin = bf16_np(rng.standard_normal((b, t, d)))
    ws = [bf16_np(0.05 * rng.standard_normal((d, d))) for _ in range(3)]
    bs = [bf16_np(0.1 * rng.standard_normal(d)) for _ in range(3)]
    y = xin @ torch.cat(ws, dim=-1)
    q, k, v = ek.qkv_heads(y, *bs, h)
    assert q.shape == (b, t, h, d // h) and k.shape == v.shape == (b, h, t, d // h)
    assert k.is_contiguous() and v.is_contiguous()
    for i, (got, name) in enumerate([(q, "q"), (k.transpose(1, 2), "k"), (v.transpose(1, 2), "v")]):
        # JAX's bias add on the same third of the product: bit for bit
        same = (jnp_bf16(y[..., i * d:(i + 1) * d]) + jnp_bf16(bs[i])).reshape(b, t, h, d // h)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(same.astype(jnp.float32)),
                                      err_msg=name)
        # JAX's own product (another f32 accumulation order)
        ref = (jnp_bf16(xin) @ jnp_bf16(ws[i]) + jnp_bf16(bs[i])).reshape(b, t, h, d // h)
        assert_bf16_close(got.contiguous(), np.asarray(ref.astype(jnp.float32)), name)


@pytest.mark.parametrize("fn", ["add_layer_norm", "bias_gelu", "qkv_heads"])
def test_plain_versions_in_f32_compute(fn):
    """f32 compute (the encoder's checking mode, where the plain versions
    run on every device): each against JAX's f32 arithmetic at 1e-5, its
    outputs f32."""
    rng = np.random.default_rng(14)
    f32 = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    if fn == "add_layer_norm":
        resid, dl, bias, w, b = f32(32, D, s=3), f32(32, D), f32(D, s=0.2), f32(D), f32(D)
        ref = np.asarray(je._ln(jnp.asarray(resid) + (jnp.asarray(dl) + jnp.asarray(bias)),
                                jnp.asarray(w), jnp.asarray(b), 1e-12))
        out, xin = ek.add_layer_norm_plain(*map(torch.from_numpy, (resid, dl, bias, w, b)), 1e-12,
                                           dt=torch.float32)
        assert xin.dtype == torch.float32 and torch.equal(xin, out)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    elif fn == "bias_gelu":
        h, bias = f32(16, 256, s=2.5), f32(256, s=0.5)
        ref = np.asarray(jax.nn.gelu(jnp.asarray(h) + jnp.asarray(bias), approximate=False))
        got = ek.bias_gelu_plain(torch.from_numpy(h), torch.from_numpy(bias))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        y, bq, bk, bv = f32(2, 5, 3 * 128), f32(128), f32(128), f32(128)
        q, k, v = ek.qkv_heads_plain(*map(torch.from_numpy, (y, bq, bk, bv)), 2)
        for i, (got, bias) in enumerate([(q, bq), (k.transpose(1, 2), bk),
                                         (v.transpose(1, 2), bv)]):
            ref = (y[..., i * 128:(i + 1) * 128] + bias).reshape(2, 5, 2, 64)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref)


def ragged_mask(b: int, t: int, rng) -> np.ndarray:
    """Ragged lengths with a length-1 row and an all-padding row."""
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0], lengths[1], lengths[-1] = t, 1, 0
    return np.arange(t)[None, :] < lengths[:, None]


def jax_attention(q, k, v, mask, dt):
    """JAX encoder ``:119-123`` on q, k, v ``[B, T, H, hd]`` (f32 output
    before the cast)."""
    hd = q.shape[-1]
    attn_mask = mask[:, None, None, :].astype(jnp.float32)
    scores = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32)
    scores = scores / np.sqrt(hd) + (1.0 - attn_mask) * jnp.float32(-1e30)
    probs = jax.nn.softmax(scores, -1).astype(dt)
    out = jnp.einsum("bhts,bshd->bthd", probs, v, preferred_element_type=jnp.float32)
    return np.asarray(out.reshape(q.shape[0], q.shape[1], -1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [9, 130])
def test_encoder_attention_matches_jax(dt, t):
    """``prefill_attention`` with ``qpos = kpos = 0`` and ``valid`` the
    key mask (head dim 64, G 1) against JAX's attention: f32 at 1e-6, bf16
    within ``rounding_tolerance``; the all-padding row is the mean of v;
    the bf16 store is the f32 output rounded."""
    rng = np.random.default_rng(t)
    b, h, hd = 5, 2, 64
    tdt, jdt = (torch.float32, jnp.float32) if dt == "f32" else (torch.bfloat16, jnp.bfloat16)
    qn, kn, vn = (rng.standard_normal((b, t, h, hd)).astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    mask = ragged_mask(b, t, rng)
    ref = jax_attention(*(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v)),
                        jnp.asarray(mask), jdt)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    pos = torch.zeros((b, t), dtype=torch.int32)
    valid = torch.from_numpy(mask)
    got = at.prefill_attention(q, kh, vh, pos, pos, valid, dt=tdt)
    assert got.shape == (b, t, h * hd) and got.dtype == torch.float32
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:
        dense = at.structured_mask(pos, pos, valid)
        tol = at.rounding_tolerance(q, kh, vh, dense, dt=tdt)
        assert (torch.from_numpy(ref) - got).abs().le(tol).all()
        got16 = at.prefill_attention(q, kh, vh, pos, pos, valid, dt=tdt, out_dtype=torch.bfloat16)
        assert got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))
    # the all-padding row: uniform weights over all T keys
    w = torch.tensor(1.0 / t).to(tdt).float()
    mean_v = (w * v[-1].float().sum(0)).reshape(-1)
    np.testing.assert_allclose(got[-1].numpy(), mean_v.expand(t, -1).numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------- the whole encoder


def small_configs():
    """The JAX and port configs at a width the kernels take: d 128, 2 heads
    of 64, 2 layers, d_ff 256."""
    kw = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=256, max_positions=64)
    return je.EncoderConfig(**kw), te.EncoderConfig(**kw)


@pytest.fixture(scope="module")
def small_params():
    jcfg, _ = small_configs()
    return jax.tree_util.tree_map(np.asarray, je.init_encoder_params(jcfg, jax.random.PRNGKey(5)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_on_the_kernels_route_matches_jax(small_params, dtype, monkeypatch):
    """``encoder_forward`` at head dim 64 against JAX, at
    ``test_torch_encoder.py``'s tolerances; bf16 takes the kernels' route
    (``qkv_heads``, ``prefill_attention``, ``bias_gelu`` once a layer,
    ``add_layer_norm`` 2 L + 1 times), f32 the plain versions. The width is
    admitted to ``KERNEL_WIDTHS`` here: on the CPU each wrapper takes its
    plain version, so the route runs at a width the kernels do not build."""
    jcfg, tcfg = small_configs()
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    monkeypatch.setattr(ek, "KERNEL_WIDTHS", ek.KERNEL_WIDTHS + ((128, 2, 256),))
    assert ek.kernels_take(tcfg.d_model, tcfg.n_heads, tcfg.d_ff)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, size=(4, 14)).astype(np.int32)
    mask = ragged_mask(4, 14, rng)
    ref = np.asarray(je.encoder_forward(jax.tree_util.tree_map(jnp.asarray, small_params),
                                        jnp.asarray(tokens), jnp.asarray(mask), jcfg))
    calls = {}

    def counted(name):
        fn = getattr(te, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("add_layer_norm", "bias_gelu", "qkv_heads", "prefill_attention"):
        monkeypatch.setattr(te, name, counted(name))
    params = te.prepare_params(encoder_params_from_jax(small_params, tcfg, device="cpu"), tcfg)
    got = te.encoder_forward(params, torch.from_numpy(tokens).long(), torch.from_numpy(mask),
                             tcfg).numpy()
    assert got.shape == ref.shape == (4, 128) and np.isfinite(got).all()
    if dtype == "f32":
        assert calls == {}
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        L = tcfg.n_layers
        assert calls == {"add_layer_norm": 2 * L + 1, "bias_gelu": L, "qkv_heads": L,
                         "prefill_attention": L}
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max()


def test_fuse_qkv_is_made_once(small_params):
    """``prepare_params`` concatenates wq | wk | wv once, in place of the
    three, casts the products' weights and biases to the compute type and
    the norms' to f32; a prepared tree comes back with its own tensors."""
    _, tcfg = small_configs()
    p = encoder_params_from_jax(small_params, tcfg, device="cpu")
    prepared = te.prepare_params(p, tcfg)
    lp = prepared["layers"]
    assert lp["wqkv"].shape == (2, 128, 384) and not {"wq", "wk", "wv"} & set(lp)
    torch.testing.assert_close(lp["wqkv"][:, :, 128:256], p["layers"]["wk"].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert all(lp[n].dtype == torch.bfloat16 for n in ("wqkv", "wo", "w1", "w2", "bq", "b2"))
    assert lp["attn_ln"]["w"].dtype == prepared["embed_ln"]["b"].dtype == torch.float32
    again = te.prepare_params(prepared, tcfg)["layers"]
    assert all(again[n] is lp[n] for n in ("wqkv", "wo", "w1", "w2", "bq", "b2"))
    assert again["mlp_ln"]["w"] is lp["mlp_ln"]["w"] and "wqkv" not in p["layers"]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU tensors run the plain versions without loading the library; no
    launch is counted."""

    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    bf = torch.bfloat16
    ek.add_layer_norm(torch.randn(4, 64), torch.randn(4, 64).to(bf), torch.zeros(64, dtype=bf),
                      torch.ones(64), torch.zeros(64), 1e-12)
    ek.bias_gelu(torch.randn(3, 16).to(bf), torch.zeros(16, dtype=bf))
    ek.qkv_heads(torch.randn(1, 2, 48).to(bf), *(torch.zeros(16, dtype=bf),) * 3, 2)
    assert all(kernels.LAUNCHES[n] == 0 for n in ("layer_norm", "bias_gelu", "qkv_heads"))


def _bad_calls():
    bf = torch.bfloat16
    x, w = torch.randn(4, 64), torch.ones(64)
    dl, bias = torch.randn(4, 64).to(bf), torch.zeros(64, dtype=bf)
    y, bq = torch.randn(1, 2, 48).to(bf), torch.zeros(16, dtype=bf)
    return {
        "ln bf16 resid": lambda: ek.add_layer_norm(x.to(bf), dl, bias, w, w, 1e-12),
        "ln f32 delta": lambda: ek.add_layer_norm(x, dl.float(), bias, w, w, 1e-12),
        "ln delta without bias": lambda: ek.add_layer_norm(x, dl, None, w, w, 1e-12),
        "ln weight shape": lambda: ek.add_layer_norm(x, dl, bias, w[:32], w[:32], 1e-12),
        "ln bf16 weights": lambda: ek.add_layer_norm(x, dl, bias, w.to(bf), w.to(bf), 1e-12),
        "ln stride": lambda: ek.add_layer_norm(torch.randn(64, 4).T, None, None, w, w, 1e-12),
        "ln device": lambda: ek.add_layer_norm(x.to("meta"), None, None, w.to("meta"),
                                               w.to("meta"), 1e-12),
        "gelu f32": lambda: ek.bias_gelu(torch.randn(3, 16), torch.zeros(16)),
        "gelu bias shape": lambda: ek.bias_gelu(torch.randn(3, 16).to(bf), bias),
        "gelu stride": lambda: ek.bias_gelu(torch.randn(16, 3).to(bf).T, bias[:3].clone()),
        "qkv width": lambda: ek.qkv_heads(torch.randn(1, 2, 50).to(bf), bq, bq, bq, 2),
        "qkv bias": lambda: ek.qkv_heads(y, bq, bq, bias, 2),
        "qkv f32": lambda: ek.qkv_heads(y.float(), bq.float(), bq.float(), bq.float(), 2),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_refuse_what_no_version_takes(case, monkeypatch):
    """A bad dtype, shape, stride or device raises before either version
    runs: no launch is counted and the library is not loaded."""

    def no_library():
        raise AssertionError("the kernel library was loaded for a call that must raise")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()
    assert all(kernels.LAUNCHES[n] == 0 for n in ("layer_norm", "bias_gelu", "qkv_heads"))


# --------------------------------------------------------- the tolerances


def norm_case(rng, rows=64, d=D, offset=0.0):
    """The kernel's inputs: f32 residual rows (each with a common offset
    of ``offset`` plus a random one), bf16 delta and bias, f32 w and b."""
    x = (3 * rng.standard_normal((rows, d)) + rng.standard_normal((rows, 1))
         + offset).astype(np.float32)
    dl = bf16_np(rng.standard_normal((rows, d)))
    bias = bf16_np(0.2 * rng.standard_normal(d))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))
    return torch.from_numpy(x), dl, bias, w, b


def emulate_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """``layer_norm.cu``'s arithmetic in numpy f32 on the norm's input x
    [rows, d]: lane l sums its vectors l + 32 j in order, element by
    element; a butterfly of xor shuffles at 16, 8, .., 1 adds the lanes;
    the mean a division by d; the same for the squared deviations; then
    ``(x - mean) * rsqrt(var + eps) * w + b``, each step rounded."""
    xn = x.numpy().astype(np.float32)
    rows, d = xn.shape
    per = -(-(d // 4) // 32)
    padded = np.zeros((rows, per * 32 * 4), np.float32)
    padded[:, :d] = xn
    lanes = padded.reshape(rows, per, 32, 4).transpose(0, 2, 1, 3).reshape(rows, 32, per * 4)

    def warp_sum(v):  # v [rows, 32, k]: each lane's elements in its order
        s = np.zeros(v.shape[:2], np.float32)
        for e in range(v.shape[2]):
            s = (s + v[:, :, e]).astype(np.float32)
        for off in (16, 8, 4, 2, 1):
            s = (s + s[:, np.arange(32) ^ off]).astype(np.float32)
        return s[:, 0]

    fd = np.float32(d)
    mean = (warp_sum(lanes) / fd).astype(np.float32)[:, None]
    dev = (lanes - mean[:, :, None]).astype(np.float32)
    valid = (np.arange(per * 128).reshape(per, 32, 4).transpose(1, 0, 2).reshape(32, per * 4) < d)
    sq = np.where(valid[None], dev * dev, np.float32(0)).astype(np.float32)
    var = (warp_sum(sq) / fd).astype(np.float32)[:, None]
    r = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float64))).astype(np.float32)
    c = (xn - mean).astype(np.float32)
    y = ((c * r).astype(np.float32) * w.float().numpy()).astype(np.float32)
    return torch.from_numpy((y + b.float().numpy()).astype(np.float32))


def test_layer_norm_emulation_within_tolerance():
    """``layer_norm.cu``'s order of sums (``emulate_layer_norm``) within
    ``layer_norm_tolerance`` of the plain version, f32 and bf16, at D 768,
    on rows centred near 0 and on rows with a common offset of 64 (the
    mean's sum large against the deviations); a skipped bias add, a delta
    left unrounded and the unbiased variance fall outside it."""
    rng = np.random.default_rng(21)
    for offset in (0.0, 64.0):
        x, dl, bias, w, b = norm_case(rng, offset=offset)
        xs = x + (dl + bias).float()
        ref, ref16 = ek.add_layer_norm_plain(x, dl, bias, w, b, 1e-12)
        tol32, tol16 = ek.layer_norm_tolerance(xs, w, b, 1e-12)
        got = emulate_layer_norm(xs, w, b, 1e-12)
        assert (got - ref).abs().le(tol32).all()
        assert (got.to(torch.bfloat16).float() - ref16.float()).abs().le(tol16).all()
        faults = {
            "bias skipped": ek.layer_norm(x + dl.float(), w, b, 1e-12),
            "delta unrounded": ek.layer_norm(x + dl.float() + bias.float(), w, b, 1e-12),
            "unbiased variance": ((xs - xs.mean(-1, keepdim=True))
                                  * torch.rsqrt(xs.var(-1, keepdim=True) + 1e-12)
                                  * w.float() + b.float()),
        }
        for name, fault in faults.items():
            assert (fault - ref).abs().gt(tol32).any(), name


def test_gelu_tolerance_admits_the_plain_version_and_sees_faults():
    """The plain version lies within ``gelu_tolerance`` of itself; the
    tanh form and a skipped bias add lie outside it."""
    rng = np.random.default_rng(22)
    h = bf16_np(2 * rng.standard_normal((64, 256)))
    bias = bf16_np(0.3 * rng.standard_normal(256))
    tol = ek.gelu_tolerance(h, bias)
    ref = ek.bias_gelu_plain(h, bias).float()
    x = (h + bias).float()
    tanh = torch.nn.functional.gelu(x, approximate="tanh").to(torch.bfloat16).float()
    skipped = ek.gelu_exact(h.float()).to(torch.bfloat16).float()
    assert float(tol.max()) > 0 and (tol == 0).float().mean() > 0.9
    assert (tanh - ref).abs().gt(tol).any() and (skipped - ref).abs().gt(tol).any()


# --------------------------------------------------------- the GELU table


def all_patterns() -> torch.Tensor:
    """The 65,536 bf16 values, entry i the one whose bits are i."""
    return torch.arange(ek.GELU_TABLE, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module")
def gelu_table_bits():
    """``gelu_table_build`` emulated: the plain version over every bf16
    pattern, with bias -0.0 (bf16(h + -0.0) = h for every h)."""
    x = all_patterns()
    table = ek.bias_gelu_plain(x, torch.full((ek.GELU_TABLE,), -0.0, dtype=torch.bfloat16))
    return bits(table)


def window_of(table: np.ndarray) -> np.ndarray:
    """The block's window as ``bias_gelu_pass`` fills it: [sign][GELU_WIN_LEN]
    entries from GELU_WIN_LO of each sign's half of the table."""
    lo, n = ek.GELU_WIN_LO, ek.GELU_WIN_LEN
    return np.concatenate([table[lo:lo + n], table[0x8000 + lo:0x8000 + lo + n]])


def gelu_lookup(h: torch.Tensor, bias: torch.Tensor, table: np.ndarray):
    """``bias_gelu_pass``'s arithmetic: x = bf16(f32 h + f32 b), then its
    pattern's entry from the window where its magnitude bits lie in it,
    else from the table. Returns (the result's bits, which read the
    window)."""
    x = (h.float() + bias.float()).to(torch.bfloat16)
    u = bits(x).astype(np.uint32)
    off = ((u & 0x7FFF) - np.uint32(ek.GELU_WIN_LO)).astype(np.uint32)  # wraps, as in C
    hit = off < ek.GELU_WIN_LEN
    win = window_of(table)
    at = np.where(hit, (u >> 15) * ek.GELU_WIN_LEN + off, 0)
    return np.where(hit, win[at], table[u]), hit


def special_inputs() -> torch.Tensor:
    """+-0, +-inf, NaNs, subnormals, and the patterns either side of the
    window's edges, of both signs, as bf16."""
    lo, hi = ek.GELU_WIN_LO, ek.GELU_WIN_LO + ek.GELU_WIN_LEN
    mags = [0, 0x7F80, 0x7FC0, 0x7F81, 0x7FFF, 1, 2, 0x40, 0x7F, 0x80, lo - 1, lo, lo + 1,
            hi - 1, hi, hi + 1, 0x7F7F]
    u = np.array(mags + [m | 0x8000 for m in mags], np.uint16)
    return torch.from_numpy(u.view(np.int16).copy()).view(torch.bfloat16)


def assert_bits_equal(got: np.ndarray, ref: torch.Tensor, what: str) -> None:
    """``got`` bit-equal to ``ref`` (bf16), NaNs compared as NaN."""
    r = bits(ref)
    nan_g = np.isnan((got.astype(np.uint32) << 16).view(np.float32))
    nan_r = torch.isnan(ref.float()).numpy()
    np.testing.assert_array_equal(nan_g, nan_r, err_msg=f"{what}: NaNs differ")
    np.testing.assert_array_equal(got[~nan_r], r[~nan_r], err_msg=what)


def test_gelu_table_lookup_is_bit_equal_on_every_input(gelu_table_bits):
    """The table, the window and the lookup, as ``bias_gelu.cu`` builds and
    reads them, bit-equal to ``bias_gelu_plain`` on all 65,536 inputs, on
    the specials (+-0, +-inf, NaN as NaN, subnormals, the window's edges)
    with and without a bias, and on random h + b at three scales, where
    the window serves all but a few elements and the specials reach both
    the window and the table."""
    bf = torch.bfloat16
    x = all_patterns()
    zero = torch.full((ek.GELU_TABLE,), -0.0, dtype=bf)
    got, hit = gelu_lookup(x, zero, gelu_table_bits)
    assert_bits_equal(got, ek.bias_gelu_plain(x, zero), "all patterns")
    assert hit.sum() == 2 * ek.GELU_WIN_LEN
    sp = special_inputs()
    for b in (-0.0, 0.0, 1.5, -3.0, 2.0 ** -20):
        bias = torch.full(sp.shape, b, dtype=bf)
        got, hit = gelu_lookup(sp, bias, gelu_table_bits)
        assert_bits_equal(got, ek.bias_gelu_plain(sp, bias), f"specials, bias {b}")
        if b == 0.0:
            assert hit.any() and not hit.all()
    rng = np.random.default_rng(23)
    for scale in (2.0, 1e-3, 60.0):
        h = bf16_np(scale * rng.standard_normal((64, 512)))
        bias = bf16_np(0.5 * rng.standard_normal(512))
        got, hit = gelu_lookup(h, bias, gelu_table_bits)
        assert_bits_equal(got.reshape(h.shape), ek.bias_gelu_plain(h, bias), f"scale {scale}")
        assert ek.gelu_window_misses((h + bias)) == int((~hit).sum())
        if scale == 2.0:
            assert hit.mean() > 0.999


@pytest.mark.parametrize("rows,f,sms", [(3, 24, 2), (40, 16, 1), (7, 3072, 3), (1, 8, 132)])
def test_bias_gelu_walk_takes_every_vector_once(rows, f, sms):
    """``bias_gelu_pass``'s walk carried out over the plan's grid: every
    vector is looked up and stored once, by the thread that loaded it,
    and the column kept by adds is the vector's ``i mod (f / 8)``."""
    plan = ek.plan_bias_gelu(rows, f, sms)
    vecs, row_vecs = rows * f // 8, f // 8
    stride = plan.blocks * plan.threads * plan.unroll
    step_col = stride % row_vecs
    seen = np.zeros(vecs, np.int64)
    for blk in range(plan.blocks):
        for tid in range(plan.threads):
            i0 = blk * plan.threads * plan.unroll + tid
            col = [(i0 + u * plan.threads) % row_vecs for u in range(plan.unroll)]
            while i0 < vecs:
                for u in range(plan.unroll):
                    i = i0 + u * plan.threads
                    if i < vecs:
                        assert col[u] == i % row_vecs
                        seen[i] += 1
                    col[u] += step_col
                    if col[u] >= row_vecs:
                        col[u] -= row_vecs
                i0 += stride
    assert (seen == 1).all()


# --------------------------------------------------------- the planners


RULES = {  # source, namespace, shim
    "lnorm": ("layer_norm.cu", """
extern "C" int ln_plan(long long rows, int d, int* out) {
  lnorm::Plan p;
  if (!lnorm::plan(rows, d, &p)) return 0;
  out[0] = p.per; out[1] = p.warps; out[2] = p.blocks;
  return 1;
}
extern "C" int ln_accepts(long long rows, int d, int a, int b, int c) {
  lnorm::Plan p;
  return lnorm::accepts(rows, d, a, b, c, &p);
}
"""),
    "bgelu": ("bias_gelu.cu", """
extern "C" int gelu_plan(long long rows, int f, int sms, int* out) {
  bgelu::Plan p;
  if (!bgelu::plan(rows, f, sms, &p)) return 0;
  out[0] = p.vec; out[1] = p.threads; out[2] = p.blocks;
  out[3] = p.unroll; out[4] = p.win_lo; out[5] = p.win_len;
  return 1;
}
extern "C" int gelu_accepts(long long rows, int f, int sms, int a, int b, int c, int d, int e,
                            int g) {
  bgelu::Plan p;
  return bgelu::accepts(rows, f, sms, a, b, c, d, e, g, &p);
}
"""),
    "qkvh": ("qkv_heads.cu", """
extern "C" int qkv_plan(long long b, long long t, int h, int hd, int* out) {
  qkvh::Plan p;
  if (!qkvh::plan(b, t, h, hd, &p)) return 0;
  out[0] = p.vec; out[1] = p.threads; out[2] = p.blocks;
  return 1;
}
extern "C" int qkv_accepts(long long b, long long t, int h, int hd, int x, int y, int z) {
  qkvh::Plan p;
  return qkvh::accepts(b, t, h, hd, x, y, z, &p);
}
"""),
}


@pytest.fixture(scope="module")
def rules(tmp_path_factory):
    """The three C entries' rules (host code only), compiled with g++ from
    the sources the card builds, in one library."""
    csrc = Path(ek.__file__).resolve().parents[1] / "kernels" / "csrc"
    text = ""
    for ns, (src, shim) in RULES.items():
        body = (csrc / src).read_text()
        text += body[body.index(f"namespace {ns} {{"):body.index(f"}}  // namespace {ns}")] + "}\n"
        text += shim
    d = tmp_path_factory.mktemp("encoder_rules")
    cpp, so = d / "rules.cpp", d / "rules.so"
    cpp.write_text(text)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", str(cpp), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.ln_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ln_accepts.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
    lib.gelu_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
    lib.gelu_accepts.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 8
    lib.qkv_plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
    lib.qkv_accepts.argtypes = [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5
    return lib


def c_plan(fn, *args, n=3):
    out = (ctypes.c_int * n)()
    return tuple(out) if fn(*args, out) else None


SMS = 132  # the H100's SMs


def held_to_rule(plan, plan_fn, accepts, args):
    """``plan`` is the C rule's own for ``args``, the entry takes it, and
    refuses it with any one field changed."""
    assert c_plan(plan_fn, *args, n=len(plan)) == tuple(plan)
    assert accepts(*args, *plan)
    for i in range(len(plan)):
        other = list(plan)
        other[i] += 1
        assert not accepts(*args, *other), (plan, i)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plans_are_the_entries_rules(shape, rules):
    """At the index build's, T 512's and a query batch's shapes, each
    planner's plan is its C entry's own and the entry takes it; every
    field changed, the entry refuses it. The build's geometry: D 768 a
    warp of 6 vectors a lane, 4 rows a block; the GELU 4 resident blocks
    of 256 an SM (fewer where one step a thread covers the rows), the
    window |x| in [2^-16, 2^8); q/k/v one thread a vector of 8."""
    b, t = SHAPES[shape]
    rows = b * t
    held_to_rule(ek.plan_layer_norm(rows, D), rules.ln_plan, rules.ln_accepts, (rows, D))
    held_to_rule(ek.plan_bias_gelu(rows, F, SMS), rules.gelu_plan, rules.gelu_accepts,
                 (rows, F, SMS))
    held_to_rule(ek.plan_qkv_heads(b, t, H, HD), rules.qkv_plan, rules.qkv_accepts,
                 (b, t, H, HD))
    ln = ek.plan_layer_norm(rows, D)
    assert (ln.per, ln.warps, ln.blocks) == (6, 4, -(-rows // 4))
    gelu = ek.plan_bias_gelu(rows, F, SMS)
    vecs = rows * F // 8
    step = ek.GELU_THREADS * ek.GELU_UNROLL  # vectors a block's step
    assert gelu.blocks == min(ek.GELU_BLOCKS_PER_SM * SMS, -(-vecs // step))
    assert (gelu.vec, gelu.threads, gelu.unroll) == (8, ek.GELU_THREADS, ek.GELU_UNROLL)
    assert np.float32(2.0 ** -16).view(np.uint32) >> 16 == gelu.win_lo
    assert np.float32(2.0 ** 8).view(np.uint32) >> 16 == gelu.win_lo + gelu.win_len
    assert ek.plan_qkv_heads(b, t, H, HD).blocks == -(-rows * (D // 8) // 128)


# the most rows of 3072 whose vector indices (and a grid step past the
# last) stay within 32 bits on 132 SMs
LAST_ROWS = ((2**31 - 1) - 132 * ek.GELU_BLOCKS_PER_SM * ek.GELU_THREADS * ek.GELU_UNROLL) // 384
# rows of 3072 whose vectors give every resident block of 132 SMs one step
FULL_WAVE = 132 * ek.GELU_BLOCKS_PER_SM * ek.GELU_THREADS * ek.GELU_UNROLL // 384


@pytest.mark.parametrize("rows,f,sms", [
    (1, 8, 132),  # one vector
    (64, 8, 132),  # one block's step
    (65, 8, 132),  # one vector past it
    (FULL_WAVE, 3072, 132),  # every resident block one step
    (FULL_WAVE + 1, 3072, 132),  # one row more: the cap
    (8 * 40, 3072, 1),  # one SM
    (512 * 376, 3072, 114),  # another card's SM count
    (LAST_ROWS, 3072, 132),  # the most rows within 32-bit vector indices
])
def test_bias_gelu_plan_at_edges(rows, f, sms, rules):
    """At edge shapes and SM counts the planner's plan is the entry's own,
    with at most ``GELU_BLOCKS_PER_SM`` blocks an SM and no block without a
    vector."""
    plan = ek.plan_bias_gelu(rows, f, sms)
    held_to_rule(plan, rules.gelu_plan, rules.gelu_accepts, (rows, f, sms))
    vecs = rows * f // 8
    assert 1 <= plan.blocks <= sms * ek.GELU_BLOCKS_PER_SM
    assert (plan.blocks - 1) * plan.threads * plan.unroll < vecs


@pytest.mark.parametrize("kind,args", [
    ("ln", (16, 1028)), ("ln", (16, 6)), ("ln", (0, 768)), ("ln", (16, 512)),
    ("gelu", (16, 3070, 132)), ("gelu", (2**28, 3072, 132)), ("gelu", (16, 3072, 0)),
    ("gelu", (LAST_ROWS + 1, 3072, 132)),
    ("qkv", (2, 10, 12, 12)), ("qkv", (8192, 4096, 12, 64)),
])
def test_planners_refuse_what_the_entries_refuse(kind, args, rules):
    """A width the kernel does not take (the norm's row other than 768, a
    GELU row or head dim not of 8-wide vectors) or a grid past 32-bit
    thread indices: the planner raises and the entry has no plan."""
    planner, fn, n = {"ln": (ek.plan_layer_norm, rules.ln_plan, 3),
                      "gelu": (ek.plan_bias_gelu, rules.gelu_plan, 6),
                      "qkv": (ek.plan_qkv_heads, rules.qkv_plan, 3)}[kind]
    with pytest.raises(ValueError):
        planner(*args)
    assert c_plan(fn, *args, n=n) is None


@pytest.mark.parametrize("b,t,h,hd", [(3, 7, 2, 64), (2, 130, 12, 64), (1, 5, 3, 16)])
def test_qkv_kernel_indexing_lays_out_the_plain_tensors(b, t, h, hd):
    """``qkv_heads_pass``'s index expressions carried out in numpy over the
    whole grid: each thread's three loads and stores; q, k and v equal the
    plain version's, and every element is stored once."""
    d = h * hd
    plan = ek.plan_qkv_heads(b, t, h, hd)
    dv, hv = d // 8, hd // 8
    i = np.arange(plan.blocks * plan.threads)
    i = i[i < b * t * dv]
    n, c = i // dv, i % dv
    head, lane = c // hv, c % hv
    bi, ti = n // t, n % t
    slot = ((bi * h + head) * t + ti) * hv + lane
    y = np.arange(b * t * 3 * d, dtype=np.float32).reshape(b * t, 3 * dv, 8)  # ids as values
    q = np.full((b * t * dv, 8), -1.0, np.float32)
    k, v = q.copy(), q.copy()
    q[i] = y[n, c]
    k[slot] = y[n, dv + c]
    v[slot] = y[n, 2 * dv + c]
    assert len(np.unique(slot)) == len(slot) == b * t * dv
    yt = torch.from_numpy(y.reshape(b, t, 3 * d))
    zero = torch.zeros(d)
    rq = (yt[..., :d] + zero).reshape(b, t, h, hd)
    rk = (yt[..., d:2 * d] + zero).reshape(b, t, h, hd).transpose(1, 2)
    rv = (yt[..., 2 * d:] + zero).reshape(b, t, h, hd).transpose(1, 2)
    np.testing.assert_array_equal(q.reshape(b, t, h, hd), rq.numpy())
    np.testing.assert_array_equal(k.reshape(b, h, t, hd), rk.numpy())
    np.testing.assert_array_equal(v.reshape(b, h, t, hd), rv.numpy())


def test_kernels_take_contriever_not_tiny():
    """Contriever's width takes the kernels' route; the tiny config (head
    dim 16), the small test width and widths the card has not checked
    (BERT-large's 1024, a norm row over 1024) do not."""
    c, tiny = te.EncoderConfig.contriever(), te.EncoderConfig.tiny()
    assert ek.kernels_take(c.d_model, c.n_heads, c.d_ff)
    assert not ek.kernels_take(tiny.d_model, tiny.n_heads, tiny.d_ff)
    assert not ek.kernels_take(128, 2, 256)
    assert not ek.kernels_take(1024, 16, 4096)
    assert not ek.kernels_take(2048, 32, 8192)


# --------------------------------------------------------- the CLI


@pytest.mark.parametrize("checkpoint,width", [("ckpt", 768), (None, 32)])
def test_cli_dense_encoder_width(checkpoint, width):
    """``_dense_encoder`` builds Contriever's width under ``--checkpoint``,
    as the JAX CLI does, and the tiny encoder without it."""
    from probing_rag_tpu_torch.cli.main import _dense_encoder

    encode = _dense_encoder(argparse.Namespace(checkpoint=checkpoint, device="cpu"))
    out = encode(["a short text", "another one, a little longer"])
    assert out.shape == (2, width) and np.isfinite(out).all()
