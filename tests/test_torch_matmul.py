"""The w8a16 product (probing_rag_tpu_torch.ops.matmul) against the JAX
package's ``ops/pallas_matmul.py::matmul_int8`` in interpret mode and
against ``models/gemma.py::_mm``'s XLA form, on the CPU, where the wrapper
takes its plain version.

Inputs are drawn with numpy from a seed. Tolerances: f32 rtol/atol 1e-5
(the same f32 sums in another order); bf16 rtol/atol 0.05, the bound of
``tests/test_pallas_matmul.py`` (one bf16 rounding of the product and one
of the scaled result, each up to 2^-8 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probing_rag_tpu.models.gemma import _mm as jax_mm
from probing_rag_tpu.ops.pallas_matmul import matmul_int8 as jax_matmul_int8
from probing_rag_tpu_torch.ops.matmul import matmul_int8, matmul_int8_plain

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
