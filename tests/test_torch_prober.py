"""The port's prober gate and checkpoint reader against the JAX package.

Gate: numpy-drawn stacked prober params and pooled activations through
both ``gate_decision``s; retrieve bits equal, ensemble scores allclose at
rtol 1e-5 / atol 1e-5 (f32 MLPs, sums in another order). Inputs are drawn
so that no ensemble score lands within 1e-3 of a threshold."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from probing_rag_tpu.prober import gate as jgate
from probing_rag_tpu.prober.model import init_improved_probe as jax_init_probe
from probing_rag_tpu.prober.train import ProberTrainConfig as JaxProberTrainConfig
from probing_rag_tpu.prober.train import init_prober_stack as jax_init_stack
from probing_rag_tpu.utils.checkpoint import save_pytree
from probing_rag_tpu_torch.prober import gate as tgate
from probing_rag_tpu_torch.prober.train import ProberTrainConfig, init_prober_stack
from probing_rag_tpu_torch.utils.checkpoint import load_pytree
from probing_rag_tpu_torch.weights import probers_from_jax

torch.set_num_threads(1)


def numpy_stack(n, d, seed=0, hidden=512):
    rng = np.random.default_rng(seed)

    def lin(i, o):
        b = 1 / np.sqrt(i)
        return {"w": rng.uniform(-b, b, (n, i, o)).astype(np.float32),
                "b": rng.uniform(-b, b, (n, o)).astype(np.float32)}

    def ln(k):
        return {"w": (1 + 0.1 * rng.standard_normal((n, k))).astype(np.float32),
                "b": (0.1 * rng.standard_normal((n, k))).astype(np.float32)}

    return {"ln_in": ln(d), "fc1": lin(d, hidden), "ln1": ln(hidden),
            "fc2": lin(hidden, hidden), "ln2": ln(hidden), "fc3": lin(hidden, 2)}


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("ablation", [0, 2])
def test_gate_matches_jax(ablation):
    n, b, d = 4, 16, 64
    tree = numpy_stack(n, d)
    pooled = (np.random.default_rng(1).standard_normal((n, b, d)) * 20).astype(np.float32)
    j_logits = jgate.prober_ensemble_logits(to_jax(tree), jnp.asarray(pooled))
    t_logits = tgate.prober_ensemble_logits(probers_from_jax(tree, device="cpu"), torch.from_numpy(pooled))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    for threshold in (-1e6, -0.3, 0.0, 0.25, 1e6):
        jr, js = jgate.gate_decision(to_jax(tree), jnp.asarray(pooled),
                                     threshold=threshold, ablation=ablation)
        tr, ts = tgate.gate_decision(probers_from_jax(tree, device="cpu"), torch.from_numpy(pooled),
                                     threshold=threshold, ablation=ablation)
        js = np.asarray(js)
        assert (np.abs(js[:, 0] + threshold - js[:, 1]) > 1e-3).all()
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
    assert tr.numpy().all()  # threshold 1e6: always retrieve


def test_prober_stack_layout_matches_jax():
    tc = ProberTrainConfig(layers=(1, 2, 3), positions=("resid_post",))
    jtc = JaxProberTrainConfig(layers=(1, 2, 3), positions=("resid_post",))
    assert tc.sites == jtc.sites
    t = init_prober_stack(tc, 2048, torch.Generator().manual_seed(0), device="cpu")
    import jax

    j = jax_init_stack(jtc, 2048, jax.random.PRNGKey(0))
    shapes = lambda tree: {(m, k): tuple(v.shape) for m, s in tree.items() for k, v in s.items()}
    assert shapes(t) == shapes(j)
    one = jax_init_probe(jax.random.PRNGKey(0), 2048)
    assert sum(v.numel() for s in t.values() for v in s.values()) == 3 * 1_318_914
    assert sum(int(np.prod(v.shape)) for s in one.values() for v in s.values()) == 1_318_914
    # torch.nn.Linear's default init range
    w = t["fc1"]["w"]
    assert float(w.abs().max()) <= 1 / np.sqrt(2048) and float(w.std()) > 0


def test_load_pytree_reads_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(2)
    tree = {
        "probers": numpy_stack(2, 8, seed=3, hidden=4),
        "lm": {"embed": jnp.asarray(rng.standard_normal((5, 3)), dtype=jnp.bfloat16),
               "steps": jnp.arange(4, dtype=jnp.int32)},
    }
    save_pytree(tmp_path / "ckpt", tree, meta={"sites": [[1, "resid_post"]]})
    got, meta = load_pytree(tmp_path / "ckpt")
    assert meta == {"sites": [[1, "resid_post"]]}
    assert got["lm"]["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["lm"]["embed"].float().numpy(),
        np.asarray(tree["lm"]["embed"]).astype(ml_dtypes.bfloat16).astype(np.float32),
    )
    np.testing.assert_array_equal(got["lm"]["steps"].numpy(), np.arange(4))
    for m, sub in tree["probers"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(got["probers"][m][k].numpy(), v)
    # a loaded stack drives the gate like the JAX arrays do
    pooled = np.random.default_rng(4).standard_normal((2, 3, 8)).astype(np.float32)
    jr, js = jgate.gate_decision(to_jax(tree["probers"]), jnp.asarray(pooled))
    tr, ts = tgate.gate_decision(probers_from_jax(got["probers"], device="cpu"), torch.from_numpy(pooled))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
