"""The port's prober training (``prober/train.py``, ``prober/model.py``)
against the JAX package's, on the CPU with numpy-drawn inputs.

Tolerances (f32 unless stated): losses and pooled vectors rtol 1e-5; the
per-site gradients of one step allclose at rtol 1e-4 / atol 1e-5 of the
leaf's largest gradient (f32 sums in another order). Parameters after three steps are held at 1e-5
absolute with both sides in float64: in f32 an element whose gradient is
near 1e-9 moves by Adam's g / (|g| + 1e-8), which a last-bit difference
in g swings by up to the learning rate, so only float64 holds the step's
arithmetic (moments, bias correction, decay, weight decay, schedule) to
1e-5. Dropout cannot match JAX mask for mask (another generator): the
equality tests run both sides with dropout off, and the port's dropout is
checked on its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probing_rag_tpu.prober.train as jtrain
import probing_rag_tpu_torch.prober.train as ttrain
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from probing_rag_tpu.prober import model as jmodel
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models.tokenizer import ByteTokenizer
from probing_rag_tpu_torch.prober import model as tmodel
from probing_rag_tpu_torch.weights import lm_params_from_jax, probers_from_jax

from test_torch_gemma import numpy_params, to_jax
from test_torch_prober import numpy_stack

torch.set_num_threads(1)

METHODS = ("tokens_mean", "last_token", "each_token")
SITES = dict(layers=(1, 2), positions=("resid_mid", "resid_post"))


def copy_tree(tree, dtype=None):
    """numpy copies of a JAX (or numpy) tree: the port updates in place."""
    return {k: copy_tree(v, dtype) if isinstance(v, dict) else np.array(v, dtype=dtype, copy=True)
            for k, v in tree.items()}


def jax_stack(n_sites, d, seed=0):
    tc = jtrain.ProberTrainConfig(layers=tuple(range(n_sites)), positions=("resid_post",))
    return copy_tree(jtrain.init_prober_stack(tc, d, jax.random.PRNGKey(seed)))


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages' training forwards with dropout off."""
    jfwd = jtrain.improved_probe_forward
    tfwd = ttrain.improved_probe_forward
    monkeypatch.setattr(jtrain, "improved_probe_forward", lambda p, x, dropout_rng=None: jfwd(p, x))
    monkeypatch.setattr(ttrain, "improved_probe_forward", lambda p, x, generator=None: tfwd(p, x))


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("branch", ["double_softmax", "standard", "bce", "bce_weighted",
                                    "double_softmax_weighted"])
def test_probe_loss_matches_jax(branch):
    rng = np.random.default_rng(1)
    c = 1 if branch.startswith("bce") else 2
    logits = (3 * rng.standard_normal((16, c))).astype(np.float32)
    labels = rng.integers(0, 2, 16).astype(np.int32)
    weights = (rng.random(16) < 0.6).astype(np.float32) if branch.endswith("weighted") else None
    ds = branch != "standard"
    j = jtrain.probe_loss(jnp.asarray(logits), jnp.asarray(labels), ds,
                          None if weights is None else jnp.asarray(weights))
    t = ttrain.probe_loss(torch.from_numpy(logits), torch.from_numpy(labels), ds,
                          None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    # a stack: one loss per leading index, each the 2-D loss of its slice
    stacked = np.stack([logits, -logits, 2 * logits])
    ts = ttrain.probe_loss(torch.from_numpy(stacked), torch.from_numpy(labels), ds,
                           None if weights is None else torch.from_numpy(weights))
    for i in range(3):
        ji = jtrain.probe_loss(jnp.asarray(stacked[i]), jnp.asarray(labels), ds,
                               None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(float(ts[i]), float(ji), rtol=1e-5)


def test_probe_loss_all_weights_zero_is_finite():
    t = ttrain.probe_loss(torch.ones(4, 2), torch.zeros(4, dtype=torch.int64), True, torch.zeros(4))
    assert float(t) == 0.0


# --------------------------------------------------------------- pooling


@pytest.mark.parametrize("name", sorted(ttrain.POOLERS))
def test_poolers_match_jax(name):
    rng = np.random.default_rng(2)
    acts = rng.standard_normal((3, 5, 12, 16)).astype(np.float32)  # [sites, B, T, D]
    pred_lens = np.asarray([1, 4, 12, 0, 7], np.int32)
    t = ttrain.POOLERS[name](torch.from_numpy(acts), torch.from_numpy(pred_lens).long())
    assert t.shape == (3, 5, 16)
    for s in range(3):
        j = jtrain.POOLERS[name](jnp.asarray(acts[s]), jnp.asarray(pred_lens))
        np.testing.assert_allclose(t[s].numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- model


def test_probe_param_count_and_linear_probe():
    gen = torch.Generator().manual_seed(0)
    assert tmodel.probe_param_count(tmodel.init_improved_probe(gen, 2048, device="cpu")) == 1_318_914
    lin = tmodel.init_linear_probe(gen, 64, device="cpu")
    jlin = jmodel.init_linear_probe(jax.random.PRNGKey(0), 64)
    assert tmodel.probe_param_count(lin) == jmodel.probe_param_count(jlin) == 64 * 2 + 64 * 2 + 2
    # the same weights give the same logits
    tree = {"ln": {"w": (1 + 0.1 * np.arange(64)).astype(np.float32), "b": np.full(64, 0.3, np.float32)},
            "fc": {"w": np.random.default_rng(3).standard_normal((64, 2)).astype(np.float32),
                   "b": np.asarray([0.5, -0.5], np.float32)}}
    x = np.random.default_rng(4).standard_normal((7, 64)).astype(np.float32)
    t = tmodel.linear_probe_forward({m: {k: torch.from_numpy(v) for k, v in s.items()}
                                     for m, s in tree.items()}, torch.from_numpy(x))
    j = jmodel.linear_probe_forward(to_jax(tree), jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    bound = 1 / np.sqrt(64)
    assert float(lin["fc"]["w"].abs().max()) <= bound and float(lin["ln"]["w"].min()) == 1.0


def test_dropout_keep_rate_scaling_repeatability_and_eval():
    """Dropout 0.1 after ln1 and ln2: ~90% kept, kept ones scaled by 1/0.9
    (the mean is preserved), the same masks under one seed, none without
    a generator."""
    x = torch.randn(200_000)
    gen = torch.Generator().manual_seed(7)
    y = tmodel._dropout(x, gen, 0.1)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.9)
    ones = tmodel._dropout(torch.ones(200_000), torch.Generator().manual_seed(8), 0.1)
    assert abs(float(ones.mean()) - 1.0) < 0.01
    torch.testing.assert_close(tmodel._dropout(x, torch.Generator().manual_seed(7), 0.1), y)
    assert tmodel._dropout(x, None, 0.1) is x

    tree = probers_from_jax(numpy_stack(3, 16), device="cpu")
    inp = torch.randn(3, 5, 16)
    eval_out = tmodel.improved_probe_forward(tree, inp)
    torch.testing.assert_close(tmodel.improved_probe_forward(tree, inp), eval_out)
    a = tmodel.improved_probe_forward(tree, inp, generator=torch.Generator().manual_seed(1))
    b = tmodel.improved_probe_forward(tree, inp, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, eval_out)


# ------------------------------------------------------------ train step


def batches(n_sites, d, seed, steps=3, b=8, t=12):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (rng.standard_normal((n_sites, b, t, d)).astype(np.float32),
               rng.integers(0, 2, b).astype(np.int32), rng.integers(1, t + 1, b).astype(np.int32))


def jax_step_grads(stack, caps, labels, pred_lens, tc):
    def site_loss(p, a):
        return jtrain._one_prober_loss(p, a, jnp.asarray(labels), jnp.asarray(pred_lens), None, tc)

    return jax.vmap(jax.value_and_grad(site_loss))(stack, jnp.asarray(caps))


@pytest.mark.parametrize("double_softmax", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_train_step_losses_and_grads_match_jax(method, double_softmax, no_dropout):
    """Three f32 steps from one init: at each step's parameters, the
    per-site losses and gradients against JAX's vmapped value_and_grad;
    and each step's losses against JAX's ``prober_train_step``."""
    d = 32
    jtc = jtrain.ProberTrainConfig(**SITES, method=method, double_softmax=double_softmax)
    ttc = ttrain.ProberTrainConfig(**SITES, method=method, double_softmax=double_softmax)
    init = jax_stack(4, d)
    jparams, opt = to_jax(init), jtrain.make_optimizer(jtc)
    jstate = opt.init(jparams)
    tparams = probers_from_jax(copy_tree(init), device="cpu")
    tstate = ttrain.make_optimizer(ttc, tparams)
    for step, (caps, labels, pred_lens) in enumerate(batches(4, d, seed=5)):
        jl, jgrads = jax_step_grads(jparams, caps, labels, pred_lens, jtc)
        # the gradients at JAX's current parameters (the two runs' own
        # parameters part by Adam's sensitivity, tested in f64 below)
        at_j = {m: {k: torch.tensor(np.asarray(jparams[m][k])) for k in s}
                for m, s in tparams.items()}
        tl, tgrads = ttrain.site_losses_and_grads(
            at_j, torch.from_numpy(caps), torch.from_numpy(labels).long(),
            torch.from_numpy(pred_lens).long(), None, ttc)
        assert tl.shape == (4,)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        flat_j = [np.asarray(jgrads[m][k]) for m in tparams for k in tparams[m]]
        for g_t, g_j in zip(tgrads, flat_j):
            np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-5 * np.abs(g_j).max())

        jparams, jstate, jl2 = jtrain.prober_train_step(
            jparams, jstate, jnp.asarray(caps), jnp.asarray(labels), jnp.asarray(pred_lens),
            jax.random.PRNGKey(step), tc=jtc, optimizer=opt)
        tparams, tstate, tl2 = ttrain.prober_train_step(
            tparams, tstate, torch.from_numpy(caps), torch.from_numpy(labels).long(),
            torch.from_numpy(pred_lens).long(), None, tc=ttc)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5)
        assert not tparams["fc1"]["w"].requires_grad
    assert tstate[1].last_epoch == 3


@pytest.mark.parametrize("double_softmax", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_train_step_params_after_three_steps_match_jax_f64(method, double_softmax, no_dropout):
    """Both packages' steps in float64 from one init: per-site losses
    within 1e-5 relative and every parameter within 1e-5 absolute after
    three steps, at a learning rate of 3e-3."""
    d = 32
    kw = dict(**SITES, method=method, double_softmax=double_softmax, lr=3e-3)
    jtc, ttc = jtrain.ProberTrainConfig(**kw), ttrain.ProberTrainConfig(**kw)
    init = copy_tree(jax_stack(4, d), np.float64)
    tparams = probers_from_jax(copy_tree(init), device="cpu")
    tparams = {m: {k: v.double() for k, v in s.items()} for m, s in tparams.items()}
    tstate = ttrain.make_optimizer(ttc, tparams)
    with jax.enable_x64(True):
        jparams, opt = to_jax(init), jtrain.make_optimizer(jtc)
        jstate = opt.init(jparams)
        for step, (caps, labels, pred_lens) in enumerate(batches(4, d, seed=6)):
            caps = caps.astype(np.float64)
            jparams, jstate, jl = jtrain.prober_train_step(
                jparams, jstate, jnp.asarray(caps), jnp.asarray(labels), jnp.asarray(pred_lens),
                jax.random.PRNGKey(step), tc=jtc, optimizer=opt)
            tparams, tstate, tl = ttrain.prober_train_step(
                tparams, tstate, torch.from_numpy(caps), torch.from_numpy(labels).long(),
                torch.from_numpy(pred_lens).long(), None, tc=ttc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        for m, s in tparams.items():
            for k, v in s.items():
                assert np.asarray(jparams[m][k]).dtype == np.float64
                np.testing.assert_allclose(v.numpy(), np.asarray(jparams[m][k]), rtol=0, atol=1e-5,
                                           err_msg=f"{m}/{k}")
        moved = float(np.abs(tparams["fc1"]["w"].numpy() - init["fc1"]["w"]).max())
        assert moved > 3e-3  # three steps moved the weights


@pytest.mark.parametrize("method", METHODS)
def test_eval_step_matches_jax(method):
    d = 32
    tree = numpy_stack(4, d, seed=9)
    (caps, labels, pred_lens), = batches(4, d, seed=10, steps=1)
    caps *= 10
    jtc = jtrain.ProberTrainConfig(**SITES, method=method)
    ttc = ttrain.ProberTrainConfig(**SITES, method=method)
    jc, jl = jtrain.prober_eval_step(to_jax(tree), jnp.asarray(caps), jnp.asarray(labels),
                                     jnp.asarray(pred_lens), tc=jtc)
    tc_, tl = ttrain.prober_eval_step(probers_from_jax(tree, device="cpu"), torch.from_numpy(caps),
                                      torch.from_numpy(labels).long(),
                                      torch.from_numpy(pred_lens).long(), tc=ttc)
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_optimizer_matches_optax_on_equal_gradients():
    """``make_optimizer``'s torch AdamW against JAX's optax chain on
    the same gradients (magnitudes 1e-10 to 1e-1) over five steps: the
    schedule starts at ``lr``, weight decay 1e-4 on every leaf. f32,
    atol 1e-6 (parameters of order 1)."""
    rng = np.random.default_rng(11)
    p0 = {"fc": {"w": rng.standard_normal((3, 16, 8)).astype(np.float32),
                 "b": rng.standard_normal((3, 8)).astype(np.float32)}}
    jtc = jtrain.ProberTrainConfig(lr=1e-2)
    opt = jtrain.make_optimizer(jtc)
    jp = to_jax(p0)
    js = opt.init(jp)
    tp = {m: {k: torch.tensor(v) for k, v in s.items()} for m, s in p0.items()}
    topt, tsched = ttrain.make_optimizer(ttrain.ProberTrainConfig(lr=1e-2), tp)
    for _ in range(5):
        g = {m: {k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-10, -1, v.shape))
                 .astype(np.float32) for k, v in s.items()} for m, s in p0.items()}
        updates, js = opt.update(to_jax(g), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        for m in tp:
            for k in tp[m]:
                tp[m][k].grad = torch.tensor(g[m][k])
        topt.step()
        tsched.step()
    for m, s in tp.items():
        for k, v in s.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[m][k]), rtol=0, atol=1e-6)


# ------------------------------------------------------------ data + loop


def test_tensorize_examples_bit_equal():
    examples = [ttrain.ProberExample("question alpha", "yes yes", 1),
                ttrain.ProberExample("q " * 40, "a long answer " * 5, 0),
                ttrain.ProberExample("déjà vu?", "", 1)]
    jex = [jtrain.ProberExample(e.text, e.pred, e.label) for e in examples]
    for max_len, is_cot in ((64, True), (64, False), (20, True)):
        t = ttrain.tensorize_examples(examples, ByteTokenizer(512), max_len, is_cot)
        j = jtrain.tensorize_examples(jex, JaxByteTokenizer(512), max_len, is_cot)
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


CFG_J = dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32)
CFG_T = dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)


def separable_examples(n_each=12):
    pos = [("question alpha", "yes yes yes yes", 1)] * n_each
    neg = [("question beta", "no no no no no", 0)] * n_each
    return [x for pair in zip(pos, neg) for x in pair]


def test_capture_activations_matches_jax():
    tree = numpy_params(CFG_J)
    tokens, _, _ = jtrain.tensorize_examples(
        [jtrain.ProberExample(*e) for e in separable_examples(2)], JaxByteTokenizer(512), 40)
    sites = ((1, "resid_mid"), (2, "resid_post"), (3, "resid_mid"))
    j = jtrain.capture_activations(to_jax(tree), CFG_J, tokens, sites, 257)
    t = ttrain.capture_activations(lm_params_from_jax(tree, CFG_T, device="cpu"), CFG_T,
                                   tokens, sites, 257)
    assert t.shape == (3, 4, 40, CFG_T.d_model) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_train_probers_two_epochs_matches_jax(no_dropout, monkeypatch):
    """``train_probers`` over 2 epochs (3 steps each, a ragged tail
    dropped) from JAX's init, dropout off, dev set evaluated each epoch:
    the step losses within rtol 1e-4, the dev accuracies equal. The final
    parameters (f32 captures and steps): all but 0.1% within 1e-5, and
    every one within 1e-3, what six Adam steps at lr 1e-4 can move an
    element whose near-zero gradient differs in sign between the two
    runs."""
    tree = numpy_params(CFG_J)
    rows = separable_examples()[:-1]  # 23 examples, batch 7: 2 dropped an epoch
    kw = dict(layers=CFG_J.probe_layers, positions=("resid_mid", "resid_post"), batch_size=7,
              max_len=48, lr=1e-4, epochs=2)
    jtc, ttc = jtrain.ProberTrainConfig(**kw), ttrain.ProberTrainConfig(**kw)
    init, jax_init = {}, jtrain.init_prober_stack

    def recorded_init(tc, d, key):
        init["tree"] = copy_tree(jax_init(tc, d, key))
        return to_jax(init["tree"])

    monkeypatch.setattr(jtrain, "init_prober_stack", recorded_init)
    jstack, jhist = jtrain.train_probers(to_jax(tree), CFG_J, JaxByteTokenizer(512),
                                         [jtrain.ProberExample(*e) for e in rows],
                                         [jtrain.ProberExample(*e) for e in rows[:14]], jtc)
    monkeypatch.setattr(ttrain, "init_prober_stack",
                        lambda tc, d, gen, device: probers_from_jax(copy_tree(init["tree"]), device))
    logged = []
    tstack, thist = ttrain.train_probers(lm_params_from_jax(tree, CFG_T, device="cpu"), CFG_T,
                                         ByteTokenizer(512),
                                         [ttrain.ProberExample(*e) for e in rows],
                                         [ttrain.ProberExample(*e) for e in rows[:14]], ttc,
                                         log=logged.append)
    assert logged == thist and len(thist) == len(jhist) == 2 * (3 + 1)
    for t, j in zip(thist, jhist):
        assert t.keys() == j.keys() and t["epoch"] == j["epoch"]
        if "losses" in t:
            assert t["step"] == j["step"]
            np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-4)
        else:
            assert t["dev_acc"] == j["dev_acc"]
    diff = np.concatenate([np.abs(v.numpy() - np.asarray(jstack[m][k])).ravel()
                           for m, s in tstack.items() for k, v in s.items()])
    assert diff.max() <= 1e-3 and (diff > 1e-5).mean() <= 1e-3, (diff.max(), (diff > 1e-5).sum())
    moved = np.abs(tstack["fc1"]["w"].numpy() - init["tree"]["fc1"]["w"]).max()
    assert moved > 5e-4


def test_evaluate_probers_matches_jax():
    tree = numpy_params(CFG_J)
    rows = separable_examples(6)
    stack = numpy_stack(4, CFG_J.d_model, seed=12)
    for method in METHODS:
        kw = dict(layers=CFG_J.probe_layers, positions=("resid_mid", "resid_post"), batch_size=4,
                  max_len=40, method=method)
        j = jtrain.evaluate_probers(to_jax(tree), CFG_J, JaxByteTokenizer(512),
                                    [jtrain.ProberExample(*e) for e in rows], to_jax(stack),
                                    jtrain.ProberTrainConfig(**kw), max_batches=2)
        t = ttrain.evaluate_probers(lm_params_from_jax(tree, CFG_T, device="cpu"), CFG_T,
                                    ByteTokenizer(512), [ttrain.ProberExample(*e) for e in rows],
                                    probers_from_jax(stack, device="cpu"),
                                    ttrain.ProberTrainConfig(**kw), max_batches=2)
        np.testing.assert_array_equal(t, j)
