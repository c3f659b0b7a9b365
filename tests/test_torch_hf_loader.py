"""The port's checkpoint loading and checkpoint tokenizer against the JAX
package's, on the CPU.

- ``read_safetensors_file`` against ``safetensors.numpy`` on a file of
  every dtype the numpy framework reads (bit-equal; writes to a tensor
  leave the file as it was), bf16 (which the JAX path reads through
  ml_dtypes) read as torch's bf16 bit-exactly, fp8 refused as the JAX
  path refuses it, a sharded checkpoint, and a corrupt header.
- ``load_gemma_params`` (Gemma, tied head; Mistral, untied) and
  ``load_encoder_params`` against the JAX loaders on the same synthetic
  safetensors checkpoints: every tensor bit-equal in f32, bf16 equal to
  the JAX tree cast to bf16; the geometry mismatch raises.
- ``SentencePieceTokenizer`` over the committed fixture vocab (the JAX
  test's HF tokenizer object): every golden, ``token_strings`` and the
  ``StopTables`` built from it equal to JAX's."""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from probing_rag_tpu.models import decode as jdecode
from probing_rag_tpu.models import encoder as je
from probing_rag_tpu.models import gemma as jg
from probing_rag_tpu.models import hf_loader as jloader
from probing_rag_tpu.models.tokenizer import SentencePieceTokenizer as JaxSPTokenizer
from probing_rag_tpu_torch.models import decode as tdecode
from probing_rag_tpu_torch.models import encoder as te
from probing_rag_tpu_torch.models import gemma as tg
from probing_rag_tpu_torch.models import hf_loader as tloader
from probing_rag_tpu_torch.models.tokenizer import SentencePieceTokenizer

FIXTURES = Path(__file__).parent / "fixtures"


def write(path, tensors, metadata=None):
    from safetensors.numpy import save_file

    save_file(tensors, str(path), metadata=metadata)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ---------------------------------------------------------------- reader

NUMPY_DTYPES = (np.float64, np.float32, np.float16, np.int64, np.uint64, np.int32, np.uint32,
                np.int16, np.uint16, np.int8, np.uint8, np.bool_, np.complex64)


def test_reader_matches_safetensors_numpy(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    tensors = {}
    for i, dt in enumerate(NUMPY_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1,), (0, 4)][i % 5]
        x = rng.standard_normal(shape) * 100
        tensors[f"t{i}.{np.dtype(dt).name}"] = (x + 1j * x if dt == np.complex64 else x).astype(dt)
    tensors["scalar"] = np.asarray(3.5, np.float32)
    write(tmp_path / "a.safetensors", tensors, metadata={"format": "pt"})
    got = tloader.read_safetensors_file(tmp_path / "a.safetensors")
    want = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    got["t1.float32"].fill_(0)  # copy-on-write: the file keeps its bytes
    again = tloader.read_safetensors_file(tmp_path / "a.safetensors")
    np.testing.assert_array_equal(again["t1.float32"].numpy(), want["t1.float32"])


def test_reader_bf16_and_fp8_as_the_jax_path(tmp_path):
    from safetensors.torch import save_file

    w = torch.randn(5, 3).to(torch.bfloat16)
    save_file({"w": w}, str(tmp_path / "model.safetensors"))
    j = jloader._read_safetensors(tmp_path)["w"]  # ml_dtypes.bfloat16, jax being loaded
    t = tloader.read_safetensors(tmp_path)["w"]
    assert j.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), j.view(np.uint16))
    assert torch.equal(t, w)
    save_file({"w": torch.ones(2, 2).to(torch.float8_e4m3fn)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(AttributeError):
        jloader._read_safetensors(tmp_path)
    with pytest.raises(TypeError, match="F8_E4M3"):
        tloader.read_safetensors(tmp_path)


def test_reader_shards_missing_and_corrupt(tmp_path):
    write(tmp_path / "model-00001-of-00002.safetensors", {"a": np.arange(4, dtype=np.float32)})
    write(tmp_path / "model-00002-of-00002.safetensors", {"b": np.ones((2, 2), np.int8)})
    got = tloader.read_safetensors(tmp_path)
    assert sorted(got) == sorted(jloader._read_safetensors(tmp_path)) == ["a", "b"]
    with pytest.raises(FileNotFoundError):
        tloader.read_safetensors(tmp_path / "nothing")
    bad = tmp_path / "bad" / "x.safetensors"
    bad.parent.mkdir()
    bad.write_bytes((10**6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError):
        tloader.read_safetensors(bad.parent)


# ----------------------------------------------------------------- loaders


def gemma_ckpt(path, cfg, seed=0):
    """A HF decoder checkpoint of ``cfg`` over two shards (torch [out, in]
    layout; Mistral's head at the top level)."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    # dense weights scaled by 1/sqrt(fan_in), norms near 0, so the f32
    # forward is well conditioned
    r = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32)
    t = {"model.embed_tokens.weight": r(cfg.vocab_size, d), "model.norm.weight": r(d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": r(d), p + "post_attention_layernorm.weight": r(d),
                  p + "self_attn.q_proj.weight": r(h * hd, d), p + "self_attn.k_proj.weight": r(kv * hd, d),
                  p + "self_attn.v_proj.weight": r(kv * hd, d), p + "self_attn.o_proj.weight": r(d, h * hd),
                  p + "mlp.gate_proj.weight": r(f, d), p + "mlp.up_proj.weight": r(f, d),
                  p + "mlp.down_proj.weight": r(d, f)})
    if not cfg.tied_head:
        t["lm_head.weight"] = r(cfg.vocab_size, d)
    keys = sorted(t)
    write(path / "model-1.safetensors", {k: t[k] for k in keys[::2]})
    write(path / "model-2.safetensors", {k: t[k] for k in keys[1::2]})
    return t


CONFIGS = {
    "gemma": (dataclasses.replace(jg.GemmaConfig.tiny(), compute_dtype=jnp.float32),
              dataclasses.replace(tg.GemmaConfig.tiny(), compute_dtype=torch.float32)),
    "mistral": (dataclasses.replace(jg.GemmaConfig.tiny_mistral(), compute_dtype=jnp.float32),
                dataclasses.replace(tg.GemmaConfig.tiny_mistral(), compute_dtype=torch.float32)),
}


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_gemma_loader_matches_jax(tmp_path, family):
    jcfg, tcfg = CONFIGS[family]
    raw = gemma_ckpt(tmp_path, jcfg)
    j = flat(jloader.load_gemma_params(tmp_path, jcfg))
    t = flat(tloader.load_gemma_params(tmp_path, tcfg, device="cpu"))
    assert sorted(t) == sorted(j)
    assert ("lm_head" in t) == (family == "mistral")
    for k, v in j.items():
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(t["layers/wq"][1].numpy(), raw["model.layers.1.self_attn.q_proj.weight"].T)
    bf = flat(tloader.load_gemma_params(tmp_path, tcfg, dtype=torch.bfloat16, device="cpu"))
    for k, v in j.items():
        np.testing.assert_array_equal(bf[k].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jnp.asarray(v, jnp.bfloat16)).view(np.uint16))
    # the loaded tensors drive the port's forward like JAX's drive JAX's
    tokens = np.asarray([[1, 2, 3, 4, 5]], np.int32)
    jl, _, _ = jg.forward(jax_tree(jloader.load_gemma_params(tmp_path, jcfg)),
                          jnp.asarray(tokens), jcfg)
    tl, _, _ = tg.forward(tloader.load_gemma_params(tmp_path, tcfg, device="cpu"),
                          torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_gemma_loader_bf16_checkpoint_matches_jax(tmp_path, family):
    """A bf16 checkpoint (as HF ships Gemma and Mistral): the port widens
    each layer as it stacks it, JAX widens its ml_dtypes arrays; every
    tensor bit-equal in f32."""
    from safetensors.torch import save_file

    jcfg, tcfg = CONFIGS[family]
    raw = gemma_ckpt(tmp_path, jcfg)  # f32 shards; bf16 ones beside them
    (tmp_path / "bf16").mkdir()
    keys = sorted(raw)
    for i, part in enumerate((keys[::2], keys[1::2])):
        save_file({k: torch.from_numpy(raw[k]).to(torch.bfloat16) for k in part},
                  str(tmp_path / "bf16" / f"model-{i}.safetensors"))
    j = flat(jloader.load_gemma_params(tmp_path / "bf16", jcfg))
    t = flat(tloader.load_gemma_params(tmp_path / "bf16", tcfg, device="cpu"))
    assert sorted(t) == sorted(j)
    for k, v in j.items():
        assert t[k].dtype == torch.float32 and t[k].is_contiguous()
        np.testing.assert_array_equal(t[k].numpy(), v, err_msg=k)


def test_gemma_loader_geometry_mismatch_raises(tmp_path):
    jcfg, tcfg = CONFIGS["gemma"]
    gemma_ckpt(tmp_path, jcfg)
    with pytest.raises(AssertionError):
        jloader.load_gemma_params(tmp_path, dataclasses.replace(jcfg, d_model=jcfg.d_model * 2))
    with pytest.raises(AssertionError, match="geometry"):
        tloader.load_gemma_params(tmp_path, dataclasses.replace(tcfg, d_model=tcfg.d_model * 2),
                                  device="cpu")
    with pytest.raises(AssertionError, match="geometry"):
        tloader.load_gemma_params(tmp_path, dataclasses.replace(tcfg, vocab_size=1024), device="cpu")


def test_encoder_loader_matches_jax(tmp_path):
    jcfg = dataclasses.replace(je.EncoderConfig.tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(te.EncoderConfig.tiny(), compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    d, f = jcfg.d_model, jcfg.d_ff
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = {"bert.embeddings.word_embeddings.weight": r(jcfg.vocab_size, d),
         "bert.embeddings.position_embeddings.weight": r(jcfg.max_positions, d),
         "bert.embeddings.token_type_embeddings.weight": r(jcfg.n_token_types, d),
         "bert.embeddings.LayerNorm.weight": 1 + r(d) / 10, "bert.embeddings.LayerNorm.bias": r(d) / 10}
    for i in range(jcfg.n_layers):
        p = f"bert.encoder.layer.{i}."
        for name, shape in [("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (f, d)), ("output.dense", (d, f))]:
            t[p + name + ".weight"] = r(*shape) / 8
            t[p + name + ".bias"] = r(shape[0]) / 10
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[p + ln + ".weight"] = 1 + r(d) / 10
            t[p + ln + ".bias"] = r(d) / 10
    write(tmp_path / "model.safetensors", t)
    j = flat(jloader.load_encoder_params(tmp_path, jcfg))
    tp = tloader.load_encoder_params(tmp_path, tcfg, device="cpu")
    tf = flat(tp)
    assert sorted(tf) == sorted(j)
    for k, v in j.items():
        np.testing.assert_array_equal(tf[k].numpy(), v, err_msg=k)
    tokens, mask = np.asarray([[5, 6, 7, 0]], np.int32), np.asarray([[1, 1, 1, 0]], bool)
    jout = je.encoder_forward(jax_tree(jloader.load_encoder_params(tmp_path, jcfg)),
                              jnp.asarray(tokens), jnp.asarray(mask), jcfg)
    tout = te.encoder_forward(tp, torch.from_numpy(tokens).long(), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


# --------------------------------------------------------------- tokenizer


@pytest.fixture(scope="module")
def hf_tokenizer():
    from transformers import PreTrainedTokenizerFast

    return PreTrainedTokenizerFast(tokenizer_file=str(FIXTURES / "tokenizer.json"),
                                   bos_token="<bos>", eos_token="<eos>", pad_token="<eos>")


def test_sentencepiece_tokenizer_goldens(hf_tokenizer):
    tok, jtok = SentencePieceTokenizer(hf_tokenizer), JaxSPTokenizer(hf_tokenizer)
    assert (tok.vocab_size, tok.bos_id, tok.eos_id, tok.pad_id) == \
        (jtok.vocab_size, jtok.bos_id, jtok.eos_id, jtok.pad_id)
    assert tok.pad_id == tok.eos_id
    goldens = json.loads((FIXTURES / "tokenizer_goldens.json").read_text())
    for text, ids in goldens.items():
        assert tok.encode(text) == ids, text
        assert tok.encode(text, add_bos=True) == [tok.bos_id] + ids
        assert tok.decode(ids) == jtok.decode(ids)
    for text in ("café au lait", "日本語 test", "rocket \U0001f680 launch", "Robert Erskine "):
        assert tok.decode(tok.encode(text)) == text


def test_sentencepiece_token_strings_and_stop_tables(hf_tokenizer):
    tok, jtok = SentencePieceTokenizer(hf_tokenizer), JaxSPTokenizer(hf_tokenizer)
    strings = tok.token_strings()
    assert strings == jtok.token_strings()
    assert not any("▁" in s for s in strings)
    nl = json.loads((FIXTURES / "tokenizer_goldens.json").read_text())["\n\n"]
    assert any("\n" in strings[i] for i in nl)
    t = tdecode.StopTables.from_token_strings(strings)
    j = jdecode.StopTables.from_token_strings(jtok.token_strings())
    fields = [f.name for f in dataclasses.fields(t)]
    assert fields == [f.name for f in dataclasses.fields(j)]
    for name in fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)), name)
    assert any(bool(t.ends_nl[i]) or bool(t.contains_dbl_nl[i]) for i in nl)


def test_sentencepiece_model_path_needs_the_package(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_sentencepiece(name, *a, **kw):
        if name == "sentencepiece":
            raise ImportError("No module named 'sentencepiece'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sentencepiece)
    with pytest.raises(ImportError, match="sentencepiece package"):
        SentencePieceTokenizer("tokenizer.model")
