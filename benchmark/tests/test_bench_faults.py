"""The check catches a broken timed path: each run here skips the look for
a card and drives a whole tiny run with one fault planted in the program,
and ``correct`` must come out false. The faults a cell can have: a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; a token or an answer altered where it is produced.
(The exchange between chips: no cell spans chips.) Then the control, the
lower precision put in the program's place, read at a tiny size."""

import pytest
import torch

from benchmark.calibrate import calibrate
from benchmark.run import Manifest, run_cell


def _run(root, cell):
    m = Manifest(root)
    return run_cell(m, m.cell(cell), 3, 0.3, False, device="cpu")


def test_sound_runs_are_correct(tiny_root):
    assert _run(tiny_root, "tiny.rag")["correct"]
    assert _run(tiny_root, "tiny.index")["correct"]


def test_rag_step_unchanged(tiny_root, monkeypatch):
    from probing_rag_tpu_torch.models import decode

    monkeypatch.setattr(decode, "_decode_step", lambda *a, **k: None)
    out = _run(tiny_root, "tiny.rag")
    assert not out["correct"] and out["checks"]["answers_truncated"]["value"] > 0


def test_rag_half_batch_mean_of_the_rest(tiny_root, monkeypatch):
    from probing_rag_tpu_torch.pipeline import rag

    real = rag.generate

    def half(params, cfg, tok, prompts, **kw):
        n = len(prompts) // 2
        texts, res = real(params, cfg, tok, list(prompts[:n]) * 2, **kw)
        res.pooled_captures[:, n:] = res.pooled_captures[:, :n].mean(axis=1, keepdims=True)
        return texts, res

    monkeypatch.setattr(rag, "generate", half)
    out = _run(tiny_root, "tiny.rag")
    assert not out["correct"] and out["checks"]["answers_missing"]["value"] > 0


@pytest.mark.parametrize("round_", [None, 0, 2])
def test_rag_token_altered(tiny_root, monkeypatch, round_):
    """A served token altered in every generate call, or only in one
    round's: round 0 (the short CoT prompts, their own prompt bucket and
    decode graph) or round 2 (an answer that becomes the next round's
    search query). Every chunk makes five calls, so a call's place in the
    run gives its round."""
    from probing_rag_tpu_torch.models import decode

    real = decode.decode_greedy
    calls = []

    def altered(*a, **k):
        gen, valid, pooled, n_pooled, n_gen = real(*a, **k)
        if round_ is None or len(calls) % 5 == round_:
            gen = gen.clone()
            gen[:, 1] = (gen[:, 1] + 1) % k["cfg"].vocab_size
        calls.append(1)
        return gen, valid, pooled, n_pooled, n_gen

    monkeypatch.setattr(decode, "decode_greedy", altered)
    out = _run(tiny_root, "tiny.rag")
    assert not out["correct"] and out["checks"]["lm_gap_ms"]["value"] > 0.01


def test_rag_search_answer_altered(tiny_root, monkeypatch):
    from probing_rag_tpu_torch.retrieval.bm25 import BM25Engine

    real = BM25Engine.search

    def altered(self, queries, k=5):
        res = real(self, queries, k=k)
        res.doc_indices[:, 0] = (res.doc_indices[:, 0] + 1) % self.index.n_docs
        return res

    monkeypatch.setattr(BM25Engine, "search", altered)
    out = _run(tiny_root, "tiny.rag")
    assert not out["correct"] and out["checks"]["bm25_err"]["value"] > 1e-4


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_index_faults(tiny_root, monkeypatch, fault):
    from probing_rag_tpu_torch.models import encoder

    real = encoder.encoder_forward

    def broken(params, tokens, mask, cfg):
        if fault == "unchanged":  # the layers leave the embeddings as they came
            p = encoder.prepare_params(params, cfg)
            x = p["tok_embed"][tokens].float() + p["pos_embed"][: tokens.shape[1]].float()[None]
            m = mask.float()[:, :, None]
            return (x * m).sum(1) / m.sum(1)
        out = real(params, tokens, mask, cfg)
        if fault == "half":
            n = len(out) // 2
            out[n:] = out[:n].mean(0)
        else:  # the batch's longest passage: the check samples each call's
            out[int(mask.sum(1).argmax())] += 0.1 * out[0].norm()
        return out

    monkeypatch.setattr(encoder, "encoder_forward", broken)
    out = _run(tiny_root, "tiny.index")
    assert not out["correct"] and out["checks"]["emb_rel_err"]["value"] > 0.01


def test_control_fails_where_sound_runs_pass(tiny_root, capsys):
    """The control at a tiny size, judged by the cell's own limits file as
    a run judges it: every sound seed comes out correct and every control
    seed not, and the control reads above every sound seed on at least one
    number. Its readings at the cells' own sizes come from ``calibrate.py``
    on the card (PERF.md)."""
    m = Manifest(tiny_root)
    for cell, units in (("tiny.rag", 2), ("tiny.index", 1)):
        s = calibrate(m, m.cell(cell), [1, 2, 3, 4], [1, 2, 3], units, device="cpu")
        assert s["program_failed"] == [] and s["control_passed"] == [], s
        assert any(s["control_min"][k] > s["program_max"][k] for k in s["control_min"]), s
    assert torch.backends.cuda.matmul.allow_tf32 is False
