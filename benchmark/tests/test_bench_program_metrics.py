"""The per-layer metrics that read the program's own spans and counts
(``probing_rag_tpu_torch/utils/profiling.py``), each on a stub run: spans
placed inside and outside the window, a stub trace. Each returns the
share its spans give, and nothing without a trace (off the card) or
where the program has no recorder."""

import types

import pytest

from benchmark.run import Manifest, ROOT

from probing_rag_tpu_torch.utils import profiling

WINDOW = (100.0, 110.0)  # perf_counter seconds: 10 s


def put(rec, name, start, end, child=0.0, device=None, **counts):
    """A closed span of ``name`` from ``start`` to ``end`` (seconds), whose
    children cover ``child`` seconds of it, timed ``device`` seconds on the
    card."""
    s = rec.span(name, **counts)
    s.start_ns, s.end_ns = int(start * 1e9), int(end * 1e9)
    s.child_ns = int(child * 1e9)
    s.device_s = device
    rec.ring.append(s)


@pytest.fixture
def rec(monkeypatch):
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


def read(name, trace=True):
    run = types.SimpleNamespace(trace=object() if trace else None, window_start=WINDOW[0],
                                window_end=WINDOW[1], window_s=WINDOW[1] - WINDOW[0])
    return Manifest(ROOT).reader(name).read(run)


def test_rag_device_shares(rec):
    put(rec, "lm.prefill", 101.0, 101.1, device=0.8, rows=32, slots=32 * 512, valid=32 * 384)
    put(rec, "lm.prefill", 103.0, 103.1, device=1.2, rows=32, slots=32 * 1152, valid=32 * 1036)
    put(rec, "lm.prefill", 99.0, 99.1, device=5.0, rows=32, slots=100, valid=0)  # before
    put(rec, "lm.decode", 101.1, 102.9, device=1.5, steps=149, row_steps=32 * 149, live=32 * 100)
    put(rec, "lm.decode", 103.1, 104.9, device=1.5, steps=149, row_steps=32 * 149,
        live=32 * 49)
    put(rec, "lm.decode", 109.5, 110.5, device=7.0, row_steps=1, live=1)  # past the end
    assert read("prefill_share.rag") == pytest.approx(20.0)
    assert read("decode_share.rag") == pytest.approx(30.0)
    assert read("prefill_pad_share.rag") == pytest.approx(
        100.0 * (1 - (384 + 1036) / (512 + 1152)))
    assert read("decode_live_share.rag") == pytest.approx(50.0)


def test_rag_host_share_reads_self_seconds(rec):
    put(rec, "rag.run", 100.5, 109.5, child=8.5)  # 0.5 s of its own
    put(rec, "rag.retrieve", 102.0, 102.4, child=0.3)  # 0.1 s beside its search
    put(rec, "rag.gate", 103.0, 103.1)
    put(rec, "lm.prepare", 104.0, 104.2)
    put(rec, "lm.detokenize", 105.0, 105.1)
    put(rec, "lm.readback", 106.0, 107.0)  # waits on the card: not host work
    put(rec, "lm.prepare", 111.0, 115.0)  # after the window
    assert read("host_share.rag") == pytest.approx(10.0 * (0.5 + 0.1 + 0.1 + 0.2 + 0.1))


def test_index_shares(rec):
    put(rec, "index.build", 100.0, 101.5, child=1.4)  # 0.1 s of its own
    put(rec, "encoder.batch", 100.0, 101.4, child=1.3)  # 0.1 s
    put(rec, "encoder.tokenize", 100.0, 100.3)
    put(rec, "encoder.pad", 100.3, 100.4)
    put(rec, "encoder.copy_in", 100.4, 100.45)
    put(rec, "encoder.forward", 100.45, 100.5, device=0.9, slots=512 * 260, valid=512 * 141)
    put(rec, "encoder.forward", 98.0, 99.0, device=9.0, slots=10, valid=10)  # before
    put(rec, "encoder.readback", 100.5, 101.4)
    assert read("encode_share.index") == pytest.approx(9.0)
    assert read("host_share.index") == pytest.approx(10.0 * (0.3 + 0.1 + 0.05 + 0.1 + 0.1))
    assert read("pad_share.index") == pytest.approx(100.0 * (1 - 141 / 260))


NAMES = ["prefill_share.rag", "decode_share.rag", "host_share.rag", "prefill_pad_share.rag",
         "decode_live_share.rag", "encode_share.index", "host_share.index", "pad_share.index"]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_trace_or_spans(rec, monkeypatch, name):
    put(rec, "lm.prefill", 101.0, 102.0, device=1.0, slots=4, valid=2)
    put(rec, "lm.decode", 102.0, 103.0, device=1.0, row_steps=4, live=2)
    put(rec, "rag.run", 101.0, 103.0)
    put(rec, "encoder.forward", 101.0, 102.0, device=1.0, slots=4, valid=2)
    put(rec, "encoder.tokenize", 101.0, 102.0)
    assert read(name) is not None
    assert read(name, trace=False) is None
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_program_without_a_recorder(monkeypatch, name):
    monkeypatch.delattr(profiling, "RECORDER")
    assert read(name) is None


def test_each_reader_is_declared_for_its_cell():
    m = Manifest(ROOT)
    for name in NAMES:
        entry = next(e for e in m.bench["per_layer"] if e["name"] == name)
        cell = "mistral7b.rag-bm25" if name.endswith(".rag") else "contriever.index-build"
        assert entry["workloads"] == [cell] and entry["unit"] == "%"
