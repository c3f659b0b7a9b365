"""Busy time, idle gaps and their spans from a trace's raw events."""

import pytest

from benchmark.lib.trace import summarize

US = 1000  # ns


def test_busy_gaps_and_spans():
    device = [("k1", 100 * US, 300 * US), ("k2", 250 * US, 400 * US),
              ("k3", 405 * US, 410 * US), ("k1", 700 * US, 900 * US),
              ("early", 0, 50 * US)]
    host = [("unit", 40 * US, 1000 * US), ("chunk", 40 * US, 1000 * US),
            ("search", 450 * US, 650 * US)]
    t = summarize(device, host)
    assert t.window_s == pytest.approx(960e-6)
    # 40-50 (the part inside the unit) + 100-400 + 405-410 + 700-900
    assert t.busy_s == pytest.approx(515e-6)
    assert t.kernels["k1"] == pytest.approx(400e-6) and t.kernels["early"] == pytest.approx(10e-6)
    assert sorted(t.gaps) == sorted([("chunk", 50e-6), ("kernel-to-kernel", 5e-6),
                                     ("search", 290e-6), ("chunk", 100e-6)])
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(400e-6)]
    assert b["idle_gaps"][0] == ["search", pytest.approx(290e-6)]
