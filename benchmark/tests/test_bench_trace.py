"""The reduction of a traced window, on a synthetic trace."""

import pytest

from benchmark.lib import trace

MS = 1_000_000  # ns


def test_busy_idle_kernels_and_gaps():
    window = (0, 100 * MS)
    device = [
        ("conv3x3_stats_kernel", 10 * MS, 20 * MS),
        ("elementwise", 15 * MS, 30 * MS),     # overlaps: union 10-30
        ("Memcpy HtoD (Pinned -> Device)", 50 * MS, 60 * MS),
        ("conv3x3_stats_kernel", 90 * MS, 120 * MS),  # clipped at 100
        ("before", -20 * MS, -10 * MS),        # outside the window
    ]
    spans = [("bench.window", 0, 100 * MS),
             ("bench.mux", 30 * MS, 50 * MS),
             ("bench.render", 0, 100 * MS)]
    s = trace.summarize(window, device, spans)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.020 + 0.010 + 0.010)
    assert trace.idle_share(s) == pytest.approx(60.0)
    assert s.kernels == 3  # the copy is busy time, not a kernel
    assert s.kernel_s == pytest.approx(0.010 + 0.015 + 0.010)
    assert s.kernel_times("conv3x3_stats") == [2, pytest.approx(0.020)]
    # Gaps: 0-10 (render), 30-50 (mux, the innermost open span),
    # 60-90 (render), longest first.
    assert s.gaps == [("bench.render", pytest.approx(0.030)),
                      ("bench.mux", pytest.approx(0.020)),
                      ("bench.render", pytest.approx(0.010))]
    b = s.breakdown()
    assert b["device_ops"][0] == ["conv3x3_stats_kernel", pytest.approx(0.02)]
    assert len(b["idle_gaps"]) == 3


def test_empty_window_is_all_idle():
    s = trace.summarize((0, 10 * MS), [], [])
    assert s.busy_s == 0 and trace.idle_share(s) == pytest.approx(100.0)
    assert s.gaps == [("bench.window", pytest.approx(0.01))]
    assert trace.idle_share(None) is None
