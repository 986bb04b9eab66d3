"""The device timeline: busy time as the union of the intervals, idle
gaps by what the host was doing, work found inside host spans, and the
copied summaries."""

import pytest

from perfbench.devtrace import Timeline, device_summary, kernel_class


def _timeline():
    work = [("gemm_a", 10, 30), ("flash_fwd_sm90_kernel<128>", 25, 40),
            ("Memcpy HtoD", 60, 70), ("elementwise", 95, 120)]
    spans = [("engine.prefill", 0, 45), ("engine.step", 50, 80)]
    return Timeline(work, spans, 0, 100)


def test_busy_is_the_union_clipped_to_the_window():
    tl = _timeline()
    assert tl.window_s == 100 / 1e9
    assert tl.busy_s() == (30 + 10 + 5) / 1e9


def test_idle_gaps_by_host_span():
    rows = dict(_timeline().idle_by_host())
    # gaps [0, 10], [40, 60] and [70, 95], each named by its midpoint's span
    assert rows == {"engine.prefill": 10 / 1e9, "engine.step": 20 / 1e9,
                    "outside spans": 25 / 1e9}


def test_work_inside_spans():
    tl = _timeline()
    assert [w[0] for w in tl.inside("engine.prefill")] == [
        "gemm_a", "flash_fwd_sm90_kernel<128>"]
    assert [w[0] for w in tl.inside("engine.step")] == ["Memcpy HtoD"]
    assert tl.share_in_spans() == 45 / 50


def test_summaries_and_classes():
    tl = _timeline()
    s = device_summary(tl.work)
    assert s["kernel_launches"] == 3 and s["copies"] == 1
    assert s["by_name"]["gemm_a"] == (20 / 1e6, 1)
    assert kernel_class("void flash_bwd_dq_sm90_kernel<64>") == "port_kernels"
    assert kernel_class("nvjet_tst_192x192") == "matmul"
    assert kernel_class("vectorized_elementwise_kernel") == "other"
    assert tl.by_class() == pytest.approx(
        {"matmul": 20 / 1e9, "port_kernels": 15 / 1e9, "other": 15 / 1e9})
    assert tl.top_ops(1) == [["gemm_a", 20 / 1e9]]
