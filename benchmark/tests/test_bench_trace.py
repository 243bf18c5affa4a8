"""The per-layer metrics' arithmetic on made-up traces (`benchmark/trace.py`)."""

import pytest

from benchmark import trace
from benchmark.harness import _short
from benchmark.trace import Call, Trace


def _trace():
    # compress: 1,000 us wall; a kernel on the main stream 100-400, the
    # hash on the side stream 200-500 (overlapping), copies 0-50 and 600-700
    c = Call("compress", 0.0, 1000.0, 2_000_000, 1_000_000, [
        ("encode_windows", 100.0, 400.0), ("xxh32_windows<false>", 200.0, 500.0),
        ("Memcpy HtoD (Pageable -> Device)", 0.0, 50.0),
        ("Memcpy DtoH (Device -> Pageable)", 600.0, 700.0)])
    # decompress: 500 us wall; one kernel, one copy, one set
    d = Call("decompress", 1100.0, 1600.0, 2_000_000, 1_000_000, [
        ("rows_jump", 1150.0, 1200.0), ("Memcpy DtoH (Device -> Pageable)", 1300.0, 1500.0),
        ("Memset (Device)", 1500.0, 1510.0)])
    return Trace([c, d], host=[("aten::to", 700.0, 1000.0), ("cudaMemcpyAsync", 750.0, 800.0),
                               ("aten::empty", 1210.0, 1290.0)])


def test_union_counts_overlaps_across_streams_once():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert trace.union_us([]) == 0


def test_idle_share_of_summed_wall_time():
    t = _trace()
    # busy 0-50, 100-500, 600-700: 550 of 1,000
    assert trace.idle_pct(t, "compress") == pytest.approx(45.0)
    assert trace.idle_pct(t, "decompress") == pytest.approx(100 * (1 - 260 / 500))
    two = Trace(t.calls + [Call("compress", 2000.0, 3000.0, 2_000_000, 1_000_000, [])])
    assert trace.idle_pct(two, "compress") == pytest.approx(100 * (1 - 550 / 2000))
    assert trace.idle_pct(Trace([]), "compress") is None


def test_copies_per_gb_of_the_object():
    t = _trace()
    # 150 us of copies per 2 MB: 0.15 ms / 0.002 GB
    assert trace.copy_ms_per_gb(t, "compress") == pytest.approx(75.0)
    assert trace.copy_ms_per_gb(t, "decompress") == pytest.approx(100.0)


def test_roofline_counts_the_bytes_the_call_needs():
    t = _trace()
    need_us = 3_000_000 / 3.35e12 * 1e6
    # kernels' union 100-500 on compress (copies and sets are not kernels)
    assert trace.roofline_pct(t, "compress") == pytest.approx(100 * need_us / 400)
    assert trace.roofline_pct(t, "decompress") == pytest.approx(100 * need_us / 50)
    assert trace.roofline_pct(Trace([Call("compress", 0, 1, 1, 1, [])]), "compress") is None


def test_breakdown_names_ops_and_idle_gaps():
    b = trace.breakdown(_trace())
    ops = dict(b["device_ops"])
    assert ops["encode_windows"] == pytest.approx(300e-6)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(300e-6)
    assert ops["Memset (Device)"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # compress idle 50-100, 500-600, 700-1000 (aten::to); between 1000-1150
    assert gaps["compress: aten::to"] == pytest.approx(300e-6)
    assert gaps["compress"] == pytest.approx(150e-6)
    assert gaps["between calls"] == pytest.approx(100e-6)
    assert gaps["decompress"] == pytest.approx(240e-6)  # 1100-1150, 1200-1300, 1510-1600
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_short_trace_is_found():
    t = _trace()
    whole = [{"encode_windows": 1, "xxh32_windows": 1}, {"rows_jump": 1}]
    assert _short(t.calls, whole) == []
    assert _short(t.calls, [{"encode_windows": 2}, {}]) == ["call 0 (compress): 1 of 2 encode_windows"]
    again = Call("compress", 2000.0, 3000.0, 2_000_000, 1_000_000, t.calls[0].device[:2])
    assert _short(t.calls + [again], whole + [{}]) == [
        "call 2 (compress): 2 of 4 device operations"]
