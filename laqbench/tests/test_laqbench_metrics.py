"""The harness's metric arithmetic, worked by hand."""
import math

import pytest

from laqbench import harness, models, roofline, spec, trace


def _run(**kw):
    base = dict(setup_s=12.5, window_s=20.0, answered=0, latencies_ms=[],
                compile_ms={})
    base.update(kw)
    return harness.RunRecord(**base)


def read(name, run):
    return harness.load_reader(name)(run)


def test_p95_is_the_nearest_rank_over_every_sample():
    lat = [float(i) for i in range(1, 201)]          # 200 samples
    assert read("query_p95_ms", _run(latencies_ms=lat)) == 190.0
    # Not a median of chunks or of query types: one slow query type that
    # is 6 % of the stream sets the tail.
    lat = [1.0] * 94 + [100.0] * 6
    assert read("query_p95_ms", _run(latencies_ms=lat)) == 100.0
    assert read("query_p95_ms", _run(latencies_ms=[3.0])) == 3.0


def test_rate_is_over_the_whole_window():
    run = _run(window_s=20.5, answered=410)
    assert read("queries_per_s", run) == pytest.approx(20.0)


def test_setup_and_compile():
    run = _run(compile_ms={"a": 10.0, "b": 22.5})
    assert read("setup_s", run) == 12.5
    assert read("compile_ms", run) == 32.5
    assert read("compile_ms", _run()) is None


def _head(name, rows):
    q = spec.load("queries", name)
    m = models.draw(q["model"], sum(spec.feature_counts(q)))
    return roofline.head_work(q, rows, m, models.width(m))


def test_head_bytes_p1_by_hand():
    rows = spec.load("configs", "ssb-sf10")["rows"]
    nbytes, ops = _head("P1.linear.year", rows)
    n = 60_000_000
    want = (3 * 4 * n                       # the three FK columns
            + 800_000 * 2 * 4               # p_size, p_category
            + 20_000 * 1 * 4                # s_city
            + 2_556 * 2 * 4                 # d_month, d_weeknuminyear
            + 5 * 4 * 4                     # L, k=5 by l=4
            + n * 4 * 4)                    # the (n, 4) predictions
    assert nbytes == want == 1_686_500_528
    assert ops == n * 4 * 3
    least, by = roofline.least_s(nbytes, ops)
    assert by == "bytes"
    assert least == pytest.approx(want / 3.35e12)


def test_head_bytes_setting1_l128_by_hand():
    rows = spec.load("configs", "synth-s1-sf8")["rows"]
    nbytes, _ = _head("S1.linear128", rows)
    n = 4_800_000
    want = (3 * 4 * n
            + 80_000 * 42 * 4 + 16_000 * 42 * 4 + 2_555 * 44 * 4
            + 128 * 128 * 4
            + n * 128 * 4)
    assert nbytes == want == 2_531_843_216
    assert roofline.least_s(nbytes, 0)[0] * 1e3 == pytest.approx(0.7558, 1e-3)
    tree_bytes, tree_ops = _head("S1.tree7", rows)
    assert tree_bytes == want - 128 * 128 * 4 + 127 * 8
    assert tree_ops == n * 128 * 4


def test_head_roofline_is_a_ratio_of_sums():
    run = _run(head=[{"least_s": 1.0, "measured_s": 4.0},
                     {"least_s": 1.0, "measured_s": 1.0}])
    assert read("head_roofline", run) == pytest.approx(40.0)
    assert read("head_roofline", _run()) is None


def test_query_mfu_over_the_window_past_the_profiled_slice():
    # a: 3.35e9 bytes, 1 ms at the HBM peak; b: 67e9 operations, 1 ms at
    # the float32 peak.  The first query sat in the profiled slice.
    least = {"a": (3_350_000_000, 10), "b": (4, 67_000_000_000)}
    run = _run(names=["a", "a", "b", "a"], latencies_ms=[50.0, 2.0, 4.0,
                                                         2.0],
               least=least, profiled=1)
    assert read("query_mfu", run) == pytest.approx(100 * 3 / 8)
    assert read("query_mfu", _run()) is None


def test_query_work_q11_by_hand():
    q = spec.load("queries", "Q1.1")
    rows = {"lineorder": 100, "date": 2556}
    nbytes, ops = roofline.query_work(q, rows, None, 1)
    # lo_orderdate, lo_discount, lo_quantity, lo_extendedprice; d_year
    assert nbytes == 100 * 4 * 4 + 2556 * 4
    # two fact predicates, one multiply and one add for the revenue, one
    # predicate on the date arm
    assert ops == 100 * (2 + 2) + 2556


def test_query_work_setting1_l128_by_hand():
    rows = spec.load("configs", "synth-s1-sf8")["rows"]
    q = spec.load("queries", "S1.linear128")
    m = models.draw(q["model"], 128)
    nbytes, ops = roofline.query_work(q, rows, m, 128)
    n = 4_800_000
    # three FK columns and the features read once, L once; no (n, l)
    # matrix.  Adds: three arms and the sum, per row and output.
    assert nbytes == (3 * 4 * n + 80_000 * 42 * 4 + 16_000 * 42 * 4
                      + 2_555 * 44 * 4 + 128 * 128 * 4)
    assert ops == n * 128 * 4
    assert roofline.least_s(nbytes, ops)[1] == "operations"


def _ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_summary_busy_idle_and_labels():
    events = [
        _ev("window", 0, 1000, "user_annotation"),
        _ev("loop", 0, 1000, "user_annotation"),
        _ev("query:A", 0, 400, "user_annotation"),
        _ev("copy:A", 400, 100, "user_annotation"),
        _ev("query:B", 500, 500, "user_annotation"),
        _ev("k1", 50, 200, "kernel"),
        _ev("k2", 150, 200, "kernel"),          # overlaps k1
        _ev("Memcpy DtoH", 420, 30, "gpu_memcpy"),
        _ev("k3", 440, 10, "kernel"),           # inside the copy
        _ev("k1", 600, 100, "kernel"),
        _ev("late", 990, 50, "kernel"),         # clipped at the window
        _ev("before", -100, 50, "kernel"),      # outside
    ]
    s = trace.summarize(events, queries=2)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((300 + 30 + 100 + 10) * 1e-6)
    assert s["kernels"] == 5
    assert dict(s["device_ops"])["k1"] == pytest.approx(300e-6)
    idle = dict(s["idle_gaps"])
    # gaps by their middles: 0-50 and 350-420 in query:A, 450-600 in
    # copy:A, 700-990 in query:B
    assert idle["query:A"] == pytest.approx((50 + 70) * 1e-6)
    assert "copy:A" not in idle
    assert idle["query:B"] == pytest.approx((150 + 290) * 1e-6)
    assert sum(idle.values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
    run = _run(trace=s)
    assert read("launches_per_query", run) == 2.5
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 440 / 1000))


def test_trace_readers_stay_silent_without_device_work():
    s = trace.summarize([_ev("window", 0, 1000, "user_annotation")], 5)
    run = _run(trace=s)
    assert read("device_idle_pct", run) is None
    assert read("launches_per_query", run) is None
    assert not math.isnan(s["window_s"])
