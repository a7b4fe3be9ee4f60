"""The metric arithmetic: a percentile over all solves, a rate over the
whole window, the idle share from overlapping intervals, the roofline
share, and the reduction of a trace."""
import pytest

from h100_bench import harness, metrics, trace
from h100_bench.work import model


def record(seconds, units=None, failed=None, window=None):
    calls = []
    t = 0.0
    for i, s in enumerate(seconds):
        calls.append({"t0": t, "t1": t + s, "seconds": s,
                      "units": 1 if units is None else units[i],
                      "failed": 0 if failed is None else failed[i],
                      "cycles": 24, "work": []})
        t += s
    return harness.Record(setup_s=12.5, window_s=window or t, calls=calls)


def test_percentile_is_over_every_call():
    vals = list(range(1, 101))
    assert metrics.percentile(vals, 95) == 95
    assert metrics.percentile(vals[::-1], 95) == 95
    assert metrics.percentile([7.0], 95) == 7.0
    # 20 values: the 95th percentile is the 19th smallest, not a median
    assert metrics.percentile(list(range(20)), 95) == 18


def test_p95_reader_reads_all_calls():
    rec = record([0.01] * 95 + [0.5] * 5)
    mod = harness.load_module(harness.HERE / "end_to_end" / "solve_ms_p95.py")
    assert mod.read(rec) == pytest.approx(10.0)
    rec = record([0.01] * 94 + [0.5] * 6)
    assert mod.read(rec) == pytest.approx(500.0)


def test_call_p95_leaves_out_the_traced_calls():
    rec = record([0.01] * 95 + [0.5] * 5 + [9.0] * 10)
    rec.profiled = range(100, 110)
    mod = harness.load_module(harness.reader("layer_metrics", "call_ms_p95"))
    assert mod.read(rec) == pytest.approx(10.0)
    rec.profiled = range(0)
    assert mod.read(rec) == pytest.approx(9000.0)


def test_rate_is_over_the_whole_window():
    rec = record([0.25, 0.25, 0.5], units=[1, 1, 1], failed=[0, 1, 0])
    rd = harness.load_module(harness.HERE / "end_to_end" / "solves_per_s.py")
    assert rd.read(rec) == pytest.approx(2 / 1.0)
    rec = record([0.5, 0.5], units=[8, 8], window=2.0)
    rd = harness.load_module(harness.HERE / "end_to_end" / "configs_per_s.py")
    assert rd.read(rec) == pytest.approx(16 / 2.0)


def test_union_of_overlapping_intervals():
    iv = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (22, 25, "d"),
          (30, 31, "e")]
    assert trace.merge(iv) == [[0, 15], [20, 31]]
    assert trace.union_seconds(iv) == pytest.approx(26e-6)


def test_idle_share_and_gaps():
    dev = [(0, 100, "k1"), (50, 150, "k2"), (400, 500, "k1"),
           (600, 1000, "k3")]
    host = [(100, 420, "h100_bench.call.rhs_stream"),
            (150, 400, "cudaStreamSynchronize"), (500, 600, "aten::item")]
    gaps = trace.idle_gaps(dev, host)
    assert gaps[0] == ["h100_bench.call.rhs_stream > cudaStreamSynchronize",
                       pytest.approx(250e-6)]
    assert gaps[1] == ["aten::item", pytest.approx(100e-6)]
    rec = record([0.001])
    rec.trace = {"busy_s": trace.union_seconds(dev), "window_s": 1e-3,
                 "device_ops": 4, "by_name": trace.by_name(dev)}
    assert metrics.idle_share(rec) == pytest.approx(100 * (1 - 0.65))


def test_kernel_names():
    assert trace.kernel_name("void dense_update_kernel<float, 4, true>"
                             "(cplx<float> const*, int)") \
        == "dense_update_kernel"
    assert trace.kernel_name("void (anonymous namespace)::foo<int>()") \
        != "dense_update_kernel"
    assert trace.kernel_name("Memset (Device)") == "Memset"


def test_kernel_roofline_over_table_kernels_only():
    item = model.Item("dense_update", 4, 128, "complex64", 1, n_sweeps=4)
    bound = model.bound([item])[0]
    rec = record([0.01])
    rec.calls[0]["work"] = [item]
    rec.profiled = range(0, 1)
    rec.trace = {"busy_s": 1.0, "window_s": 1.0, "device_ops": 2,
                 "by_name": {"void dense_update_kernel<float>(int)":
                             [4 * bound, 1],
                             "volta_cgemm_32x32_tn": [1.0, 1]}}
    assert metrics.kernel_roofline(rec) == pytest.approx(25.0)
    rec.trace["by_name"] = {"volta_cgemm_32x32_tn": [1.0, 1]}
    assert metrics.kernel_roofline(rec) is None


def test_readers_return_nothing_without_a_trace():
    rec = record([0.1, 0.1])
    for name in ("device_ms_per_cycle", "device_ops_per_cycle",
                 "kernel_roofline.solve", "idle_share.configs"):
        mod = harness.load_module(harness.reader("layer_metrics", name))
        assert mod.read(rec) is None
