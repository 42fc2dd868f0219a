"""The yardstick: roofline byte counts, the p95 over all solves, the
union of device intervals and the reading of a profiler trace."""

import json
import statistics

import pytest

from benchmark import devtrace, harness, roofline, stats


def test_spmv_bytes_count_values_x_and_y_once():
    # 10 values, x of 4, y of 3: written once, read once more with beta
    assert roofline.spmv_bytes(10, 3, 4, 4, beta_nonzero=False) == 4 * 17
    assert roofline.spmv_bytes(10, 3, 4, 8, beta_nonzero=True) == 8 * 20


def test_cg_iteration_bytes_count_values_and_three_vectors_both_ways():
    assert roofline.cg_iteration_bytes(55742968, 2097152, 8) == 8 * (
        55742968 + 6 * 2097152)
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)


def test_p95_is_taken_over_every_solve():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals[::-1], 95) == 95   # order does not matter
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_uses_statistics_quartiles():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.quartile_spread(vals) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("ivs,length", [
    ([], 0.0), ([(0, 1)], 1.0), ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.7)], 2.0), ([(0, 4), (1, 2), (3, 4)], 4.0)])
def test_union_of_device_intervals(ivs, length):
    assert stats.union_length(ivs) == pytest.approx(length)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 1, "args": args}


def synthetic_trace():
    """Two solves: in the first the port's call replays a graph (two
    kernels of the port and a copy share its launch's correlation), then
    the loop's own reduction kernel; the second solve's port call
    launches one glue kernel."""
    return [
        ev("user_annotation", "loop.solve", 0, 100),
        ev("user_annotation", "port.matvec_kernel", 5, 30),
        ev("cuda_runtime", "cudaMemcpyAsync", 6, 2, correlation=1),
        ev("cuda_runtime", "cudaGraphLaunch", 10, 5, correlation=2),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 12, 3,
           correlation=1),
        ev("kernel", "void delta_pages_acc_kernel<float>(...)", 20, 30,
           correlation=2),
        ev("kernel", "void dia_kernel<float>(...)", 50, 10, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 3, correlation=3),
        ev("cpu_op", "aten::sum", 38, 10),
        ev("kernel", "reduce_kernel", 65, 5, correlation=3),
        ev("cpu_op", "aten::item", 70, 30),
        ev("user_annotation", "loop.solve", 110, 40),
        ev("user_annotation", "port.matvec_kernel", 112, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 113, 2, correlation=4),
        ev("kernel", "elementwise_kernel", 120, 10, correlation=4),
        ev("gpu_user_annotation", "port.matvec_kernel", 12, 48),
        {"ph": "i", "name": "marker", "ts": 3},
    ]


def test_summarize_attributes_by_correlation_and_names_idle_gaps(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": synthetic_trace()}))
    t = devtrace.summarize(devtrace.load(str(path)))
    assert t["window_us"] == 150
    # device: 12-15, 20-60, 65-70, 120-130 (the gpu annotation is no op)
    assert t["busy_us"] == 3 + 40 + 5 + 10
    # inside the port: the copy, both port kernels and the glue kernel
    assert t["attributed"] == 4 and t["port_calls"] == 2
    assert t["port_us"] == 3 + 30 + 10 + 10
    assert t["glue_us"] == 3 + 10
    ops = dict(t["device_ops"])
    assert ops["void delta_pages_acc_kernel<float>(...)"] == pytest.approx(
        30e-6)
    assert t["device_ops"][0][0].startswith("void delta_pages_acc")
    gaps = dict(t["idle_gaps"])
    # 70-120: aten::item (70-100) holds the midpoint 95
    assert gaps["aten::item"] == pytest.approx(50e-6)
    # 0-12: the copy's launch (6-8) holds the midpoint; 60-65: aten::sum
    # ended at 48, so the solve; 15-20: the port call; 130-150: the
    # second solve
    assert gaps["cudaMemcpyAsync"] == pytest.approx(12e-6)
    assert gaps["loop.solve"] == pytest.approx((5 + 20) * 1e-6)
    assert gaps["port.matvec_kernel"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx((150 - 58) * 1e-6)


def test_summarize_without_solves_reads_nothing():
    assert devtrace.summarize([ev("kernel", "k", 0, 1)]) == {}


@pytest.mark.parametrize("name,value", [
    ("spmv_roofline", None), ("glue.device_pct", None),
    ("device.idle_pct", None), ("cg_roofline", None)])
def test_trace_readers_return_nothing_without_a_trace(name, value):
    class Run:
        trace = {}
    assert harness.load_module("metrics", name).read(Run()) is value


def test_port_kernel_names_are_the_ports():
    for name in ("k1_lp_kernel", "k2_kb_kernel", "void dia_kernel<double>",
                 "delta_pages_acc_kernel", "lane_gather_kb_kernel"):
        assert devtrace.PORT_KERNEL.search(name), name
    for name in ("vectorized_elementwise_kernel", "reduce_kernel",
                 "Memcpy DtoD (Device -> Device)", "indexFuncLargeIndex"):
        assert not devtrace.PORT_KERNEL.search(name), name
