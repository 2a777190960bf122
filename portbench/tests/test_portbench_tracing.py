"""The reduction of a chrome trace: the graphs' device time from their
events, eager activity from the trace, the window's clip."""

import portbench_paths  # noqa: F401  (first: the paths)
import pytest

import tracing


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("user_annotation", tracing.WINDOW, 1000.0, 1000.0),
    _ev("cpu_op", "aten::mul", 1000.0, 50.0),
    _ev("kernel", "mul_kernel", 1010.0, 40.0, corr=1),  # eager: 1010-1050
    _ev("cuda_runtime", "cudaGraphLaunch", 1060.0, 10.0, corr=2),
    _ev("kernel", "set_condition_kernel", 1100.0, 2.0, corr=2),  # graph starts at 1100
    _ev("kernel", "apply_kernel<float, 4, 10, 6>", 1150.0, 70.0, corr=2),
    _ev("cpu_op", "aten::copy_", 1700.0, 200.0),
    _ev("gpu_memcpy", "Memcpy DtoH", 1800.0, 5.0, corr=3),  # eager: 1800-1805
    _ev("kernel", "late_kernel", 2500.0, 10.0, corr=4),  # outside the window
    _ev("cuda_runtime", "cudaGraphLaunch", 500.0, 10.0, corr=5),  # a launch before it
    _ev("kernel", "set_condition_kernel", 520.0, 2.0, corr=5),
]


def test_busy_is_the_union_of_eager_activity_and_the_graphs_event_time():
    t = tracing.reduce(EVENTS, requests=1, graph_s=[500e-6])  # graph: 1100-1600
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((40 + 500 + 5) * 1e-6)
    assert t.ops[tracing.GRAPHS] == pytest.approx(500e-6)
    assert t.ops["mul_kernel"] == pytest.approx(40e-6) and "late_kernel" not in t.ops
    assert t.calls(lambda n: "apply_kernel<" in n) == {
        "apply_kernel<float, 4, 10, 6>": [pytest.approx(70e-6)]}
    assert set(t.calls(lambda n: n.endswith("_kernel"))) == {"set_condition_kernel"}  # eager out
    longest = t.gaps[0]
    assert longest[0] == pytest.approx(200e-6) and longest[1] == "aten::copy_"  # 1600-1800


def test_launches_without_a_recorded_kernel_still_count():
    t = tracing.reduce(EVENTS, requests=1, graph_s=[500e-6, 100e-6])
    assert t.busy_s == pytest.approx((40 + 5 + 600) * 1e-6)


def test_breakdown_lists_at_most_ten_of_each():
    t = tracing.reduce(EVENTS, requests=1, graph_s=[500e-6])
    b = t.breakdown()
    assert b["device_ops"][0][0] == tracing.GRAPHS
    assert len(b["device_ops"]) <= tracing.TOP and len(b["idle_gaps"]) <= tracing.TOP


class _Run:
    config = {"coarse": {"dim": 100, "storage": "bfloat16"}}

    def __init__(self, trace):
        self.trace = trace


def test_a_roofline_reads_one_kernel_and_nothing_where_two_match():
    import readers
    import yardstick

    events = EVENTS + [_ev("kernel", "apply_kernel<double, 4, 10, 6>", 1300.0, 30.0, corr=2)]
    work = yardstick.coarse_gemv_work
    one = readers.roofline(_Run(tracing.reduce(EVENTS, 1, [500e-6])),
                           lambda n: n.startswith("apply_kernel<"), work, "bfloat16")
    assert one == pytest.approx(yardstick.roofline_share(work(_Run.config), "bfloat16", 70e-6))
    two = readers.roofline(_Run(tracing.reduce(events, 1, [500e-6])),
                           lambda n: n.startswith("apply_kernel<"), work, "bfloat16")
    assert two is None
