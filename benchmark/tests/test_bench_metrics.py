"""The metric arithmetic on synthetic traces: interval union, idle gaps, a
percentile over all records, a rate over whole blocks, bytes counted once,
and each per-layer reader."""
import pytest
import torch

from benchmark import harness, roofline, timeline
from benchmark.timeline import DeviceOp, HostEvent, Trace

PORT = frozenset({"lane_brent_kernel", "fd_brent_kernel",
                  "runoff_hourly_kernel"})


def test_union_merges_overlaps_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert timeline.union_ns(iv) == 15 + 11 + 1
    assert timeline.union_ns(iv, 8, 25) == 7 + 5
    assert timeline.union_ns([]) == 0


def test_idle_gaps_between_merged_segments():
    gaps = timeline.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 12)
    assert gaps == [(0, 2), (6, 8), (9, 12)]
    assert timeline.idle_gaps([(0, 12)], 0, 12) == []


def test_percentile_is_over_all_records():
    vals = list(range(1, 101))              # 1..100
    assert timeline.percentile(vals, 95) == 95
    assert timeline.percentile([3.0] * 19 + [50.0], 95) == 3.0
    assert timeline.percentile([3.0] * 18 + [50.0, 60.0], 95) == 50.0
    with pytest.raises(ValueError):
        timeline.percentile([], 95)


def test_rate_over_whole_blocks():
    # 3 blocks of 30 records of 1,000 cells in 2 s
    assert harness.cell_steps_rate(3, 30, 1000, 2.0) == 45000.0


def test_port_kernels_by_whole_name():
    assert timeline.is_port_kernel(
        "void lane_brent_kernel<GlacierLane, BrentLane>(LaneInputs)", PORT)
    assert not timeline.is_port_kernel(
        "void at::native::vectorized_elementwise_kernel<4>(int)", PORT)
    assert not timeline.is_port_kernel("my_lane_brent_kernel2(int)", PORT)
    assert not timeline.is_port_kernel("Memcpy DtoH (Device -> Pageable)",
                                       PORT)


def test_kernel_names_from_sources(tmp_path):
    (tmp_path / "a.cu").write_text(
        "__global__ void __launch_bounds__(kBlock, 2)\n  foo_kernel(int a)"
        " {}\n__global__ void bar(float* x) {}\nvoid host_fn() {}\n")
    assert timeline.port_kernel_names(tmp_path) == {"foo_kernel", "bar"}


def test_program_sources_hold_the_cells_kernels():
    names = timeline.port_kernel_names(harness.CSRC)
    for k in ("lane_brent_kernel", "runoff_hourly_kernel",
              "node_sweep_kernel", "fd_brent_kernel"):
        assert k in names


def _trace():
    ops = [DeviceOp("void lane_brent_kernel<A>(x)", 100, 200),
           DeviceOp("void at::native::elementwise_kernel<1>(y)", 200, 260),
           DeviceOp("Memcpy DtoH (Device -> Pageable)", 300, 340),
           DeviceOp("void fd_brent_kernel<B>(z)", 400, 900)]
    host = [HostEvent("bench.window", 0, 1000),
            HostEvent("bench.block", 0, 1000),
            HostEvent("aten::item", 340, 390),
            HostEvent("aten::add", 260, 280),
            HostEvent("Activity Buffer Request", 920, 960)]
    return Trace(records=4, step_host_s=[0.001, 0.002, 0.003, 0.004],
                 record_ms=[5.0, 6.0, 7.0, 100.0], profiled_records=2,
                 ops=ops, host=host, window_ns=(0, 1000), port_kernels=PORT,
                 roofline=(125e-9, frozenset({"void fd_brent_kernel<B>(z)"})))


def _read(name, t):
    return harness.metric_reader(name)(t)


def test_readers_on_a_synthetic_trace():
    t = _trace()
    assert _read("dispatch_ms", t) == pytest.approx(2.5)
    assert _read("record_ms_p95", t) == 100.0
    assert _read("kernel_device_ms", t) == pytest.approx(600 / 1e6 / 2)
    assert _read("glue_device_ms", t) == pytest.approx(100 / 1e6 / 2)
    assert _read("launches_per_record", t) == 1.5
    busy = 100 + 60 + 40 + 500
    # the profiler's own 40 ns in an idle gap leave the window
    assert _read("device_idle_pct", t) == pytest.approx(100 * (1 - busy
                                                               / 960))
    # the bound over the named kernels' 500 ns in the trace
    assert _read("kernel_roofline_pct", t) == pytest.approx(25.0)


def test_readers_return_nothing_without_data():
    t = Trace()
    for name in ("dispatch_ms", "record_ms_p95", "glue_device_ms",
                 "kernel_device_ms", "kernel_roofline_pct",
                 "device_idle_pct", "launches_per_record"):
        assert _read(name, t) is None


def test_breakdown_labels_gaps_by_host_activity():
    b = timeline.breakdown(_trace())
    assert b["device_ops"][0] == ["void fd_brent_kernel<B>(z)", 500e-9]
    gaps = sorted((round(s * 1e9), lab) for lab, s in b["idle_gaps"])
    # 0..100 and 900..1000 inside the block's span only, 340..400 in an
    # item's, 260..300 after the add has ended
    assert gaps == [(40, "bench.block"), (60, "bench.block / aten::item"),
                    (100, "bench.block"),
                    (100, "bench.block / Activity Buffer Request")]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_bytes_counted_once():
    a = torch.zeros(100, 8)                   # 3,200 bytes
    col = torch.zeros(100, 1).expand(100, 8)  # broadcast: 400 bytes
    assert roofline.distinct_bytes([a]) == 3200
    assert roofline.distinct_bytes([col]) == 400
    assert roofline.distinct_bytes([a, a, col]) == 3600
    assert roofline.call_bytes((a,), {"x": {"y": col}, "n": 3}, (a,)) == \
        3600 + 3200


def test_bound_is_the_larger_side():
    assert roofline.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.work("no_such_kernel", (), {}, None) is None


def test_profiler_idle_time_is_its_host_work_inside_idle_gaps():
    t = _trace()
    assert timeline.profiler_idle_ns(t) == 40
    # where the device is busy the profiler's host work costs no idle time
    t.host.append(HostEvent("Activity Buffer Request", 450, 500))
    assert timeline.profiler_idle_ns(t) == 40


def test_span_ops_are_the_ops_inside_the_kernel_spans():
    ops = [DeviceOp("void lane_brent_kernel<A>(x)", 100, 200),
           DeviceOp("void at::native::fill<1>(y)", 205, 210),
           DeviceOp("void fd_brent_kernel<B>(z)", 400, 900)]
    host = [HostEvent(timeline.KERNEL_SPAN, 90, 212),
            HostEvent("aten::add", 300, 350)]
    got = timeline.span_ops(ops, host, timeline.KERNEL_SPAN)
    assert [o.name for o in got] == ["void lane_brent_kernel<A>(x)",
                                     "void at::native::fill<1>(y)"]


def test_roofline_charges_the_least_work_of_the_inputs():
    """A lane-Brent call is charged MIN_SOLVE_EVALS evaluations on each
    active lane, whatever its own iteration counts say."""
    from types import SimpleNamespace
    active = torch.tensor([[True, False], [True, True]])
    lo = torch.zeros(2, 2)

    def res(iters):
        return SimpleNamespace(root=torch.zeros(2, 2),
                               iterations=torch.full((2, 2), iters),
                               bracketed=torch.ones(2, 2, dtype=torch.bool))
    few = roofline.work("canopy_brent", (lo, lo, active), {}, res(2))
    many = roofline.work("canopy_brent", (lo, lo, active), {}, res(60))
    assert few == many
    assert few[1] == 3 * roofline.MIN_SOLVE_EVALS * \
        roofline.RESIDUAL_OPS["canopy_brent"]
