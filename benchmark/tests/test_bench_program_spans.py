"""The readers of the program's own spans and counters on synthetic traces:
each reads the vic.* host events of vic_tpu_torch.trace, leaves a mirrored
vic.* annotation among the device operations uncounted, and returns None
where the trace has no vic.step span (a program without the spans)."""
import sys

import pytest

from benchmark import harness, program_spans, timeline
from benchmark.timeline import DeviceOp, HostEvent, Trace

SPAN_READERS = ("glue_host_ms", "kernel_call_host_ms", "step_runtime_ms",
                "idle_in_step_pct")


def _trace(with_spans=True):
    ops = [DeviceOp("void lane_brent_kernel<A>(x)", 100, 200),
           DeviceOp("void at::native::elementwise_kernel<1>(y)", 600, 900),
           # a mirror of the program's span on the device's timeline
           DeviceOp("vic.step", 50, 450)]
    host = [HostEvent("bench.window", 0, 1000),
            HostEvent("bench.block", 0, 1000),
            HostEvent("cudaLaunchKernel", 120, 130),
            HostEvent("cudaMalloc", 200, 260),
            HostEvent("Activity Buffer Request", 300, 340),
            HostEvent("aten::add", 160, 190),
            HostEvent("cudaLaunchKernel", 620, 630),
            # the copy after the block's steps
            HostEvent("cudaMemcpyAsync", 960, 990)]
    if with_spans:
        host += [HostEvent("vic.step", 50, 450),
                 HostEvent("vic.step.forcing", 60, 100),
                 HostEvent("vic.kernel.surface_brent", 100, 150),
                 HostEvent("vic.step.snow", 200, 440),
                 HostEvent("vic.step", 500, 950),
                 HostEvent("vic.kernel.fd_surface_brent", 600, 700)]
    return Trace(profiled_records=2, ops=ops, host=host, window_ns=(0, 1000),
                 port_kernels=frozenset({"lane_brent_kernel"}))


def _read(name, t):
    return harness.metric_reader(name)(t)


def test_glue_is_the_steps_less_the_kernel_calls():
    # steps 400 + 450 ns, kernel spans 50 + 100 ns, over 2 records
    assert _read("glue_host_ms", _trace()) == pytest.approx(700 / 1e6 / 2)


def test_kernel_calls_are_the_kernel_spans():
    assert _read("kernel_call_host_ms", _trace()) == pytest.approx(
        150 / 1e6 / 2)


def test_step_runtime_is_the_cuda_calls_inside_the_steps():
    # 10 + 60 + 10 ns inside the steps; the copy after them is not
    assert _read("step_runtime_ms", _trace()) == pytest.approx(80 / 1e6 / 2)


def test_idle_in_step_is_a_share_of_the_idle_time():
    # device busy 100..200 and 600..900 (the vic.step mirror is not device
    # work): idle 100 + 400 + 100 ns, 40 of it the profiler's; inside the
    # steps 50 + 250 + 100 + 50 ns, the profiler's 40 among them
    got = _read("idle_in_step_pct", _trace())
    assert got == pytest.approx(100.0 * (450 - 40) / (600 - 40))


def test_a_mirrored_span_is_not_device_work():
    t = _trace()
    assert [o.name for o in program_spans.device_only(t).ops] == [
        o.name for o in t.ops[:2]]
    gaps, own = program_spans.idle_segments(t)
    assert gaps == [(0, 100), (200, 600), (900, 1000)] and own == 40


@pytest.mark.parametrize("name", SPAN_READERS)
def test_no_step_span_reads_nothing(name):
    """A program without the spans (an older checkout) reads None, not 0;
    so does an empty trace."""
    assert _read(name, _trace(with_spans=False)) is None
    assert _read(name, Trace()) is None


def test_gaps_between_aten_calls_are_named_by_the_phase():
    t = _trace()
    assert timeline.host_label(t.host, 300) == (
        "bench.block / Activity Buffer Request")
    assert timeline.host_label(t.host, 400) == "bench.block / vic.step.snow"
    assert timeline.host_label(t.host, 470) == "bench.block"


def test_k7_sweeps_per_record_reads_the_programs_counters(monkeypatch):
    from vic_tpu_torch import trace
    counts = {"records": 32, "k7_sweeps": 11632,
              "launches.fd_surface_brent": 32}
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    assert _read("k7_sweeps_per_record", Trace()) == 363.5
    # no K7 launch, no record: nothing to read
    counts["launches.fd_surface_brent"] = 0
    assert _read("k7_sweeps_per_record", Trace()) is None
    counts.update({"records": 0, "launches.fd_surface_brent": 32})
    assert _read("k7_sweeps_per_record", Trace()) is None


def test_k7_sweeps_per_record_without_the_counters(monkeypatch):
    import vic_tpu_torch
    monkeypatch.delattr(vic_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "vic_tpu_torch.trace", None)
    assert _read("k7_sweeps_per_record", Trace()) is None
