"""The port's own spans and counters (vic_tpu_torch.trace), on the CPU.

- Under torch.profiler a step is one vic.step span a record, the physics
  phases it runs its children (CLOSE_ENERGY's passes and the column's
  phases below them); the CPU path calls no kernel wrapper, so it opens no
  vic.kernel.* span.
- With no profiler a step opens no record of either form (both are made
  to raise), and its outputs and state equal a traced step's bit for bit.
- `records` and `close_energy_passes` count step calls and the passes
  OUT_TCANOPY_ITER reports; the launch counts are kernels.launches.
- The driver's stage_s keeps its keys, each value timed inside its
  vic.driver.<stage> span.
"""
import collections
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vic_tpu_torch import driver, kernels, trace
from vic_tpu_torch import config as tconfig
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.model import make_step
from vic_tpu_torch.testing import write_driver_run

COLUMN = ["vic.step.canopy_snow", "vic.step.snow", "vic.step.glacier",
          "vic.step.snow", "vic.step.surface"]
# each configuration's phases under vic.step, in order
PHASES = {
    "light": ["vic.step.forcing", "vic.step.soil_thermal", "vic.step.column",
              "vic.step.runoff", "vic.step.soil_nodes",
              "vic.step.water_balance", "vic.step.outputs"],
    "frozen": ["vic.step.forcing", "vic.step.soil_thermal",
               "vic.step.column", "vic.step.runoff", "vic.step.soil_nodes",
               "vic.step.water_balance", "vic.step.outputs"],
    "blowing_close": ["vic.step.forcing", "vic.step.soil_thermal",
                      "vic.step.blowing", "vic.step.close_energy",
                      "vic.step.runoff", "vic.step.soil_nodes",
                      "vic.step.water_balance", "vic.step.outputs"],
}
N_REC = 2


def _build(config, n_rec=N_REC):
    gp, params, stack, state, ex = CONFIGS[config](2, n_rec, "cpu")
    step = make_step(params, gp, ex["geom"], ex["zwt_curves"],
                     ex["lake_params"])
    return step, stack, state


def _run(step, stack, state, n_rec=N_REC):
    outs = []
    for i in range(n_rec):
        state, o = step(state, {k: v[i] for k, v in stack.items()})
        outs.append(o)
    return state, outs


def _vic_children(event):
    return [c for c in event.cpu_children if c.name.startswith("vic.")]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, prof.events()


@functools.lru_cache(maxsize=None)
def _traced(config):
    """N_REC records of `config` under the profiler (a plain step on the
    CPU records every operation, so each configuration is traced once):
    ((final state, outputs a record), events)."""
    step, stack, state = _build(config)
    return _profiled(lambda: _run(step, stack, state))


@pytest.mark.parametrize("config", sorted(PHASES))
def test_step_is_one_span_a_record_with_its_phases(config):
    _, events = _traced(config)
    steps = [e for e in events if e.name == "vic.step"]
    assert len(steps) == N_REC
    for e in steps:
        assert [c.name for c in _vic_children(e)] == PHASES[config]
    columns = [e for e in events if e.name == "vic.step.column"]
    assert columns
    for e in columns:
        assert [c.name for c in _vic_children(e)] == COLUMN
    assert not [e for e in events if e.name.startswith("vic.kernel.")]


def test_close_energy_passes_hold_one_column_each():
    (_, outs), events = _traced("blowing_close")
    close = [e for e in events if e.name == "vic.step.close_energy"]
    assert len(close) == N_REC
    for e, o in zip(close, outs):
        kids = [c.name for c in _vic_children(e)]
        passes = int(o["OUT_TCANOPY_ITER"][0])
        assert passes > 1
        # the passes, then the column at the settled temperature
        assert kids == ["vic.step.close_energy.pass"] * passes + [
            "vic.step.column"]
        for p in _vic_children(e)[:-1]:
            assert [c.name for c in _vic_children(p)] == ["vic.step.column"]


def _raise(*args, **kwargs):
    raise AssertionError("a record was opened with no profiler running")


@pytest.mark.parametrize("config", ["light", "frozen"])
def test_no_profiler_opens_no_record_and_changes_nothing(config,
                                                         monkeypatch):
    traced_state, traced = _traced(config)[0]
    step, stack, state = _build(config)
    with monkeypatch.context() as m:
        for mod in (trace, torch._C._profiler):
            name = "_Record" if mod is trace else "_RecordFunctionFast"
            m.setattr(mod, name, _raise)
        m.setattr(torch.autograd.profiler, "record_function", _raise)
        m.setattr(torch.profiler, "record_function", _raise)
        plain_state, plain = _run(step, stack, state)
    for a, b in zip(traced, plain):
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
    for k, v in traced_state.numpy().items():
        np.testing.assert_array_equal(plain_state.numpy()[k], v, err_msg=k)


def test_off_spans_are_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("vic.a") is trace.span("vic.b")
    assert trace.phases() is trace.span("vic.a")
    with trace.phases() as ph:
        ph("vic.c")
        ph(None)


def test_records_and_close_energy_passes_are_counted():
    n_rec = 3
    step, stack, state = _build("blowing_close", n_rec)
    before = trace.counters()
    _, outs = _run(step, stack, state, n_rec)
    after = trace.counters()
    assert after["records"] - before["records"] == n_rec
    passes = sum(int(o["OUT_TCANOPY_ITER"][0]) for o in outs)
    assert passes > n_rec
    assert (after["close_energy_passes"] - before["close_energy_passes"]
            == passes)
    # the CPU step launches nothing and reaches no device counter
    for k in trace.DEVICE_COUNTERS:
        assert after[k] == before[k]
    assert all(after[f"launches.{k}"] == before[f"launches.{k}"]
               for k in kernels.launches)


def test_one_registry_of_launch_counts():
    assert kernels.launches is trace.launches
    assert kernels.reset_launches is trace.reset_launches
    counts = trace.counters()
    assert all(type(v) is int for v in counts.values())
    assert set(counts) == ({"records", "close_energy_passes"}
                           | set(trace.DEVICE_COUNTERS)
                           | {f"launches.{k}" for k in kernels.launches})
    # every counted kernel wrapper is wrapped in its span
    for name in kernels.launches:
        assert getattr(kernels, name).__wrapped__.__name__ == name


def test_kernel_span_covers_the_wrappers_checks():
    """A wrapper's checks lie inside its span: a CPU call refused by
    name still shows as vic.kernel.<name>, and counts no launch."""
    x = torch.zeros(4)
    before = kernels.launches["glacier_brent"]

    def call():
        with pytest.raises(ValueError, match="CUDA tensors required"):
            kernels.glacier_brent(x, x, None, dt=1.0, max_iter=3,
                                  max_tries=2)
    _, events = _profiled(call)
    assert [e.name for e in events if e.name.startswith("vic.")] == [
        "vic.kernel.glacier_brent"]
    assert kernels.launches["glacier_brent"] == before


@pytest.fixture(scope="module")
def driver_gp(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_driver")
    gp = tconfig.parse_global_param_file(write_driver_run(
        root, n_cell=2, start=(1995, 9, 25), n_day=4))
    return gp.replace(save_state=False)


def test_stage_s_is_timed_inside_each_stage_span(driver_gp):
    res, events = _profiled(lambda: driver.run_simulation(
        driver_gp, write_output=False, progress=False, device="cpu"))
    assert set(res.stage_s) == {"params", "forcing", "run", "write"}
    for stage, seconds in res.stage_s.items():
        (span,) = [e for e in events if e.name == f"vic.driver.{stage}"]
        # the span opens before the stage's clock starts and closes after
        # it stops (the profiler's microseconds, a few of rounding)
        assert 0 < seconds * 1e6 <= span.time_range.elapsed_us() + 5, stage
    assert res.elapsed_s == res.stage_s["run"]


def test_driver_stages_blocks_and_copies_are_spans(driver_gp):
    res, events = _profiled(lambda: driver.run_simulation(
        driver_gp.replace(cell_chunk=1), write_output=False,
        progress=False, device="cpu"))
    top = collections.Counter(e.name for e in events
                              if e.name.startswith("vic.driver."))
    assert top == {"vic.driver.params": 1, "vic.driver.forcing": 1,
                   "vic.driver.run": 1, "vic.driver.block": 2,
                   "vic.driver.copy": 2, "vic.driver.write": 1}
    run = next(e for e in events if e.name == "vic.driver.run")
    blocks = [c for c in _vic_children(run)]
    assert [c.name for c in blocks] == ["vic.driver.block"] * 2
    for b in blocks:
        kids = collections.Counter(c.name for c in b.cpu_children
                                   if c.name.startswith("vic."))
        assert kids == {"vic.step": res.timeaxis.nrecs,
                        "vic.driver.copy": 1}
    assert set(res.stage_s) == {"params", "forcing", "run", "write"}
