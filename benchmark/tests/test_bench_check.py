"""The check that decides `correct`: a sound run passes, every fault a
cell can have fails it, and so does the control. On the CPU both sides
take the program's plain path, so a sound run's gaps are 0 here; the
limits are the configurations' own."""
import dataclasses
import time

import pytest
import torch

from benchmark import compare, control, gen, harness

# cells shrunk to what a CPU test holds: (cells, records a block)
SIZES = {"light-jan-524k": (32, 3), "frozen_exp-jan-65k": (2, 4)}


def _resize(name):
    n, r = SIZES[name]

    def resize(cfg, traffic):
        check = dict(cfg["check"])
        if check.get("sample_cells"):
            check["sample_cells"] = n // 2
        return dict(cfg, check=check), dict(traffic, n_cell=n,
                                            block_records=r, trace_blocks=1)
    return resize


def _run(name, fault=None, seed=2 ** 31 + 77):
    args = harness.parse(["--workload", name, "--seed", str(seed),
                          "--seconds", "0", "--trace", "0"])
    result, checks = harness.run(args, time.perf_counter(),
                                 check_card_fn=lambda chips: None,
                                 fault=fault, resize=_resize(name))
    return result, checks


def _state_unchanged(cell):
    step = cell.step

    def broken(state, forcing):
        _, outs = step(state, forcing)
        return state, outs
    cell.step = broken


def _half_batch(cell):
    """The step runs on every cell, then the second half of the batch is
    left out: its outputs and state are the mean over the first half's."""
    step = cell.step

    def broken(state, forcing):
        new, outs = step(state, forcing)
        half = cell.n_cell // 2

        def fill(t):
            if not isinstance(t, torch.Tensor) or t.shape[:1] != \
                    (cell.n_cell,):
                return t
            t = t.clone()
            t[half:] = t[:half].to(torch.float64).mean(0).to(t.dtype)
            return t
        new = dataclasses.replace(new, **{
            f.name: fill(getattr(new, f.name))
            for f in dataclasses.fields(new)})
        return new, {k: fill(v) for k, v in outs.items()}
    cell.step = broken


def _answer_altered(cell):
    """One answer altered where it is produced: the first record's
    evaporation 1% higher in every cell."""
    step = cell.step
    calls = [0]

    def broken(state, forcing):
        new, outs = step(state, forcing)
        if calls[0] % cell.n_rec == 0:
            outs = dict(outs, OUT_EVAP=outs["OUT_EVAP"] * 1.01 + 1e-3)
        calls[0] += 1
        return new, outs
    cell.step = broken


def _last_record_altered(cell):
    """The block's last record wrong where it is produced: its node
    temperatures 0.5 C warmer in every cell, in the state it hands on and
    in the surface temperature it reports."""
    step = cell.step
    calls = [0]

    def broken(state, forcing):
        new, outs = step(state, forcing)
        if calls[0] % cell.n_rec == cell.n_rec - 1:
            new = dataclasses.replace(new, node_temp=new.node_temp + 0.5)
            outs = dict(outs, OUT_SURF_TEMP=outs["OUT_SURF_TEMP"] + 0.5)
        calls[0] += 1
        return new, outs
    cell.step = broken


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "last_record_altered": _last_record_altered}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_is_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"cell_steps_per_s", "peak_mem_gib",
                                      "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SIZES))
def test_fault_is_not_correct(name, fault):
    result, checks = _run(name, fault=FAULTS[fault])
    assert not result["correct"], checks
    assert result["failed"] == 1


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(name):
    _, _, cfg, traffic = harness.cell_spec(name)
    cfg, traffic = _resize(name)(cfg, traffic)
    nums = control.control_numbers(cfg, traffic, 2 ** 31 + 5,
                                   torch.device("cpu"))
    assert not compare.verdict(nums, cfg["limits"]), nums


def test_sampled_cells_are_the_whole_batchs():
    """Light's columns share nothing: the reference over a sample of cells
    equals the whole batch's run at those cells."""
    _, _, cfg, traffic = harness.cell_spec("light-jan-524k")
    traffic = dict(traffic, n_cell=24, block_records=3)
    domain, forcing = gen.cell_inputs(cfg, traffic, 9)
    cells = torch.tensor([1, 5, 6, 17, 23]).numpy()
    cpu = torch.device("cpu")
    whole, whole_state = compare.run_reference(cfg, traffic, domain,
                                               forcing, cpu)
    part, part_state = compare.run_reference(cfg, traffic, domain, forcing,
                                             cpu, cells)
    for k in whole:
        torch.testing.assert_close(torch.as_tensor(part[k]),
                                   torch.as_tensor(whole[k][:, cells]),
                                   rtol=1e-6, atol=1e-6)
    for k in whole_state:
        torch.testing.assert_close(torch.as_tensor(part_state[k]),
                                   torch.as_tensor(whole_state[k][cells]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_run_on_the_card_at_a_small_size(card):
    result, checks = harness.run(
        harness.parse(["--workload", "light-jan-524k", "--seed", "5",
                       "--seconds", "1", "--trace", "1"]),
        time.perf_counter(), resize=_resize("light-jan-524k"))
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
