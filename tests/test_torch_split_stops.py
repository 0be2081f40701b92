"""The votes of a split block (vic_tpu_torch/parallel/votes.py): the
ShareGroup's host votes, and a run where the vote matters.

heavy_nolakes (FROZEN_SOIL on 5 finite-difference nodes, CLOSE_ENERGY) on 6
cells split over three CPU devices, two cells a share, the first share's
cells warm and the others' freezing: the warm share alone would stop its
node sweeps and CLOSE_ENERGY passes early, the freezing ones later. Run
share by share on one device (the driver's cell blocks of two,
`chunk_cells=2`) the result differs from the one-device run by more than
the split gate; split over devices, each share voting every batch-wide stop
with the others, it equals the one-device run at that gate
(tests/test_torch_multidevice.py's, rtol = atol = 1e-5, 1e-3 on
OUT_*_ERROR).
"""
import itertools
import math
import threading
import time

import numpy as np
import pytest
import torch

from vic_tpu_torch.parallel.votes import ShareAborted, ShareGroup

torch.set_num_threads(1)

N_CELL, N_REC, SHARES = 6, 1, 3
GATE, ERROR_ATOL = 1e-5, 1e-3


def votes_in_threads(group, fns):
    """fns[i](member i) in share i's thread; their results."""
    out = [None] * len(fns)

    def job(i):
        out[i] = fns[i](group.member(i))
    group.run([lambda i=i: job(i) for i in range(len(fns))])
    return out


@pytest.mark.parametrize("values", [(1.0, math.nan, 3.0), (2.5, 0.5, 1.0),
                                    (math.nan, math.nan, 0.0)])
def test_max_nan_propagates_in_any_order_of_arrival(values):
    """Every share takes the same largest value, NaN if any share's is
    NaN, whichever share reaches the vote first."""
    want = math.nan if any(map(math.isnan, values)) else max(values)
    for order in itertools.permutations(range(len(values))):
        group = ShareGroup(len(values))
        delay = {share: 0.01 * rank for rank, share in enumerate(order)}

        def vote(m):
            time.sleep(delay[m.index])
            return m.max_nan(values[m.index])
        got = votes_in_threads(group, [vote] * len(values))
        assert all(g == want or (math.isnan(g) and math.isnan(want))
                   for g in got), (order, got)


def test_any_takes_every_share():
    group = ShareGroup(3)
    got = votes_in_threads(group, [lambda m: (m.any(m.index == 2),
                                              m.any(False))] * 3)
    assert got == [(True, False)] * 3


def test_abort_wakes_every_waiter():
    """Two shares wait at a vote for a third that never comes; the group's
    abort wakes both with ShareAborted, the aborting error its cause."""
    group = ShareGroup(3, timeout_s=60.0)
    raised = []

    def wait(m):
        try:
            m.max_nan(1.0)
        except ShareAborted as e:
            raised.append(e)
    threads = [threading.Thread(target=wait, args=(group.member(i),))
               for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    boom = ValueError("boom")
    t0 = time.perf_counter()
    group.abort(boom)
    for t in threads:
        t.join(10.0)
    assert time.perf_counter() - t0 < 5.0
    assert len(raised) == 2 and all(e.__cause__ is boom for e in raised)
    assert group.error is boom
    with pytest.raises(RuntimeError, match="aborted"):
        group.restart()


def test_error_in_one_share_is_raised_and_wakes_the_others():
    """ShareGroup.run: a share's error aborts the group, which ends the
    others' wait at their vote; the error raised is the first share's, not
    the others' aborts."""
    group = ShareGroup(3)

    def fail(m):
        raise ValueError("share 1 failed")
    with pytest.raises(ValueError, match="share 1 failed"):
        votes_in_threads(group, [lambda m: m.max_nan(0.0), fail,
                                 lambda m: m.any(True)])


def test_host_vote_times_out():
    group = ShareGroup(2, timeout_s=0.2)
    with pytest.raises(RuntimeError, match="host vote 0 timed out"):
        group.member(0).any(True)


def test_sequence_restarts_per_block():
    """Each share counts its votes; restart (the driver's, at each record
    chunk of a block; a block makes a group of its own) starts them at 0,
    and the votes after it combine as before."""
    group = ShareGroup(2)
    votes_in_threads(group, [lambda m: [m.any(False) for _ in range(3)]] * 2)
    assert group.taken == (3, 3)
    group.restart()
    assert group.taken == (0, 0)
    got = votes_in_threads(group, [lambda m: m.max_nan(m.index)] * 2)
    assert got == [1.0, 1.0] and group.taken == (1, 1)


def warm_and_freezing_forcing(n_rec, dt_hours):
    """heavy_forcing's two kinds of cell by share: the first share's cells
    warm (+10 C, no snow), the others' freezing (blowing_close's
    offsets)."""
    from vic_tpu_torch import entry
    from vic_tpu_torch.testing import synthetic_forcing
    warm = synthetic_forcing(n_rec, N_CELL, dt_hours=dt_hours)
    warm["air_temp"] = warm["air_temp"] + entry.HEAVY_WARM_AIR_TEMP
    cold = entry.blowing_close_forcing(n_rec, N_CELL, dt_hours=dt_hours)
    first = np.arange(N_CELL) < N_CELL // SHARES
    return {k: np.where(first, v, cold[k]) for k, v in warm.items()}


def outside_gate(ref, res):
    """Keys of every output and float state field of `res` (a RunResult)
    outside the gate around `ref`'s, and the largest |difference|."""
    failed, worst = [], 0.0
    pairs = [(k, v, res.outputs[k]) for k, v in ref.outputs.items()]
    pairs += [(f, getattr(ref.final_state, f).numpy(),
               getattr(res.final_state, f).numpy())
              for f in ref.final_state.__dataclass_fields__]
    for k, a, b in pairs:
        if a.dtype.kind != "f" or not a.size:
            if not np.array_equal(a, b):
                failed.append(k)
            continue
        worst = max(worst, float(np.abs(b - a).max()))
        atol = ERROR_ATOL if k.endswith("_ERROR") else GATE
        if not np.allclose(b, a, rtol=GATE, atol=atol):
            failed.append(k)
    return failed, worst


def test_split_vote_matters():
    from vic_tpu_torch import entry
    from vic_tpu_torch.driver import run_simulation
    from vic_tpu_torch.testing import synthetic_domain
    gp = entry.heavy_nolakes_params(N_REC)
    domain = synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    forcing = warm_and_freezing_forcing(N_REC, gp.dt)

    def run(**kw):
        return run_simulation(gp, domain=domain, forcing=dict(forcing),
                              write_output=False, progress=False, **kw)
    one = run(device="cpu")
    alone, alone_worst = outside_gate(one, run(
        device="cpu", chunk_cells=N_CELL // SHARES))
    split, split_worst = outside_gate(one, run(devices=["cpu"] * SHARES))
    print(f"largest |difference| from the one-device run: share by share "
          f"{alone_worst} (outside the gate: {alone}), split "
          f"{split_worst}")
    assert alone, "the shares alone ran as the whole block"
    assert not split, split


def test_shares_of_one_card_divide_it():
    """Shares named on one CUDA device each take their part of its
    co-resident blocks and meet before their launches; shares on CPU
    devices or of a group without devices do neither."""
    one_card = ShareGroup(3, ["cuda:0", "cuda:0", "cuda:1"])
    assert one_card.shares_a_card
    assert [one_card.member(i).grid_divisor for i in range(3)] == [2, 2, 1]
    assert not ShareGroup(2, ["cuda:0", "cuda:1"]).shares_a_card
    assert not ShareGroup(2, ["cpu", "cpu"]).shares_a_card
    assert ShareGroup(2).member(1).grid_divisor == 1
