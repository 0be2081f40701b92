"""CONTINUEONERROR on the lakes base, the port against vic_tpu on CPU.

The lakes configuration (the light one with LAKES on the synthetic
parabolic basin) with CONTINUEONERROR, 2 cells x 4 daily records, through
both packages from the very same float32 bits, with NaN air temperature in
one cell from the third record. The NaN reaches the cell's lake: the
open-water and under-ice columns, the ice's Brent and the depth bisections
(on the card K10-K13). Both packages freeze that cell's state from then on
and write OUT_CELL_VALID 0 there; the other cell's outputs and every state
field agree under the lakes' rule at 1e-4
(vic_tpu_torch.testing.lake_run_failures).
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vic_tpu.model import run as jax_run
from vic_tpu_torch import model
from vic_tpu_torch.testing import lake_run_failures, synthetic_domain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
N_CELL, N_REC = 2, 4
NAN_CELL, NAN_FROM = 1, 2


@pytest.fixture(scope="module")
def nan_runs():
    """vic_tpu's and the port's lakes runs with CONTINUEONERROR and NaN air
    temperature in cell NAN_CELL from record NAN_FROM, from the same
    float32 bits, and the port's state after record NAN_FROM - 1."""
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, lp = fixture.lakes_inputs(N_CELL, N_REC)
    gp = dataclasses.replace(gp, continue_on_error=True)
    stack = dict(stack)
    air = np.asarray(stack["air_temp"]).copy()
    air[NAN_FROM:, NAN_CELL] = np.nan
    stack["air_temp"] = jax.numpy.asarray(air)
    j_final, j_outs = jax.jit(lambda s, f: jax_run(s, f, params, gp,
                                                   lake_params=lp))(
        state, stack)
    t_gp, t_params, t_stack, t_state, extras = fixture.port_inputs(
        (gp, params, stack, state, None, lp), N_CELL)
    t_final, t_outs = model.run(t_state, t_stack, t_params, t_gp, **extras)
    before = model.run(t_state, {k: v[:NAN_FROM] for k, v in
                                 t_stack.items()}, t_params, t_gp,
                       **extras)[0]
    return (j_final, {k: np.asarray(v) for k, v in j_outs.items()}, t_final,
            {k: v.numpy() for k, v in t_outs.items()}, before)


def _cell_area():
    return synthetic_domain(n_cell=N_CELL, n_band=2,
                            with_glacier=True).soil.cell_area


def test_continue_on_error_freezes_the_nan_cell_in_both(nan_runs):
    """OUT_CELL_VALID 0 on the NaN cell from NAN_FROM in both packages; the
    port's cell holds its state from before the NaN; every state field
    agrees with vic_tpu's under the lakes' rule."""
    j_final, j_outs, t_final, t_outs, before = nan_runs
    valid = np.ones((N_REC, N_CELL), np.float32)
    valid[NAN_FROM:, NAN_CELL] = 0.0
    np.testing.assert_array_equal(j_outs["OUT_CELL_VALID"], valid)
    np.testing.assert_array_equal(t_outs["OUT_CELL_VALID"], valid)
    assert t_final.cell_valid.tolist() == [c != NAN_CELL
                                           for c in range(N_CELL)]
    ref, got = {}, {}
    for f in dataclasses.fields(j_final):
        b = getattr(t_final, f.name).numpy()
        if f.name != "cell_valid":
            np.testing.assert_array_equal(
                b[NAN_CELL], getattr(before, f.name).numpy()[NAN_CELL],
                err_msg=f.name)
        ref[f"state/{f.name}"] = np.asarray(getattr(j_final, f.name))
        got[f"state/{f.name}"] = b
    assert lake_run_failures(ref, got, TOL, _cell_area()) == []


def test_continue_on_error_outputs_of_both(nan_runs):
    """Every output of the valid cell, and of both cells before NAN_FROM,
    under the lakes' rule at 1e-4; on the NaN cell's invalid records NaN
    where vic_tpu's are NaN, elsewhere 0 or NaN (the port's eager x * valid
    keeps a NaN that XLA-CPU's select writes as 0, ROADMAP.md queue 3); the
    NaN reached the cell's lake outputs."""
    _, j_outs, _, t_outs, _ = nan_runs
    assert sorted(t_outs) == sorted(j_outs)
    area = _cell_area()
    valid = [c for c in range(N_CELL) if c != NAN_CELL]
    for cells, recs in ((valid, slice(None)), (list(range(N_CELL)),
                                               slice(0, NAN_FROM))):
        ref = {f"out/{k}": a[recs][:, cells] for k, a in j_outs.items()}
        got = {f"out/{k}": b[recs][:, cells] for k, b in t_outs.items()}
        assert lake_run_failures(ref, got, TOL, area[cells]) == []
    lake_nan = 0
    for k, a in j_outs.items():
        a_bad, b_bad = a[NAN_FROM:, NAN_CELL], t_outs[k][NAN_FROM:, NAN_CELL]
        assert np.isnan(b_bad[np.isnan(a_bad)]).all(), k
        ok = np.isnan(b_bad) | (b_bad == 0.0)
        assert ok[~np.isnan(a_bad)].all(), k
        lake_nan += int(k.startswith("OUT_LAKE_") and np.isnan(b_bad).any())
    assert lake_nan > 0
