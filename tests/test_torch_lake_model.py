"""The port's lakes step against vic_tpu.model.run(..., lake_params=).

4 cells x 4 daily January records of the lakes configuration (the light
one with LAKES on the synthetic parabolic basin, floats cast to float32 as
__graft_entry__ casts them) through both packages from the very same
float32 bits: the port's parameters, state, forcing and lake parameters are
filled field by field from vic_tpu's. All 186 OUT_* and all 51 final-state
fields at rtol = atol = 1e-4, water closure within 1e-2 mm on both; the
lakes' tolerance leaves (the two storage residuals at their ulp bounds, the
mix near 4 C, the m^3 leaves in mm over the cell) as
vic_tpu_torch.testing.lake_run_failures holds them (ROADMAP.md queue 3).
"""
import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vic_tpu.model import run as jax_run
from vic_tpu_torch import kernels, model
from vic_tpu_torch.entry import build_lakes, lakes_params
from vic_tpu_torch.prepare import (device_params_from_numpy,
                                   lake_params_from_numpy)
from vic_tpu_torch.state import state_from_numpy
from vic_tpu_torch.testing import lake_run_failures, synthetic_domain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

N_CELL, N_REC = 4, 4
TOL = 1e-4
WATER_TOL = 1e-2


def fields_of(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@functools.lru_cache(maxsize=None)
def both_runs():
    gp, params, stack, state, lp = fixture.lakes_inputs(N_CELL, N_REC)
    j_final, j_outs = jax.jit(lambda s, f: jax_run(s, f, params, gp,
                                                   lake_params=lp))(
        state, stack)
    t_stack = {k: torch.tensor(np.asarray(v)) for k, v in stack.items()
               if k not in ("month", "day_in_year")}
    t_stack.update(month=np.asarray(stack["month"]),
                   day_in_year=np.asarray(stack["day_in_year"]))
    t_final, t_outs = model.run(
        state_from_numpy(fields_of(state), "cpu"), t_stack,
        device_params_from_numpy(fields_of(params), "cpu"), gp,
        lake_params=lake_params_from_numpy(lp, "cpu"))
    return (j_final, {k: np.asarray(v) for k, v in j_outs.items()},
            t_final, {k: v.numpy() for k, v in t_outs.items()})


def _cell_area():
    return synthetic_domain(n_cell=N_CELL, n_band=2,
                            with_glacier=True).soil.cell_area


def test_all_outputs_match():
    _, j_outs, _, t_outs = both_runs()
    assert len(j_outs) == 186
    assert sorted(t_outs) == sorted(j_outs)
    ref = {f"out/{k}": v for k, v in j_outs.items()}
    got = {f"out/{k}": v for k, v in t_outs.items()}
    assert lake_run_failures(ref, got, TOL, _cell_area()) == []


def test_final_state_matches():
    j_final, _, t_final, _ = both_runs()
    names = [f.name for f in dataclasses.fields(j_final)]
    assert len(names) == 51
    assert names == [f.name for f in dataclasses.fields(t_final)]
    ref = {f"state/{n}": np.asarray(getattr(j_final, n)) for n in names}
    got = {f"state/{n}": getattr(t_final, n).numpy() for n in names}
    assert lake_run_failures(ref, got, TOL, _cell_area()) == []


def test_water_closure_and_the_lake_paths_run():
    """Water closes on both; in these January records the lakes freeze over
    and carry snow, so the open-water and under-ice columns, the ice Brent
    and the depth bisection all run."""
    _, j_outs, t_final, t_outs = both_runs()
    assert np.abs(j_outs["OUT_WATER_ERROR"]).max() <= WATER_TOL
    assert np.abs(t_outs["OUT_WATER_ERROR"]).max() <= WATER_TOL
    ice = t_outs["OUT_LAKE_ICE_FRACT"]
    assert ice[0].min() < 1.0 and ice[-1].max() > 0.02
    assert float(t_final.lake_swe.max()) > 0.0
    assert np.abs(t_outs["OUT_LAKE_RCHRG"]).max() >= 0.0


def test_cpu_lakes_step_takes_the_plain_versions():
    gp, params, stack, state, extras = build_lakes(2, 1, "cpu")
    lp = extras["lake_params"]
    kernels.reset_launches()
    model.make_step(params, gp, lake_params=lp)(
        state, {k: v[0] for k, v in stack.items()})
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_lakes_step_does_not_write_into_its_inputs():
    gp, params, stack, state, extras = build_lakes(3, 2, "cpu")
    lp = extras["lake_params"]
    before = {k: v.copy() for k, v in state.numpy().items()}
    lp_before = {k: v.copy() for k, v in lp.numpy().items()}
    model.make_step(params, gp, lake_params=lp)(
        state, {k: v[0] for k, v in stack.items()})
    for k, v in state.numpy().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    for k, v in lp.numpy().items():
        np.testing.assert_array_equal(v, lp_before[k], err_msg=k)


def test_wetland_host_is_the_first_candidate_lane():
    """The wetland host lane is the first valid non-glacier band-0 lane
    (vic_tpu takes jnp.argmax of the bool mask): argmax over the 0/1 lanes
    returns the first of tied maxima."""
    cand = torch.tensor([[False, True, True, False],
                         [True, True, True, True],
                         [False, False, False, True],
                         [False, False, False, False]])
    idx = cand.to(torch.uint8).argmax(dim=1)
    assert idx.tolist() == [1, 0, 3, 0]


@pytest.mark.parametrize("flags,match", [
    (dict(blowing=True), "lakes with blowing"),
    (dict(quick_flux=False), "lakes on finite-difference nodes"),
    (dict(dist_prcp=True), "lakes with dist_prcp")])
def test_heavy_lake_options_are_refused(flags, match):
    """LAKES with BLOWING, on finite-difference nodes and with DIST_PRCP
    were refused (`match` named the refusal) until the heavy configuration
    came: each now builds its step, and with FROZEN_SOIL's SPATIAL_FROST it
    is refused by that name."""
    from vic_tpu_torch.entry import build_frozen
    _, params, _, _, extras = build_frozen(1, 1, "cpu")
    geom = extras["geom"]
    _, _, _, _, extras = build_lakes(1, 1, "cpu")
    lp = extras["lake_params"]
    gp = lakes_params(1).replace(**flags)
    try:
        model.make_step(params, gp, geom=None if gp.quick_flux else geom,
                        lake_params=lp)
    except NotImplementedError as err:
        pytest.fail(f"{match} is refused again: {err}")
    frost = gp.replace(frozen_soil=True, quick_flux=False, spatial_frost=True)
    with pytest.raises(NotImplementedError, match="SPATIAL_FROST"):
        model.make_step(params, frost, geom=geom, lake_params=lp)


def test_lake_params_without_lakes_are_refused():
    gp, params, _, _, extras = build_lakes(1, 1, "cpu")
    lp = extras["lake_params"]
    with pytest.raises(NotImplementedError, match="lake_params without"):
        model.make_step(params, gp.replace(lakes=False), lake_params=lp)
