"""The port's light step and time loop against vic_tpu.model.run.

4 cells x 4 daily records of the light configuration (__graft_entry__'s
_build(heavy=False)) through both packages from the very same float32
bits: the port's parameters, state and forcing are filled field by field
from vic_tpu's. All 150 OUT_* and all 51 final-state fields at
rtol = atol = 1e-4, water closure within 1e-2 mm on both. A second
configuration takes every other option value the light step reads: one
band without a glacier, SUN1999 albedo, SNTHRM density, the VIC_412
rain/snow ramp, GF_FULL ground flux and a minimum wind speed. A third adds
DIST_PRCP to the light one (entry.dist_prcp_params) on the split forcing of
entry.heavy_forcing, where rain falls on a wet fraction mu < 1; there the
reference leaves a closure residual on the raining glacier lanes (ROADMAP.md
queue 3), so only its cold cells are held to 1e-2 mm.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from vic_tpu.constants import (GroundFlux, RainSnowMethod, SnowAlbedo,
                               SnowDensity)
from vic_tpu.model import make_forcing_stack as jax_forcing_stack
from vic_tpu.model import run as jax_run
from vic_tpu.prepare import prepare_domain as jax_prepare_domain
from vic_tpu.state import initial_state as jax_initial_state
from vic_tpu.testing import synthetic_domain as jax_synthetic_domain
from vic_tpu.testing import synthetic_forcing as jax_synthetic_forcing
from vic_tpu.timeaxis import make_time_axis
from vic_tpu_torch import model
from vic_tpu_torch.entry import (build_dist_prcp, build_frozen, build_light,
                                 dist_prcp_params, heavy_forcing,
                                 light_params)
from vic_tpu_torch.physics.hydrology_misc import (build_zwt_curves,
                                                  zwt_curves_to)
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.state import state_from_numpy
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

N_CELL, N_REC = 4, 4
TOL = 1e-4
WATER_TOL = 1e-2


def fields_of(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _variant_inputs():
    gp = light_params(N_REC).replace(
        glacier_id=-1, snow_band=1, snow_albedo=SnowAlbedo.SUN1999,
        snow_density=SnowDensity.DENS_SNTHRM,
        temp_th_type=RainSnowMethod.VIC_412,
        grnd_flux_type=GroundFlux.GF_FULL, min_wind_speed=0.5)
    domain = jax_synthetic_domain(n_cell=N_CELL, n_band=1, seed=5)
    stack = jax_forcing_stack(
        jax_synthetic_forcing(N_REC, N_CELL, seed=9, start_doy=60),
        make_time_axis(1995, 3, 1, 0, N_REC, 24))
    return (gp, jax_prepare_domain(domain, gp), stack,
            jax_initial_state(domain, gp))


def _dist_prcp_inputs():
    gp = dist_prcp_params(N_REC)
    domain = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    stack = jax_forcing_stack(heavy_forcing(N_REC, N_CELL, dt_hours=24),
                              make_time_axis(1995, 1, 1, 0, N_REC, 24))
    return (gp, jax_prepare_domain(domain, gp), stack,
            jax_initial_state(domain, gp))


CONFIGS = ("light", "variant", "dist_prcp")


@functools.lru_cache(maxsize=None)
def both_runs(config):
    if config == "light":
        gp, params, stack, state, _ = __graft_entry__._build(N_CELL,
                                                             n_rec=N_REC)
    elif config == "variant":
        gp, params, stack, state = _variant_inputs()
    else:
        gp, params, stack, state = _dist_prcp_inputs()
    j_final, j_outs = jax.jit(lambda s, f: jax_run(s, f, params, gp))(
        state, stack)
    t_stack = {k: torch.tensor(np.asarray(v)) for k, v in stack.items()
               if k not in ("month", "day_in_year")}
    t_stack.update(month=np.asarray(stack["month"]),
                   day_in_year=np.asarray(stack["day_in_year"]))
    t_final, t_outs = model.run(
        state_from_numpy(fields_of(state), "cpu"), t_stack,
        device_params_from_numpy(fields_of(params), "cpu"), gp)
    return (j_final, {k: np.asarray(v) for k, v in j_outs.items()},
            t_final, {k: v.numpy() for k, v in t_outs.items()})


@pytest.mark.parametrize("config", CONFIGS)
def test_all_outputs_match(config):
    _, j_outs, _, t_outs = both_runs(config)
    assert len(j_outs) == (116 if config == "variant" else 150)
    assert sorted(t_outs) == sorted(j_outs)
    for k, a in j_outs.items():
        b = t_outs[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("config", CONFIGS)
def test_final_state_matches(config):
    j_final, _, t_final, _ = both_runs(config)
    names = [f.name for f in dataclasses.fields(j_final)]
    assert len(names) == 51
    assert names == [f.name for f in dataclasses.fields(t_final)]
    for n in names:
        a = np.asarray(getattr(j_final, n))
        b = getattr(t_final, n).numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, n
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=n)
        else:
            np.testing.assert_array_equal(b, a, err_msg=n)


@pytest.mark.parametrize("config", CONFIGS)
def test_water_closure_on_both(config):
    _, j_outs, t_final, t_outs = both_runs(config)
    if config == "dist_prcp":
        # the odd cells are cold: no rain on a wet fraction there
        cells = slice(1, None, 2)
        assert bool((t_final.mu < 1.0).any())
    else:
        cells = slice(None)
    assert np.abs(j_outs["OUT_WATER_ERROR"][:, cells]).max() <= WATER_TOL
    assert np.abs(t_outs["OUT_WATER_ERROR"][:, cells]).max() <= WATER_TOL
    # water moves: precipitation falls and the snowpack builds
    assert t_outs["OUT_PREC"].sum() > 0 and t_outs["OUT_SWE"].max() > 0


def test_step_does_not_write_into_its_inputs():
    gp, params, stack, state, _ = build_light(3, 2, "cpu")
    before = {k: v.copy() for k, v in state.numpy().items()}
    step = model.make_step(params, gp)
    step(state, {k: v[0] for k, v in stack.items()})
    for k, v in state.numpy().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_outvars_prunes_but_keeps_water_error():
    gp, params, stack, state, _ = build_light(2, 2, "cpu")
    _, outs = model.run(state, stack, params, gp,
                        outvars=["OUT_EVAP", "OUT_SWE"])
    assert sorted(outs) == ["OUT_EVAP", "OUT_SWE", "OUT_WATER_ERROR"]
    assert outs["OUT_EVAP"].shape == (2, 2)


def test_params_from_jax_objects_run_identically():
    """Parameters handed over field by field from vic_tpu's DeviceParams
    give the same step as the port's own prepare_domain."""
    _, params, _, _, _ = __graft_entry__._build(2, n_rec=1)
    p_from_jax = device_params_from_numpy(fields_of(params), "cpu")
    t_gp, t_params, t_stack, t_state, _ = build_light(2, 1, "cpu")
    forc = {k: v[0] for k, v in t_stack.items()}
    _, a = model.make_step(p_from_jax, t_gp)(t_state, forc)
    _, b = model.make_step(t_params, t_gp)(t_state, forc)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# LAKES steps with DIST_PRCP, BLOWING and CLOSE_ENERGY, but not without its
# lakes' parameters, which these calls do not pass
@pytest.mark.parametrize("flag", [
    dict(full_energy=False), dict(frozen_soil=True), dict(quick_flux=False),
    dict(dist_prcp=True, lakes=True), dict(blowing=True, lakes=True),
    dict(spatial_snow=True), dict(close_energy=True, quick_flux=False,
                                  lakes=True),
    dict(lakes=True), dict(corrprec=True), dict(continue_on_error=True),
    dict(exp_trans=True)],
    ids=lambda d: next(iter(d)))
def test_make_step_refuses_options_outside_the_slice(flag):
    gp = light_params(1).replace(**flag)
    _, params, _, _, extras = build_frozen(1, 1, "cpu")
    # CLOSE_ENERGY steps on finite-difference nodes; every combination with
    # LAKES is refused for the missing lake_params
    on_nodes = "close_energy" in flag
    match = "lakes without lake_params" if flag.get("lakes") \
        else next(iter(flag))
    with pytest.raises(NotImplementedError, match=match):
        model.make_step(params, gp, geom=extras["geom"] if on_nodes
                        else None)


def test_make_step_refuses_water_table_curves():
    """Water-table curves step with every configuration; LAKES without its
    lakes' parameters is refused whatever the curves."""
    gp, params, _, _, extras = build_frozen(1, 1, "cpu")
    curves = zwt_curves_to(build_zwt_curves(
        synthetic_domain(1, n_band=2, with_glacier=True).soil), "cpu")
    model.make_step(params, gp, geom=extras["geom"], zwt_curves=curves)
    with pytest.raises(NotImplementedError,
                       match="lakes without lake_params"):
        model.make_step(params, gp.replace(lakes=True), geom=extras["geom"],
                        zwt_curves=curves)


@pytest.mark.parametrize("option", ["dist_prcp", "zwt_curves"])
def test_heavy_options_step_on_the_light_base(option):
    """DIST_PRCP and the water-table curves, once refused, step at 2 x 2:
    finite outputs, the light set plus OUT_ZWT, ZWT2, ZWT3 and ZWTL with
    the curves."""
    if option == "dist_prcp":
        gp, params, stack, state, extras = build_dist_prcp(2, 2, "cpu")
        n_out = 150
    else:
        gp, params, stack, state, extras = build_light(2, 2, "cpu")
        extras["zwt_curves"] = zwt_curves_to(build_zwt_curves(
            synthetic_domain(2, n_band=2, with_glacier=True).soil), "cpu")
        n_out = 154
    final, outs = model.run(state, stack, params, gp, **extras)
    assert len(outs) == n_out
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())
    assert all(np.isfinite(v).all() for v in final.numpy().values()
               if v.dtype.kind == "f")
