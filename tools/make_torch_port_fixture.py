"""Write the golden fixtures of the port's configurations from vic_tpu on CPU.

16 cells x 4 daily records (8 3-hourly ones for heavy_nolakes) through
`vic_tpu.model.run`: every OUT_* output ("out/<name>", [n_rec, ...]) and
every final-state field ("state/<name>"), compressed, of

- light: `__graft_entry__._build(heavy=False)` -> light_16x4.npz;
- frozen: the light configuration with FROZEN_SOIL on 5 finite-difference
  nodes (vic_tpu_torch.entry.frozen_params) -> frozen_16x4.npz;
- blowing_close: the light configuration with BLOWING and CLOSE_ENERGY on
  the windy, cold forcing of vic_tpu_torch.entry.blowing_close_forcing
  -> blowing_close_16x4.npz;
- lakes: the light configuration with LAKES on the synthetic parabolic
  basin of vic_tpu.physics.lake.make_lake_params, its floats cast to
  float32 as __graft_entry__ casts them -> lakes_16x4.npz;
- heavy_nolakes: `__graft_entry__._build(heavy=True)`'s flags without
  LAKES (3-hourly steps, FROZEN_SOIL on 5 finite-difference nodes,
  CLOSE_ENERGY, DIST_PRCP, BLOWING) with the water-table curves cast to
  float32, on the split forcing of vic_tpu_torch.entry.heavy_forcing, one
  day -> heavy_nolakes_16x8.npz;
- heavy: `__graft_entry__._build(heavy=True)`'s flags, LAKES included, its
  lake parameters cast to float32 as __graft_entry__ casts them, on the
  same split forcing, one day -> heavy_16x8.npz;
- frozen_exp: the frozen configuration on 10 EXP_TRANS nodes with
  SPATIAL_FROST's 10 frost subareas (vic_tpu_torch.entry.frozen_exp_params)
  -> frozen_exp_16x4.npz;
- frozen_quick: the light configuration with FROZEN_SOIL on QUICK_FLUX's 3
  nodes (vic_tpu_torch.entry.frozen_quick_params) -> frozen_quick_16x4.npz;
- spatial_snow: the light configuration with SPATIAL_SNOW, CORRPREC and
  CONTINUEONERROR from 1 May with the spring pack of
  vic_tpu_torch.testing.spring_pack (vic_tpu_torch.entry
  .build_spatial_snow) -> spatial_snow_16x4.npz.

- driver: a run of the main path in the reference's file formats, 16
  cells x 12 daily records from 1995-09-25 with the glacier mass-balance
  interval starting 1994-10-01 (vic_tpu_torch.testing.write_driver_run),
  its inputs written to driver/ with their paths as @FIXDIR@, through
  `vic_tpu.driver.run_simulation`: the aggregated OUT_* ("out/<name>",
  [n_out, ...]), the final state and the GMB fit ("gmb/b0|b1|b2",
  [n_interval, n_cell]) -> driver_16x12.npz.

The PyTorch port is checked against these files by tests/test_torch_golden*.py
and by chip_smoke.py's reference phases.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py \
        [light|frozen|blowing_close|lakes|heavy_nolakes|heavy|frozen_exp|
         frozen_quick|spatial_snow|driver]
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_port")
FIXTURE = os.path.join(FIXTURE_DIR, "light_16x4.npz")
FROZEN_FIXTURE = os.path.join(FIXTURE_DIR, "frozen_16x4.npz")
BLOWING_CLOSE_FIXTURE = os.path.join(FIXTURE_DIR, "blowing_close_16x4.npz")
LAKES_FIXTURE = os.path.join(FIXTURE_DIR, "lakes_16x4.npz")
HEAVY_NOLAKES_FIXTURE = os.path.join(FIXTURE_DIR, "heavy_nolakes_16x8.npz")
HEAVY_FIXTURE = os.path.join(FIXTURE_DIR, "heavy_16x8.npz")
FROZEN_EXP_FIXTURE = os.path.join(FIXTURE_DIR, "frozen_exp_16x4.npz")
FROZEN_QUICK_FIXTURE = os.path.join(FIXTURE_DIR, "frozen_quick_16x4.npz")
SPATIAL_SNOW_FIXTURE = os.path.join(FIXTURE_DIR, "spatial_snow_16x4.npz")
# the flags frozen_exp and frozen_quick set on the frozen configuration's
FROZEN_EXP_FLAGS = dict(nnode=10, exp_trans=True, spatial_frost=True,
                        frost_subareas=10, frost_slope=2.0)
FROZEN_QUICK_FLAGS = dict(quick_flux=True, nnode=3, implicit=False)
DRIVER_DIR = os.path.join(FIXTURE_DIR, "driver")
DRIVER_FIXTURE = os.path.join(FIXTURE_DIR, "driver_16x12.npz")
DRIVER_RUN = dict(n_cell=16, start=(1995, 9, 25), n_day=12,
                  accum_start=(1994, 10, 1), july_tavg=(6.0, 16.0))
N_CELL, N_REC = 16, 4
HEAVY_N_REC = 8     # one day of 3-hourly records


def _arrays(final, outs) -> dict:
    arrays = {f"out/{k}": np.asarray(v) for k, v in outs.items()}
    arrays.update({f"state/{f}": np.asarray(getattr(final, f))
                   for f in final.__dataclass_fields__})
    return arrays


def light_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """{"out/OUT_*": ..., "state/<field>": ...} float32/int32/bool arrays."""
    import jax
    jax.config.update("jax_enable_x64", False)
    sys.path.insert(0, ROOT)
    import __graft_entry__
    from vic_tpu.model import run

    gp, params, stack, state, _ = __graft_entry__._build(n_cell, n_rec=n_rec)
    final, outs = jax.jit(lambda s, f: run(s, f, params, gp))(state, stack)
    return _arrays(final, outs)


def frozen_inputs(n_cell: int, n_rec: int, frozen: bool = True, **flags):
    """vic_tpu's (gp, params, stack, state, geom) of the frozen-soil
    configuration (finite-difference nodes without frozen soil if not
    `frozen`), with the GlobalParams `flags` replaced (FROZEN_EXP_FLAGS,
    FROZEN_QUICK_FLAGS); geom holds numpy float64 arrays."""
    sys.path.insert(0, ROOT)
    from vic_tpu.config import GlobalParams
    from vic_tpu.model import make_forcing_stack
    from vic_tpu.physics.frozen_soil import build_node_geometry
    from vic_tpu.prepare import prepare_domain
    from vic_tpu.state import initial_state
    from vic_tpu.testing import synthetic_domain, synthetic_forcing
    from vic_tpu.timeaxis import make_time_axis

    gp = GlobalParams(dt=24, nlayer=3, startyear=1995, startmonth=1,
                      startday=1, nrecs=n_rec, full_energy=True,
                      glacier_id=99, snow_band=2, frozen_soil=frozen,
                      quick_flux=False, nnode=5, implicit=True,
                      soil_sweep_maxiter=10,
                      fd_affine_residual=True).replace(**flags)
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    geom = build_node_geometry(domain.soil, gp)
    stack = make_forcing_stack(
        synthetic_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(1995, 1, 1, 0, n_rec, gp.dt))
    return (gp, prepare_domain(domain, gp), stack,
            initial_state(domain, gp, geom=geom), geom)


def frozen_reference(n_cell: int = N_CELL, n_rec: int = N_REC,
                     **flags) -> dict:
    """As light_reference, for the frozen-soil configuration (with the
    GlobalParams `flags` replaced). The node geometry enters the jitted run
    as numpy constants, as `make_step`'s callers build it."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, geom = frozen_inputs(n_cell, n_rec, **flags)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f: run(s, f, params, gp, geom=geom))(
        state, stack)
    return _arrays(final, outs)


def frozen_exp_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the frozen_exp configuration."""
    return frozen_reference(n_cell, n_rec, **FROZEN_EXP_FLAGS)


def frozen_quick_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the frozen_quick configuration."""
    return frozen_reference(n_cell, n_rec, **FROZEN_QUICK_FLAGS)


def blowing_close_inputs(n_cell: int, n_rec: int):
    """vic_tpu's (gp, params, stack, state) of the blowing_close
    configuration, its forcing from the port's numpy
    blowing_close_forcing."""
    sys.path.insert(0, ROOT)
    from vic_tpu.config import GlobalParams
    from vic_tpu.model import make_forcing_stack
    from vic_tpu.prepare import prepare_domain
    from vic_tpu.state import initial_state
    from vic_tpu.testing import synthetic_domain
    from vic_tpu.timeaxis import make_time_axis
    from vic_tpu_torch.entry import blowing_close_forcing

    gp = GlobalParams(dt=24, nlayer=3, startyear=1995, startmonth=1,
                      startday=1, nrecs=n_rec, full_energy=True,
                      glacier_id=99, snow_band=2, blowing=True,
                      close_energy=True)
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    stack = make_forcing_stack(
        blowing_close_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(1995, 1, 1, 0, n_rec, gp.dt))
    return (gp, prepare_domain(domain, gp), stack,
            initial_state(domain, gp))


def blowing_close_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the blowing_close configuration."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state = blowing_close_inputs(n_cell, n_rec)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f: run(s, f, params, gp))(state, stack)
    return _arrays(final, outs)


def lakes_inputs(n_cell: int, n_rec: int):
    """vic_tpu's (gp, params, stack, state, lake_params) of the lakes
    configuration; lake_params holds jnp arrays, floats in float32."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from vic_tpu.config import GlobalParams
    from vic_tpu.model import make_forcing_stack
    from vic_tpu.physics.lake import make_lake_params
    from vic_tpu.prepare import prepare_domain
    from vic_tpu.state import initial_state
    from vic_tpu.testing import synthetic_domain, synthetic_forcing
    from vic_tpu.timeaxis import make_time_axis

    gp = GlobalParams(dt=24, nlayer=3, startyear=1995, startmonth=1,
                      startday=1, nrecs=n_rec, full_energy=True,
                      glacier_id=99, snow_band=2, lakes=True)
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    lake_params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        make_lake_params(domain.soil, gp))
    stack = make_forcing_stack(
        synthetic_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(1995, 1, 1, 0, n_rec, gp.dt))
    return (gp, prepare_domain(domain, gp), stack,
            initial_state(domain, gp, lake_params=lake_params), lake_params)


def lakes_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the lakes configuration."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, lp = lakes_inputs(n_cell, n_rec)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f: run(s, f, params, gp,
                                           lake_params=lp))(state, stack)
    return _arrays(final, outs)


def heavy_nolakes_inputs(n_cell: int, n_rec: int):
    """vic_tpu's (gp, params, stack, state, geom, zwt_curves) of the heavy
    configuration without LAKES, its forcing from the port's numpy
    heavy_forcing; zwt_curves holds jnp float32 arrays, geom numpy float64
    ones."""
    return heavy_inputs(n_cell, n_rec, lakes=False)[:6]


def heavy_inputs(n_cell: int, n_rec: int, lakes: bool = True, **flags):
    """vic_tpu's (gp, params, stack, state, geom, zwt_curves, lake_params)
    of the heavy configuration, with LAKES unless not `lakes` and the
    GlobalParams `flags` replaced, as heavy_nolakes_inputs; lake_params
    holds jnp arrays, floats in float32 as __graft_entry__ casts them (None
    without LAKES)."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from vic_tpu.config import GlobalParams
    from vic_tpu.model import make_forcing_stack
    from vic_tpu.physics.frozen_soil import build_node_geometry
    from vic_tpu.physics.hydrology_misc import build_zwt_curves
    from vic_tpu.physics.lake import make_lake_params
    from vic_tpu.prepare import prepare_domain
    from vic_tpu.state import initial_state
    from vic_tpu.testing import synthetic_domain
    from vic_tpu.timeaxis import make_time_axis
    from vic_tpu_torch.entry import heavy_forcing

    gp = GlobalParams(dt=3, snow_step=3, nlayer=3, startyear=1995,
                      startmonth=1, startday=1, nrecs=n_rec, full_energy=True,
                      glacier_id=99, snow_band=2, frozen_soil=True,
                      implicit=True, quick_flux=False, nnode=5,
                      close_energy=True, dist_prcp=True, blowing=True,
                      lakes=lakes).replace(**flags)
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    geom = build_node_geometry(domain.soil, gp)
    zwt = {k: jnp.asarray(v, jnp.float32)
           for k, v in build_zwt_curves(domain.soil).items()}
    lake_params = (jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        make_lake_params(domain.soil, gp)) if lakes else None)
    stack = make_forcing_stack(
        heavy_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(1995, 1, 1, 0, n_rec, gp.dt))
    return (gp, prepare_domain(domain, gp), stack,
            initial_state(domain, gp, geom=geom, lake_params=lake_params),
            geom, zwt, lake_params)


def heavy_nolakes_reference(n_cell: int = N_CELL,
                            n_rec: int = HEAVY_N_REC) -> dict:
    """As light_reference, for the heavy configuration without LAKES."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, geom, zwt = heavy_nolakes_inputs(n_cell, n_rec)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f, z: run(s, f, params, gp, geom=geom,
                                              zwt_curves=z))(state, stack,
                                                             zwt)
    return _arrays(final, outs)


def heavy_reference(n_cell: int = N_CELL, n_rec: int = HEAVY_N_REC) -> dict:
    """As light_reference, for the heavy configuration with LAKES."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, geom, zwt, lp = heavy_inputs(n_cell, n_rec)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f, z, l: run(
        s, f, params, gp, geom=geom, zwt_curves=z, lake_params=l))(
            state, stack, zwt, lp)
    return _arrays(final, outs)


def spatial_snow_inputs(n_cell: int, n_rec: int, **flags):
    """vic_tpu's (gp, params, stack, state, geom, lake_params) of the
    spatial_snow configuration (vic_tpu_torch.entry.spatial_snow_params with
    the GlobalParams `flags` replaced: FROZEN_SOIL on finite-difference
    nodes, LAKES, ...), from 1 May on vic_tpu_torch.entry.spring_forcing,
    its state the cold start with vic_tpu_torch.testing.spring_pack's pack;
    geom holds numpy float64 arrays (None on QUICK_FLUX without
    FROZEN_SOIL), lake_params jnp arrays, floats in float32 (None without
    LAKES)."""
    sys.path.insert(0, ROOT)
    import dataclasses

    import jax
    import jax.numpy as jnp
    from vic_tpu.config import GlobalParams
    from vic_tpu.model import make_forcing_stack
    from vic_tpu.physics.frozen_soil import build_node_geometry
    from vic_tpu.physics.lake import make_lake_params
    from vic_tpu.prepare import prepare_domain
    from vic_tpu.state import initial_state
    from vic_tpu.testing import synthetic_domain
    from vic_tpu.timeaxis import make_time_axis
    from vic_tpu_torch.entry import spatial_snow_params, spring_forcing
    from vic_tpu_torch.testing import SPRING_START, spring_pack

    t_gp = spatial_snow_params(n_rec).replace(**flags)
    gp = GlobalParams(**{f.name: getattr(t_gp, f.name)
                         for f in dataclasses.fields(t_gp)})
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    geom = (build_node_geometry(domain.soil, gp)
            if gp.frozen_soil or not gp.quick_flux else None)
    lake_params = (jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        make_lake_params(domain.soil, gp)) if gp.lakes else None)
    params = prepare_domain(domain, gp)
    stack = make_forcing_stack(
        spring_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(*SPRING_START, 0, n_rec, gp.dt))
    state = initial_state(domain, gp, geom=geom, lake_params=lake_params)
    state = dataclasses.replace(state, **{
        k: jnp.asarray(v)
        for k, v in spring_pack(np.asarray(params.mask)).items()})
    return gp, params, stack, state, geom, lake_params


def run_inputs(inputs):
    """vic_tpu.model.run, jitted, on (gp, params, stack, state, geom,
    lake_params): (final state, outputs)."""
    import jax
    jax.config.update("jax_enable_x64", False)
    from vic_tpu.model import run

    gp, params, stack, state, geom, lake_params = inputs
    return jax.jit(lambda s, f, l: run(s, f, params, gp, geom=geom,
                                       lake_params=l))(state, stack,
                                                       lake_params)


def port_inputs(inputs, n_cell: int):
    """The port's (gp, params, stack, state, extras) of vic_tpu's `inputs`
    (spatial_snow_inputs) on CPU, from the very same float32 bits: the
    parameters, state, forcing and lake parameters field by field, the node
    geometry built by the port from the same synthetic soil."""
    import dataclasses

    import torch
    from vic_tpu_torch.config import GlobalParams as TGlobalParams
    from vic_tpu_torch.physics.frozen_soil import build_node_geometry
    from vic_tpu_torch.prepare import (device_params_from_numpy,
                                       lake_params_from_numpy)
    from vic_tpu_torch.state import state_from_numpy
    from vic_tpu_torch.testing import synthetic_domain

    def fields_of(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    gp, params, stack, state, geom, lake_params = inputs
    t_gp = TGlobalParams(**{f.name: getattr(gp, f.name)
                            for f in dataclasses.fields(gp)})
    t_stack = {k: torch.tensor(np.asarray(v)) for k, v in stack.items()
               if k not in ("month", "day_in_year")}
    t_stack.update(month=np.asarray(stack["month"]),
                   day_in_year=np.asarray(stack["day_in_year"]))
    t_geom = (build_node_geometry(
        synthetic_domain(n_cell, n_band=2, with_glacier=True).soil,
        t_gp).to("cpu") if geom is not None else None)
    t_lp = (lake_params_from_numpy(lake_params, "cpu")
            if lake_params is not None else None)
    return (t_gp, device_params_from_numpy(fields_of(params), "cpu"),
            t_stack, state_from_numpy(fields_of(state), "cpu"),
            dict(geom=t_geom, lake_params=t_lp))


def spatial_snow_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the spatial_snow configuration."""
    return _arrays(*run_inputs(spatial_snow_inputs(n_cell, n_rec)))


def write_driver_inputs(root) -> str:
    """The driver fixture's input files under `root`, paths as @FIXDIR@."""
    sys.path.insert(0, ROOT)
    from vic_tpu_torch.testing import write_driver_run
    return write_driver_run(root, fixdir="@FIXDIR@", **DRIVER_RUN)


def driver_reference() -> dict:
    """vic_tpu's run of the committed driver inputs (written afresh)."""
    import tempfile

    import jax
    jax.config.update("jax_enable_x64", False)
    sys.path.insert(0, ROOT)
    from vic_tpu.config import parse_global_param_file
    from vic_tpu.driver import run_simulation
    from vic_tpu_torch.testing import relocate_run, run_arrays

    write_driver_inputs(DRIVER_DIR)
    with tempfile.TemporaryDirectory() as tmp:
        gp = parse_global_param_file(relocate_run(DRIVER_DIR, tmp))
        return run_arrays(run_simulation(gp, progress=False))


def main(which: str = "light"):
    path, make = {"light": (FIXTURE, light_reference),
                  "frozen": (FROZEN_FIXTURE, frozen_reference),
                  "blowing_close": (BLOWING_CLOSE_FIXTURE,
                                    blowing_close_reference),
                  "lakes": (LAKES_FIXTURE, lakes_reference),
                  "heavy_nolakes": (HEAVY_NOLAKES_FIXTURE,
                                    heavy_nolakes_reference),
                  "heavy": (HEAVY_FIXTURE, heavy_reference),
                  "frozen_exp": (FROZEN_EXP_FIXTURE, frozen_exp_reference),
                  "frozen_quick": (FROZEN_QUICK_FIXTURE,
                                   frozen_quick_reference),
                  "spatial_snow": (SPATIAL_SNOW_FIXTURE,
                                   spatial_snow_reference),
                  "driver": (DRIVER_FIXTURE, driver_reference)}[which]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(*sys.argv[1:])
