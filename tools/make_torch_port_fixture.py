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
  same split forcing, one day -> heavy_16x8.npz.

The PyTorch port is checked against these files by tests/test_torch_golden*.py
and by chip_smoke.py's reference phase.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py \
        [light|frozen|blowing_close|lakes|heavy_nolakes|heavy]
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


def frozen_inputs(n_cell: int, n_rec: int, frozen: bool = True):
    """vic_tpu's (gp, params, stack, state, geom) of the frozen-soil
    configuration (finite-difference nodes without frozen soil if not
    `frozen`); geom holds numpy float64 arrays."""
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
                      soil_sweep_maxiter=10, fd_affine_residual=True)
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    geom = build_node_geometry(domain.soil, gp)
    stack = make_forcing_stack(
        synthetic_forcing(n_rec, n_cell, dt_hours=gp.dt),
        make_time_axis(1995, 1, 1, 0, n_rec, gp.dt))
    return (gp, prepare_domain(domain, gp), stack,
            initial_state(domain, gp, geom=geom), geom)


def frozen_reference(n_cell: int = N_CELL, n_rec: int = N_REC) -> dict:
    """As light_reference, for the frozen-soil configuration. The node
    geometry enters the jitted run as numpy constants, as `make_step`'s
    callers build it."""
    import jax
    jax.config.update("jax_enable_x64", False)
    gp, params, stack, state, geom = frozen_inputs(n_cell, n_rec)
    from vic_tpu.model import run

    final, outs = jax.jit(lambda s, f: run(s, f, params, gp, geom=geom))(
        state, stack)
    return _arrays(final, outs)


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


def heavy_inputs(n_cell: int, n_rec: int, lakes: bool = True):
    """vic_tpu's (gp, params, stack, state, geom, zwt_curves, lake_params)
    of the heavy configuration, with LAKES unless not `lakes`, as
    heavy_nolakes_inputs; lake_params holds jnp arrays, floats in float32
    as __graft_entry__ casts them (None without LAKES)."""
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
                      lakes=lakes)
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


def main(which: str = "light"):
    path, make = {"light": (FIXTURE, light_reference),
                  "frozen": (FROZEN_FIXTURE, frozen_reference),
                  "blowing_close": (BLOWING_CLOSE_FIXTURE,
                                    blowing_close_reference),
                  "lakes": (LAKES_FIXTURE, lakes_reference),
                  "heavy_nolakes": (HEAVY_NOLAKES_FIXTURE,
                                    heavy_nolakes_reference),
                  "heavy": (HEAVY_FIXTURE, heavy_reference)}[which]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make())
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(*sys.argv[1:])
