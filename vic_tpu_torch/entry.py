"""Entry points: the configurations the port runs, built on a device.

- `build_light`: the flagship light configuration,
  `__graft_entry__._build(heavy=False)`: FULL_ENERGY, snow, a glacier HRU,
  2 elevation bands, QUICK_FLUX, daily records.
- `build_frozen`: the same plus the heavy configuration's frozen-soil
  settings (`__graft_entry__.py:33-36`): FROZEN_SOIL on 5 finite-difference
  soil nodes (QUICK_FLUX off), IMPLICIT, a 10-sweep Gauss-Seidel cap.
- `build_blowing_close`: the light configuration plus BLOWING and
  CLOSE_ENERGY (`__graft_entry__.py:37`), on a windy, cold forcing.
- `build_lakes`: the light configuration plus LAKES, one lake per cell on
  the synthetic parabolic basin of `physics.lake.make_lake_params` (the
  heavy configuration's basin, `__graft_entry__.py:56-62`).
- `build_dist_prcp`: the light configuration plus DIST_PRCP, on
  `heavy_forcing`'s split forcing at daily steps.
- `build_heavy_nolakes`: the heavy configuration of
  `__graft_entry__._build(heavy=True)` without LAKES: 3-hourly steps,
  FROZEN_SOIL on 5 finite-difference nodes, CLOSE_ENERGY, DIST_PRCP,
  BLOWING, with the water-table curves (`bench.py:66-68`), on
  `heavy_forcing`.
- `build_heavy`: the heavy configuration of
  `__graft_entry__._build(heavy=True)` itself: `build_heavy_nolakes` with
  LAKES, one lake per cell on the synthetic parabolic basin.

All run on the seeded synthetic domain and forcing, on the CUDA device
unless the caller names another one. Each returns (gp, params, stack,
state, extras), extras the dict of `model.run`'s keyword arguments geom,
zwt_curves and lake_params (each None where the configuration has none),
ready for `model.run(state, stack, params, gp, **extras)`.
"""
from __future__ import annotations

import numpy as np

from .config import GlobalParams
from .model import make_forcing_stack
from .physics.frozen_soil import build_node_geometry
from .physics.hydrology_misc import build_zwt_curves, zwt_curves_to
from .physics.lake import make_lake_params
from .prepare import lake_params_from_numpy, prepare_domain
from .state import initial_state
from .testing import synthetic_domain, synthetic_forcing
from .timeaxis import make_time_axis


def light_params(n_rec: int) -> GlobalParams:
    return GlobalParams(dt=24, nlayer=3, startyear=1995, startmonth=1,
                        startday=1, nrecs=n_rec, full_energy=True,
                        glacier_id=99, snow_band=2)


def frozen_params(n_rec: int) -> GlobalParams:
    # IMPLICIT is inert in the step (the explicit sweep always runs) and
    # fd_affine_residual without CLOSE_ENERGY; both as the heavy config sets
    return light_params(n_rec).replace(
        frozen_soil=True, quick_flux=False, nnode=5, implicit=True,
        soil_sweep_maxiter=10, fd_affine_residual=True)


def blowing_close_params(n_rec: int) -> GlobalParams:
    return light_params(n_rec).replace(blowing=True, close_energy=True)


def lakes_params(n_rec: int) -> GlobalParams:
    return light_params(n_rec).replace(lakes=True)


def dist_prcp_params(n_rec: int) -> GlobalParams:
    return light_params(n_rec).replace(dist_prcp=True)


def heavy_nolakes_params(n_rec: int) -> GlobalParams:
    # __graft_entry__._build(heavy=True)'s flags but LAKES; the sweep cap and
    # the affine residual keep their defaults there (10, True)
    return light_params(n_rec).replace(
        dt=3, snow_step=3, frozen_soil=True, implicit=True, quick_flux=False,
        nnode=5, close_energy=True, dist_prcp=True, blowing=True)


def heavy_params(n_rec: int) -> GlobalParams:
    # __graft_entry__._build(heavy=True)'s flags (__graft_entry__.py:27-40)
    return heavy_nolakes_params(n_rec).replace(lakes=True)


# the forcing offsets that take the synthetic forcing to blowing snow and
# to snow-laden overstory canopies, as vic_tpu's own tests reach those
# paths (tests/test_blowing_snow.py:85, tests/test_close_energy.py:22)
BLOWING_CLOSE_WIND = 8.0        # m/s added to the wind
BLOWING_CLOSE_AIR_TEMP = -12.0  # C added to the air temperature


def blowing_close_forcing(n_rec: int, n_cell: int, dt_hours: int = 24):
    """synthetic_forcing with the BLOWING_CLOSE_* offsets. The vapor
    pressure is scaled by the saturation ratio of the two temperatures, so
    the air keeps the relative humidity synthetic_forcing drew: the colder
    air would otherwise be supersaturated everywhere, and no snow would
    sublimate."""
    forc = synthetic_forcing(n_rec, n_cell, dt_hours=dt_hours)
    t_old = forc["air_temp"]
    t_new = t_old + BLOWING_CLOSE_AIR_TEMP

    def svp(t):
        return 610.78 * np.exp(17.269 * t / (237.3 + t))
    forc["vp"] = forc["vp"] * svp(t_new) / svp(t_old)
    forc["air_temp"] = t_new
    forc["wind"] = forc["wind"] + BLOWING_CLOSE_WIND
    return forc


# the heavy forcing's warm cells: the air this much warmer, as vic_tpu's
# own DIST_PRCP tests keep lanes snow-free (tests/test_dist_prcp.py:19)
HEAVY_WARM_AIR_TEMP = 10.0      # C


def heavy_forcing(n_rec: int, n_cell: int, dt_hours: int = 3):
    """The heavy configuration's test forcing, split by cell: odd cells get
    blowing_close_forcing (8 m/s more wind, 12 C colder air, the relative
    humidity kept), so packs blow and overstory canopies hold snow and
    iterate their canopy air; even cells get synthetic_forcing with the air
    HEAVY_WARM_AIR_TEMP warmer and the vapor pressure unchanged, so they
    stay snow-free and rain falls on a wet fraction mu < 1. synthetic_forcing
    alone reaches no blowing snow."""
    forc = synthetic_forcing(n_rec, n_cell, dt_hours=dt_hours)
    cold = blowing_close_forcing(n_rec, n_cell, dt_hours=dt_hours)
    forc["air_temp"] = forc["air_temp"] + HEAVY_WARM_AIR_TEMP
    odd = np.arange(n_cell) % 2 == 1
    return {k: np.where(odd, cold[k], v) for k, v in forc.items()}


def _build(gp, n_cell: int, n_rec: int, device, zwt: bool = False,
           forcing=synthetic_forcing):
    """The synthetic domain under `gp` on `device`: its node geometry with
    QUICK_FLUX off, its lakes' parameters with LAKES, its water-table curves
    if `zwt`."""
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    params = prepare_domain(domain, gp, device)
    ax = make_time_axis(1995, 1, 1, 0, n_rec, gp.dt)
    stack = make_forcing_stack(forcing(n_rec, n_cell, dt_hours=gp.dt), ax,
                               device)
    geom = (None if gp.quick_flux
            else build_node_geometry(domain.soil, gp).to(device))
    lake_params = (lake_params_from_numpy(make_lake_params(domain.soil, gp),
                                          device) if gp.lakes else None)
    zwt_curves = (zwt_curves_to(build_zwt_curves(domain.soil), device)
                  if zwt else None)
    state = initial_state(domain, gp, device, geom=geom,
                          lake_params=lake_params)
    return gp, params, stack, state, dict(geom=geom, zwt_curves=zwt_curves,
                                          lake_params=lake_params)


def build_light(n_cell: int, n_rec: int, device="cuda"):
    """The light configuration on `device` (see the module docstring for
    the returned tuple)."""
    return _build(light_params(n_rec), n_cell, n_rec, device)


def build_frozen(n_cell: int, n_rec: int, device="cuda"):
    """The frozen-soil configuration on `device`; extras["geom"] is its
    NodeGeometry of finite-difference nodes."""
    return _build(frozen_params(n_rec), n_cell, n_rec, device)


def build_blowing_close(n_cell: int, n_rec: int, device="cuda"):
    """The light configuration with BLOWING and CLOSE_ENERGY on `device`.
    Its forcing is synthetic_forcing with 8 m/s more wind and 12 C colder
    air (blowing_close_forcing), so that packs blow and overstory canopies
    hold snow and iterate their canopy air."""
    return _build(blowing_close_params(n_rec), n_cell, n_rec, device,
                  forcing=blowing_close_forcing)


def build_lakes(n_cell: int, n_rec: int, device="cuda"):
    """The light configuration with LAKES on `device`, on the light forcing
    unchanged (January: the lakes freeze over and carry snow within the
    first records); extras["lake_params"] is the synthetic basin's
    LakeParams."""
    return _build(lakes_params(n_rec), n_cell, n_rec, device)


def build_dist_prcp(n_cell: int, n_rec: int, device="cuda"):
    """The light configuration with DIST_PRCP on `device`, daily records of
    heavy_forcing: rain falls on a wet fraction mu < 1 of the warm cells."""
    return _build(dist_prcp_params(n_rec), n_cell, n_rec, device,
                  forcing=heavy_forcing)


def build_heavy_nolakes(n_cell: int, n_rec: int, device="cuda"):
    """The heavy configuration without LAKES on `device`, 3-hourly records
    on heavy_forcing; extras carries its node geometry and water-table
    curves."""
    return _build(heavy_nolakes_params(n_rec), n_cell, n_rec, device,
                  zwt=True, forcing=heavy_forcing)


def build_heavy(n_cell: int, n_rec: int, device="cuda"):
    """The heavy configuration with LAKES on `device`, 3-hourly records on
    heavy_forcing; extras carries its node geometry, water-table curves and
    lake parameters."""
    return _build(heavy_params(n_rec), n_cell, n_rec, device, zwt=True,
                  forcing=heavy_forcing)


# configuration name -> the function that builds it, for callers that
# take the name
CONFIGS = {"light": build_light, "frozen": build_frozen,
           "blowing_close": build_blowing_close, "lakes": build_lakes,
           "dist_prcp": build_dist_prcp, "heavy_nolakes": build_heavy_nolakes,
           "heavy": build_heavy}
