"""Entry points: the configurations the port runs, built on a device.

- `build_light`: the flagship light configuration,
  `__graft_entry__._build(heavy=False)`: FULL_ENERGY, snow, a glacier HRU,
  2 elevation bands, QUICK_FLUX, daily records.
- `build_frozen`: the same plus the heavy configuration's frozen-soil
  settings (`__graft_entry__.py:33-36`): FROZEN_SOIL on 5 finite-difference
  soil nodes (QUICK_FLUX off), IMPLICIT, a 10-sweep Gauss-Seidel cap.

Both run on the seeded synthetic domain and forcing, on the CUDA device
unless the caller names another one.
"""
from __future__ import annotations

from .config import GlobalParams
from .model import make_forcing_stack
from .physics.frozen_soil import build_node_geometry
from .prepare import prepare_domain
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


def _build(gp, n_cell: int, n_rec: int, device, frozen: bool):
    domain = synthetic_domain(n_cell=n_cell, n_band=2, with_glacier=True)
    params = prepare_domain(domain, gp, device)
    ax = make_time_axis(1995, 1, 1, 0, n_rec, gp.dt)
    stack = make_forcing_stack(synthetic_forcing(n_rec, n_cell,
                                                 dt_hours=gp.dt), ax, device)
    geom = build_node_geometry(domain.soil, gp).to(device) if frozen else None
    state = initial_state(domain, gp, device, geom=geom)
    return params, stack, state, geom


def build_light(n_cell: int, n_rec: int, device="cuda"):
    """(gp, params, stack, state, geom) of the light configuration on
    `device`, ready for `model.run(state, stack, params, gp, geom=geom)`;
    geom is None (no finite-difference nodes)."""
    gp = light_params(n_rec)
    return (gp, *_build(gp, n_cell, n_rec, device, False))


def build_frozen(n_cell: int, n_rec: int, device="cuda"):
    """(gp, params, stack, state, geom) of the frozen-soil configuration on
    `device`, ready for `model.run(state, stack, params, gp, geom=geom)`."""
    gp = frozen_params(n_rec)
    return (gp, *_build(gp, n_cell, n_rec, device, True))


# configuration name -> the function that builds it, for callers that
# take the name
CONFIGS = {"light": build_light, "frozen": build_frozen}
