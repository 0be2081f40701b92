"""Prognostic model state as one dataclass of tensors.

Counterpart of `vic_tpu/state.py`: the same 51 fields with the same shapes
and dtypes ([n_cell, max_hru] unless noted), carried from record to record
by `model.run`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .constants import MAX_LAKE_NODES
from .physics.frozen_soil import estimate_layer_ice, layer_ice_params
from .physics.lake import initial_lake_state
from .tensors import TensorDataclass


@dataclass
class ModelState(TensorDataclass):
    """All prognostic variables (see vic_tpu/state.py for each field)."""
    moist: torch.Tensor        # [c,h,nl] mm (WET lane)
    ice: torch.Tensor          # [c,h,nl] mm
    moist_dry: torch.Tensor    # [c,h,nl] DRY lane (inert without DIST_PRCP)
    ice_dry: torch.Tensor
    wdew: torch.Tensor         # mm
    wdew_dry: torch.Tensor
    snow_canopy: torch.Tensor  # m
    swq: torch.Tensor          # m
    surf_temp: torch.Tensor
    pack_temp: torch.Tensor
    surf_water: torch.Tensor
    pack_water: torch.Tensor
    density: torch.Tensor
    depth: torch.Tensor
    albedo: torch.Tensor
    last_snow: torch.Tensor    # int32
    melting: torch.Tensor      # bool
    coverage: torch.Tensor
    cold_content: torch.Tensor
    snow_flag: torch.Tensor    # bool
    snow_store_snow: torch.Tensor  # bool
    snow_store_swq: torch.Tensor
    snow_max_swq: torch.Tensor
    snow_swq_slope: torch.Tensor
    snow_store_coverage: torch.Tensor
    node_temp: torch.Tensor    # [c,h,n_node]
    tfoliage: torch.Tensor
    long_under_out: torch.Tensor
    glac_water_storage: torch.Tensor
    glac_cum_mass_balance: torch.Tensor
    glac_surf_temp: torch.Tensor
    surf_temp_fbcount: torch.Tensor  # int32
    snow_temp_fbcount: torch.Tensor  # int32
    mu: torch.Tensor
    still_storm: torch.Tensor  # bool
    dry_time: torch.Tensor     # int32
    cell_valid: torch.Tensor   # [c] bool
    lake_volume: torch.Tensor  # [c]
    lake_temp: torch.Tensor    # [c, MAX_LAKE_NODES]
    lake_ice_we: torch.Tensor
    lake_ice_area: torch.Tensor
    lake_ice_height: torch.Tensor
    lake_swe: torch.Tensor
    lake_tempi: torch.Tensor
    lake_snow_surf_temp: torch.Tensor
    lake_snow_pack_temp: torch.Tensor
    lake_snow_surf_water: torch.Tensor
    lake_snow_pack_water: torch.Tensor
    lake_salbedo: torch.Tensor
    lake_last_snow: torch.Tensor
    lake_melting: torch.Tensor  # [c] bool


def initial_state(domain, gp, device, surf_temp_init=None,
                  geom=None, lake_params=None) -> ModelState:
    """Cold-start state (vic_tpu/state.py:108-217; initialize_model_state.c).
    lake_params: the lakes' LakeParams on `device` (physics.lake), whose
    cold start fills the lake_* fields (initialize_lake.c), else zeros.
    Node temperatures: [surf, surf, avg_temp, ...], or with
    FROZEN_SOIL on finite-difference nodes (`geom`, a NodeGeometry on
    `device`) the exponential profile avg + (surf - avg)*exp(-Zsum) with the
    bottom node at avg, whose layer water then starts partitioned into ice
    (initialize_model_state.c:553-585, :927).

    surf_temp_init: optional per-cell first-step air temperature, clamped
    to >= -1 C like the reference; defaults to the soil's avg_temp."""
    if gp.exp_trans:
        raise NotImplementedError("initial_state: EXP_TRANS node spacing "
                                  "is not ported")
    if gp.frozen_soil and gp.spatial_frost:
        raise NotImplementedError(
            "initial_state: SPATIAL_FROST (spatial_frost with frozen_soil: "
            "the layer ice averaged over frost_subareas temperature "
            "offsets) is not ported")
    f32 = dict(dtype=torch.float32, device=device)
    n_cell, max_hru = domain.hru.mask.shape
    nl = domain.soil.depth.shape[1]
    n_node = max(gp.nnode, 3)
    sh = (n_cell, max_hru)

    def Z(*s):
        return torch.zeros(sh + s, **f32)

    moist = torch.as_tensor(domain.soil.init_moist, **f32)[:, None, :] \
        .expand(sh + (nl,)).clone()
    avg = torch.as_tensor(domain.soil.avg_temp, **f32)
    if surf_temp_init is None:
        t_surf0 = avg
    else:
        t_surf0 = torch.clamp(torch.as_tensor(np.asarray(surf_temp_init),
                                              **f32), min=-1.0)
    t_surf = t_surf0[:, None].expand(sh)
    t_bot = avg[:, None].expand(sh)
    ice = Z(nl)
    if gp.frozen_soil and not gp.quick_flux and geom is not None:
        avg3 = avg[:, None, None]
        node_temp = (avg3 + (t_surf[..., None] - avg3)
                     * torch.exp(-geom.zsum)[:, None, :]).contiguous()
        node_temp[..., -1] = t_bot
        soil = domain.soil
        _, ice = estimate_layer_ice(node_temp, moist, geom, layer_ice_params(
            soil.max_moist, soil.bubble, soil.expt, soil.fs_active, device))
    else:
        node_temp = torch.stack(
            [t_surf, t_surf] + [t_bot] * (n_node - 2), dim=-1).contiguous()
    tk = node_temp[..., 0] + 273.15
    tk2 = tk * tk

    def ZI():
        return torch.zeros(sh, dtype=torch.int32, device=device)

    def ZB(*s):
        return torch.zeros(s or sh, dtype=torch.bool, device=device)

    zc = torch.zeros((n_cell,), **f32)
    if lake_params is not None:
        ls = initial_lake_state(lake_params, avg)
        lake = dict(lake_volume=ls.volume, lake_temp=ls.temp,
                    lake_ice_we=ls.ice_water_eq, lake_ice_area=ls.ice_area,
                    lake_ice_height=ls.ice_height, lake_swe=ls.swe,
                    lake_tempi=ls.tempi, lake_snow_surf_temp=ls.surf_temp,
                    lake_snow_pack_temp=ls.pack_temp,
                    lake_snow_surf_water=ls.surf_water,
                    lake_snow_pack_water=ls.pack_water,
                    lake_salbedo=ls.salbedo, lake_last_snow=ls.last_snow,
                    lake_melting=ls.melting)
    else:
        lake = dict(
            lake_volume=zc,
            lake_temp=torch.zeros((n_cell, MAX_LAKE_NODES), **f32),
            lake_ice_we=zc.clone(), lake_ice_area=zc.clone(),
            lake_ice_height=zc.clone(), lake_swe=zc.clone(),
            lake_tempi=zc.clone(), lake_snow_surf_temp=zc.clone(),
            lake_snow_pack_temp=zc.clone(), lake_snow_surf_water=zc.clone(),
            lake_snow_pack_water=zc.clone(), lake_salbedo=zc.clone(),
            lake_last_snow=zc.clone(), lake_melting=ZB(n_cell))
    return ModelState(
        moist=moist, ice=ice, moist_dry=moist.clone(), ice_dry=ice.clone(),
        wdew=Z(), wdew_dry=Z(), snow_canopy=Z(),
        swq=Z(), surf_temp=Z(), pack_temp=Z(), surf_water=Z(), pack_water=Z(),
        density=Z(), depth=Z(), albedo=Z(), last_snow=ZI(),
        melting=ZB(), coverage=Z(), cold_content=Z(), snow_flag=ZB(),
        snow_store_snow=ZB(), snow_store_swq=Z(), snow_max_swq=Z(),
        snow_swq_slope=Z(), snow_store_coverage=Z(),
        node_temp=node_temp, tfoliage=Z(),
        # sigma*(T[0]+KELVIN)^4 (initialize_model_state.c:291-293)
        long_under_out=5.6696e-8 * (tk2 * tk2),
        glac_water_storage=Z(), glac_cum_mass_balance=Z(), glac_surf_temp=Z(),
        surf_temp_fbcount=ZI(), snow_temp_fbcount=ZI(),
        mu=torch.ones(sh, **f32), still_storm=ZB(),
        dry_time=torch.full(sh, 24, dtype=torch.int32, device=device),
        cell_valid=torch.ones((n_cell,), dtype=torch.bool, device=device),
        **lake,
    )


def state_from_numpy(arrays: dict, device) -> ModelState:
    """ModelState from one numpy array per field (floats become float32,
    flags bool, counters int32)."""
    return ModelState.from_numpy(arrays, device)
