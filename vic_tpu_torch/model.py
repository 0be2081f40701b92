"""The model step and the time loop.

Counterpart of `vic_tpu/model.py` (make_step :39, run :1807) for FULL_ENERGY
with snow, glacier HRUs and elevation bands, on QUICK_FLUX ground heat or on
finite-difference soil nodes (QUICK_FLUX off; linear or EXP_TRANS spacing, 3 to
50 nodes), either with or without FROZEN_SOIL (and its SPATIAL_FROST subareas),
each with or without BLOWING, CLOSE_ENERGY and DIST_PRCP: the per-record column
physics over the whole [n_cell, max_hru] batch, at any step length. The canopy
-> snow -> glacier -> surface chain is `column(tca, luo)`, run once at Tair,
or, with CLOSE_ENERGY, once per pass of the canopy-air fixed point and once
more at its settled temperature; on finite-difference nodes the passes solve
the surface balance on the affine two-probe node profile (`fd_cheap`) and the
last one on the full node sweep. With DIST_PRCP every HRU carries a wet and a
dry column (`physics.dist_prcp`), rain falls on the wet fraction mu at
intensity P/mu, and the cell sees their mu-weighted sum. With LAKES each cell's
lake steps once after the column and its CLOSE_ENERGY passes
(`physics.lake.lake_step`, with the blowing-snow flux over lake ice under
BLOWING), and its wetland lanes take the lake's recharge and area change. With
water-table curves the step adds OUT_ZWT, ZWT2, ZWT3 and ZWTL. SPATIAL_SNOW
gives each pack a fractional coverage with the depletion curve's memory and
the sensible heat advected from the snow-free patches; CORRPREC corrects rain
and snow for gauge undercatch; CONTINUEONERROR freezes the state of a cell
whose state goes non-finite and writes OUT_CELL_VALID. `run` is a Python loop
over records; month and day-of-year reach the step as host ints, so indexing
the monthly veg tables needs no device-to-host sync.

Every option outside that configuration is refused when the step is built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as c
from . import kernels, trace
from .physics.aero import calc_aerodynamic
from .physics.blowing_snow import calc_blowing_snow
from .physics.canopy_air import (canopy_air_final, canopy_air_step,
                                 largest_change)
from .physics.canopy_snow import snow_intercept
from .physics.dist_prcp import storm_transfer
from .physics.evap import build_evap_pre, compute_pot_evap, svp
from .physics.frozen_soil import (NodeSolve, distribute_node_moisture,
                                  estimate_layer_ice, find_zero_fronts,
                                  frost_kwargs, layer_ice_params)
from .physics.glacier import glacier_ablation
from .physics.hydrology_misc import compute_zwt, correct_precip
from .physics.lake import (LakeState, area_from_depth, check_basin,
                           depth_from_volume, lake_step)
from .physics.runoff import runoff_step
from .physics.snow import (calc_rainonly, calc_snow_coverage,
                           new_snow_density, snow_albedo,
                           snow_density_update, snow_melt)
from .physics.soil_thermal import layer_thermal_props, maximum_unfrozen_water
from .physics.surface import solve_surface_temperature, surf_energy_terms
from .prepare import DeviceParams
from .state import ModelState

# the CLOSE_ENERGY stop compares the float32 batch max with OVER_TOL rounded
# to float32, as vic_tpu's jnp.max(live) <= OVER_TOL does
OVER_TOL_F32 = float(np.float32(c.OVER_TOL))


# SPATIAL_SNOW's depletion-curve state, carried unchanged without it
COVERAGE_STATE = ("snow_store_snow", "snow_store_swq", "snow_max_swq",
                  "snow_swq_slope", "snow_store_coverage")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ModelState))

# the lake fields of ModelState and the LakeState fields they carry
LAKE_STATE_FIELDS = (
    "lake_volume", "lake_temp", "lake_ice_we", "lake_ice_area",
    "lake_ice_height", "lake_swe", "lake_tempi", "lake_snow_surf_temp",
    "lake_snow_pack_temp", "lake_snow_surf_water", "lake_snow_pack_water",
    "lake_salbedo", "lake_last_snow", "lake_melting")
LAKE_STATE_NAMES = (
    "volume", "temp", "ice_water_eq", "ice_area", "ice_height", "swe",
    "tempi", "surf_temp", "pack_temp", "surf_water", "pack_water", "salbedo",
    "last_snow", "melting")


def _refuse(gp, geom, zwt_curves, lake_params):
    """NotImplementedError naming the first option outside the slice."""
    flags = [
        ("full_energy=False", not gp.full_energy),
        ("frozen_soil without geom", gp.frozen_soil and geom is None),
        ("quick_flux=False without geom", not gp.quick_flux and geom is None),
        ("geom with quick_flux without frozen_soil",
         gp.quick_flux and not gp.frozen_soil and geom is not None),
        (f"nnode={gp.nnode} on CUDA (the node sweep kernel runs "
         f"{kernels.SWEEP_MIN_NODES} to {kernels.SWEEP_MAX_NODES} nodes, "
         "the reference's MAX_NODES)",
         geom is not None and geom.alpha.is_cuda
         and gp.nnode > kernels.SWEEP_MAX_NODES),
        ("lakes without lake_params", gp.lakes and lake_params is None),
        ("lake_params without lakes", lake_params is not None
         and not gp.lakes),
    ]
    for name, on in flags:
        if on:
            raise NotImplementedError(
                f"vic_tpu_torch.model.make_step: {name} is not ported; the "
                "port runs FULL_ENERGY on QUICK_FLUX nodes or on "
                "finite-difference nodes (a NodeGeometry as geom, linear or "
                "EXP_TRANS spacing), with or without FROZEN_SOIL (geom "
                "required; with SPATIAL_FROST or not), BLOWING, "
                "CLOSE_ENERGY, DIST_PRCP, LAKES (lake_params), "
                "water-table curves, SPATIAL_SNOW, CORRPREC and "
                "CONTINUEONERROR")


def make_step(params: DeviceParams, gp, geom=None, zwt_curves=None,
              lake_params=None, outvars=None, votes=None):
    """Build step(state, forcing) -> (new_state, outputs).

    forcing: [n_cell] float32 tensors 'prec' (mm/step), 'air_temp' (C), 'wind'
    (m/s), 'shortwave', 'longwave' (W/m^2), 'pressure', 'vp' (Pa), 'density'
    (kg/m^3), optional 'tskc', and host ints 'month' (1-12), 'day_in_year'.
    geom: the NodeGeometry of finite-difference nodes on the parameters' device
    (physics.frozen_soil.build_node_geometry(...).to), required with
    quick_flux=False or frozen_soil. lake_params: the lakes' LakeParams on the
    parameters' device (prepare.lake_params_from_numpy), required with LAKES;
    a basin whose levels do not fall raises ValueError (check_basin).
    zwt_curves: the water-table curves on the parameters' device
    (physics.hydrology_misc.build_zwt_curves, then zwt_curves_to), for the
    OUT_ZWT* outputs. outvars: optional OUT_* names to return (plus
    OUT_WATER_ERROR, always kept, and OUT_CELL_VALID under
    CONTINUEONERROR). votes: where these cells are one share of a block
    split over devices, the share's parallel.votes.Member, which the step
    keeps: CLOSE_ENERGY's pass loop, the node sweep and the Brent around
    it then stop on tests over every share's cells, as on one device (the
    driver runs the shares in threads of their own); None otherwise.

    Each step call adds one to trace's `records` and is a vic.step span
    with a span for each physics phase it runs (trace); its CLOSE_ENERGY
    passes add to `close_energy_passes`."""
    _refuse(gp, geom, zwt_curves, lake_params)
    if lake_params is not None:
        check_basin(lake_params.z)
    dt_hours = gp.dt
    dt_sec = float(dt_hours) * 3600.0
    n_band = max(1, gp.snow_band)
    p = params
    frozen = gp.frozen_soil
    # QUICK_FLUX alone selects the ground-heat method; FROZEN_SOIL adds the
    # ice and fusion physics on either (vic_tpu/model.py:65-68)
    fd_nodes = not gp.quick_flux and geom is not None
    nl = gp.nlayer
    soil_ice = (layer_ice_params(p.max_moist, p.bubble, p.expt, p.fs_active)
                if frozen else None)
    frost_kw = frost_kwargs(gp)

    def step_phases(state: ModelState, forcing, ph):
        """The step's body; ph: its phase cursor (trace.phases)."""
        W = torch.where
        mi = int(forcing["month"]) - 1
        doy = int(forcing["day_in_year"])

        def B(a):
            return a[:, None]

        # ---- forcings on [c,h] with the band lapse ----
        ph("vic.step.forcing")
        tair = B(forcing["air_temp"]) + p.tfactor
        prec = B(forcing["prec"]) * p.pfactor
        wind = torch.clamp(B(forcing["wind"]), min=float(gp.min_wind_speed))
        sw_in = B(forcing["shortwave"])
        lw_in = B(forcing["longwave"])
        pressure = B(forcing["pressure"])
        vp_air = B(forcing["vp"])
        air_dens = B(forcing["density"])
        vpd = torch.clamp(svp(tair) - vp_air, min=0.0)

        # ---- monthly veg parameters ----
        lai = p.lai_m[..., mi]
        wdmax = p.wdmax_m[..., mi]
        veg_albedo = p.albedo_m[..., mi]
        veg_rough = p.roughness_m[..., mi]
        veg_displ = p.displacement_m[..., mi]
        bare = p.is_bare | p.is_glacier
        bare_albedo = W(p.is_glacier, B(p.glac_albedo),
                        W(bare, c.BARE_SOIL_ALBEDO, veg_albedo))
        surf_rough = W(bare, B(p.rough), veg_rough)
        surf_displ = W(bare, 0.0, veg_displ)
        ref_height = W(bare, B(p.rough) + 2.0, gs_wind_h(p, veg_displ))

        aero = calc_aerodynamic(
            p.overstory, p.veg_height, p.trunk_ratio, B(p.snow_rough),
            B(p.rough), p.wind_atten, surf_displ, surf_rough, ref_height,
            wind)

        # ---- rain/snow partition (solve_snow.c:149-156) ----
        rainonly = calc_rainonly(tair, prec, B(p.max_snow_temp),
                                 B(p.min_rain_temp), int(gp.temp_th_type))
        snow_part, rain_part = prec - rainonly, rainonly
        if gp.corrprec:
            # gauge undercatch (correct_precip.c, CORRPREC)
            gc_rain, gc_snow = correct_precip(
                wind, gs_wind_h(p, veg_displ), B(p.rough), B(p.snow_rough))
            snow_part, rain_part = gc_snow * snow_part, gc_rain * rain_part
        snowfall = snow_part * B(p.padj_s)
        rainfall = rain_part * B(p.padj_r)
        out_prec = snowfall + rainfall
        out_rain = rainfall
        out_snow = snowfall
        le = 2.501e6 - 2361.0 * tair

        snow_present = (state.swq > 0.0) | (snowfall > 0.0) \
            | (p.overstory & (state.snow_canopy > 0.0))

        # ---- DIST_PRCP storm tracking (dist_prec.c:76-152) ----
        if gp.dist_prcp:
            prec_c = B(forcing["prec"])
            raining = prec_c > 0.0
            # the wet fraction: 1 with any snow, from the intensity when it
            # rains, else unchanged (dist_prec.c:81-124)
            new_mu = W(snow_present, 1.0,
                       W(raining, 1.0 - torch.exp(-gp.prec_expt * prec_c),
                         state.mu))
            # DRY_TIME accumulates over the dry spells of a storm; rain does
            # not reset it (dist_prec.c:116-124)
            storm_end = ~snow_present & ~raining & (state.dry_time >= 24)
            still0 = W(storm_end, False, state.still_storm)
            dry_time = W(raining | snow_present, state.dry_time,
                         W(storm_end, 0, state.dry_time + dt_hours))
            new_storm = ~still0 & ((prec_c > c.STORM_THRES) | snow_present)
            redist = ~new_storm & still0 & (new_mu != state.mu)
            mu = W(new_storm | redist, new_mu, state.mu)
            still_storm = still0 | new_storm
            # wet/dry transfers at a storm's onset and mid-storm
            # (initialize_new_storm.c, redistribute_during_storm.c)
            mu_old = state.mu
            am, rm = new_storm[..., None], redist[..., None]
            moist_w, moist_d = storm_transfer(
                state.moist, state.moist_dry, B(p.max_moist),
                mu_old[..., None], mu[..., None], am, rm)
            ice_w, ice_d = storm_transfer(
                state.ice, state.ice_dry, B(p.max_moist), mu_old[..., None],
                mu[..., None], am, rm)
            wdew_w, wdew_d = storm_transfer(state.wdew, state.wdew_dry, wdmax,
                                            mu_old, mu, new_storm, redist)
            # the frozen part cannot exceed the transferred total
            ice_w = torch.minimum(ice_w, moist_w)
            ice_d = torch.minimum(ice_d, moist_d)

            def dw(wet, dry):
                return mu * wet + (1.0 - mu) * dry

            def dwl(wet, dry):
                return mu[..., None] * wet + (1.0 - mu[..., None]) * dry

            # precipitation falls on the wet fraction at intensity P/mu
            # (surface_fluxes.c:420)
            mu_safe = torch.clamp(mu, min=1e-6)
            rainfall = rainfall / mu_safe
            snowfall = snowfall / mu_safe
        else:
            mu, still_storm, dry_time = state.mu, state.still_storm, \
                state.dry_time
            moist_w, moist_d = state.moist, state.moist_dry
            ice_w, ice_d = state.ice, state.ice_dry
            wdew_w, wdew_d = state.wdew, state.wdew_dry

            def dw(wet, dry):
                return wet

            dwl = dw

        # no-overstory canopy dump when snow falls on stored dew
        dump = ~p.overstory & (snowfall > 0.0) & (wdew_w > 0.0)
        rainfall = rainfall + W(dump, wdew_w, 0.0)
        wdew0 = W(dump, 0.0, wdew_w)

        surf_att = surf_atten_of(lai, p)
        short_over_in = (1.0 - surf_att) * sw_in
        sw_under = W(p.overstory & snow_present, surf_att * sw_in, sw_in)
        surf_att_eff = W(snow_present & ~p.overstory, 1.0, surf_att)
        glacier = p.is_glacier
        tgrnd_eff = W(glacier, c.GLAC_TEMP, state.node_temp[..., 0])
        fresh = snowfall > 0.0
        last_snow = W(fresh, 0, state.last_snow + 1).to(torch.int32)
        snowing = snow_present
        ov_snow = p.overstory & snow_present

        # ---- soil thermal properties of the top two layers, of the
        # mu-averaged column (prepare_full_energy.c:52-56); the wet column
        # drives evaporation and runoff ----
        ph("vic.step.soil_thermal")
        moist0, ice0 = moist_w, ice_w
        moist_avg, ice_avg = dwl(moist_w, moist_d), dwl(ice_w, ice_d)
        l2 = slice(0, 2)
        kappa, cs = layer_thermal_props(
            moist_avg[..., l2], ice_avg[..., l2], B(p.depth)[..., l2],
            B(p.soil_dens_min)[..., l2], B(p.bulk_dens_min)[..., l2],
            B(p.quartz)[..., l2], B(p.soil_density)[..., l2],
            B(p.bulk_density)[..., l2], B(p.organic)[..., l2])
        # D1/D2 are node spacings (calc_surf_energy_bal.c:242-243): on the
        # QUICK_FLUX geometry depth[0] and dp - depth[0]; from the node
        # geometry wherever there is one (vic_tpu/model.py:274-277)
        if geom is not None:
            d1 = (geom.zsum[:, 1] - geom.zsum[:, 0])[:, None]
            d2 = (geom.zsum[:, 2] - geom.zsum[:, 1])[:, None]
        else:
            d1 = B(p.depth)[..., 0]
            d2 = B(p.dp) - d1
        frozen_kw = {}
        if frozen:
            # fusion inputs: top-layer ice recomputed from the carried node
            # temperatures (prepare_full_energy.c:64-76)
            depth0_mm = B(p.depth)[..., 0] * 1000.0
            moist0_vol = moist_avg[..., 0] / depth0_mm
            max_moist0_vol = B(p.max_moist)[..., 0] / depth0_mm
            bubble0, expt0 = B(p.bubble)[..., 0], B(p.expt)[..., 0]
            tavg01 = 0.5 * (state.node_temp[..., 0] + state.node_temp[..., 1])
            ice0_vol = W(B(p.fs_active) & (tavg01 < 0.0), torch.clamp(
                moist0_vol - maximum_unfrozen_water(
                    tavg01, max_moist0_vol, bubble0, expt0), min=0.0), 0.0)
            frozen_kw = dict(
                frozen_soil=True, moist0_vol=moist0_vol,
                max_moist0_vol=max_moist0_vol, ice0_vol=ice0_vol,
                bubble0=bubble0, expt0=expt0, fs_active=B(p.fs_active))
        fd_solve = None
        if fd_nodes:
            # node moisture and thermal properties at the carried
            # temperatures, fixed over the step; the profile is re-solved
            # with each candidate Ts as the node-0 boundary condition inside
            # every residual evaluation (func_surf_energy_bal.c:190-228)
            nodep = distribute_node_moisture(moist_avg, state.node_temp,
                                             geom, p, frozen=frozen)
            fd_solve = NodeSolve(
                state.node_temp, nodep["kappa"], nodep["cs"],
                nodep["moist"], nodep["ice"], geom, p.fs_active, nlayer=nl,
                dt_sec=dt_sec, noflux=gp.noflux, frozen=frozen,
                max_sweeps=gp.soil_sweep_maxiter, exp_trans=gp.exp_trans,
                votes=votes)

        eb_common = dict(
            ts_old=state.node_temp[..., 0], t1_old=state.node_temp[..., 1],
            t2=state.node_temp[..., -1], d1=d1, d2=d2,
            kappa1=kappa[..., 0], kappa2=kappa[..., 1],
            cs1=cs[..., 0], cs2=cs[..., 1], dp=B(p.dp), delta_t=dt_sec,
            vpd=vpd, vp_air=vp_air, atmos_density=air_dens,
            atmos_pressure=pressure, elevation=B(p.elevation),
            latent_heat_le=le, ra_under=aero.resist.snow_free,
            z_ref=aero.ref_height.snow_free,
            displacement=aero.displacement.snow_free,
            roughness=aero.roughness.snow_free, wind=aero.wind.snow_free,
            is_veg=~bare & (lai > 0.0), lai=lai, wdmax=wdmax, rmin=p.rmin,
            rgl=p.rgl, rarc=p.rarc, root=p.root, ra_canopy=aero.resist.canopy,
            moist_l=moist0, ice_l=ice0, wcr=B(p.wcr), wpwp=B(p.wpwp),
            depth_l=B(p.depth), resid_moist0=B(p.resid_moist)[..., 0],
            b_infilt=B(p.b_infilt), max_moist_l=B(p.max_moist),
            surf_atten=surf_att_eff, grnd_flux_type=int(gp.grnd_flux_type),
            fd_solve=fd_solve, **frozen_kw)

        # ---- blowing-snow sublimation flux (BLOWING; CalcBlowingSnow.c),
        # from the carried state only: outside the canopy-air chain ----
        ph("vic.step.blowing" if gp.blowing else None)
        if gp.blowing:
            blow_flux, _ = calc_blowing_snow(
                dt_sec=dt_sec, tair=tair,
                last_snow=state.last_snow.to(tair.dtype),
                surf_water_m=state.surf_water, wind_2m=aero.wind.snow_covered,
                ls=(677.0 - 0.07 * state.surf_temp) * c.JOULES_PER_CAL
                * c.GRAMS_PER_KG,
                air_dens=air_dens, pressure=pressure, eact=vp_air,
                z0_snow=B(p.snow_rough), zrh=2.0, snowdepth=state.depth,
                lag_one=p.lag_one, sigma_slope=p.sigma_slope,
                tsnow=state.surf_temp, is_bare=p.is_bare, fetch=p.fetch,
                displacement=torch.clamp(veg_displ, min=0.01),
                roughness=torch.clamp(veg_rough, min=0.001))
        else:
            blow_flux = tair.new_zeros(())
        rainfall_base, wdew0_base = rainfall, wdew0

        def column_phases(tca, luo, fd_cheap, cp):
            """One pass of the overstory -> understory chain at canopy-air
            temperature tca (Tair on lanes that do not iterate), with luo
            the understory's upward longwave that the canopy sees
            (vic_tpu/model.py:361-785). fd_cheap: on finite-difference nodes,
            solve the surface balance on the affine two-probe profile, as
            the CLOSE_ENERGY passes before the last one do. cp: its phase
            cursor."""
            # ---- overstory canopy snow interception (snow_intercept.c) ----
            cp("vic.step.canopy_snow")
            ci = snow_intercept(
                snowfall_mm=snowfall, rainfall_mm=rainfall_base,
                int_snow_m=state.snow_canopy, int_rain_m=wdew0_base / 1000.0,
                tfoliage_old=state.tfoliage, temp_int_storage=0.0 * wdew0_base,
                lai=lai, wdmax_mm=wdmax, air_dens=air_dens, vp_air=vp_air,
                vpd=vpd, pressure=pressure, le=le, tcanopy=tca,
                net_short_over=(1.0 - B(p.new_snow_alb)) * short_over_in,
                net_short_over_nosnow=(1.0 - veg_albedo) * short_over_in,
                long_over_in=lw_in, long_under_out=luo,
                ra_overstory=aero.resist.canopy, wind_over=aero.wind.canopy,
                liquid_evap=dict(wdew_mm=wdew0_base, prec_mm=rainfall_base,
                                 rarc=p.rarc,
                                 elevation=B(p.elevation)),
                dt_sec=dt_sec, max_iter=gp.brent_maxiter,
                active_mask=ov_snow & p.mask)
            rainfall = W(ov_snow, ci.rain_throughfall * 1000.0, rainfall_base)
            snowfall_ground = W(ov_snow, ci.snow_throughfall * 1000.0,
                                snowfall)
            snow_canopy_new = W(ov_snow, ci.int_snow, state.snow_canopy)
            wdew0 = W(ov_snow, ci.int_rain * 1000.0, wdew0_base)
            tfoliage_new = W(ov_snow, ci.tfoliage, tca)
            canopy_sub_mm = W(ov_snow, ci.vapor_flux * 1000.0, 0.0)
            cevap_liq_mm = W(ov_snow, ci.canopy_evap_mm, 0.0)
            tfol_fb = W(ov_snow, ci.fbflag, False)
            # snow-covered overstory lanes see the canopy's emission
            lw_under = W(ov_snow, lw_in - ci.net_long_over, lw_in)

            # ---- snow albedo aging (solve_snow.c:418-439) ----
            cp("vic.step.snow")
            albedo_aged = snow_albedo(
                snowfall_ground, state.swq, state.depth, state.albedo,
                state.cold_content, dt_hours, last_snow.to(tair.dtype),
                state.melting, B(p.new_snow_alb), B(p.snow_alb_accum_a),
                B(p.snow_alb_accum_b), B(p.snow_alb_thaw_a),
                B(p.snow_alb_thaw_b), sun1999=(int(gp.snow_albedo) == 1))
            snow_alb = W(fresh, B(p.new_snow_alb), albedo_aged)
            albedo_under = W(fresh, snow_alb,
                             state.coverage * snow_alb
                             + (1.0 - state.coverage) * bare_albedo)
            net_short_snow = (1.0 - albedo_under) * sw_under

            # ---- snowpack accumulation/ablation (snow_melt.c) ----
            sm = snow_melt(
                swq=state.swq, surf_temp=state.surf_temp,
                pack_temp=state.pack_temp, surf_water=state.surf_water,
                pack_water=state.pack_water, snow_depth=state.depth,
                snow_density=state.density, coldcontent=state.cold_content,
                rainfall_mm=rainfall, snowfall_mm=snowfall_ground,
                air_temp=tair, tcanopy=tca, tgrnd=tgrnd_eff,
                wind=aero.wind.snow_covered, vp_air=vp_air, vpd=vpd,
                air_dens=air_dens, pressure=pressure, longwave_in=lw_under,
                net_short=net_short_snow, lv=le, ra=aero.resist.snow_covered,
                z_ref=aero.ref_height.snow_covered,
                roughness=aero.roughness.snow_covered, dt_sec=dt_sec,
                max_iter=gp.brent_maxiter, active_mask=snow_present & p.mask,
                is_glacier=glacier, blowing_flux=blow_flux,
                # SPATIAL_SNOW: the pack sees last step's coverage
                # (solve_snow.c calls calc_snow_coverage after snow_melt)
                snow_cover_fract=state.coverage if gp.spatial_snow else None)

            def S(new, old):
                return W(snow_present, new, old)

            swq = S(sm.swq, state.swq)
            surf_temp = S(sm.surf_temp, 0.0 * state.surf_temp)
            pack_temp = S(sm.pack_temp, 0.0 * state.pack_temp)
            surf_water = S(sm.surf_water, 0.0 * state.surf_water)
            pack_water = S(sm.pack_water, 0.0 * state.pack_water)
            melt_out = W(snow_present, sm.melt, 0.0)
            # complete-melt reset keeps the stale cold content (solve_snow.c)
            cold_content = S(sm.cold_content, state.cold_content)
            vapor_flux = W(snow_present, sm.vapor_flux, 0.0)
            glac_firn_mm = W(glacier & snow_present, sm.firn_to_ice,
                             0.0) * 1000.0
            # thin-pack INCLUDE_SNOW lanes fold into the soil surface EB
            inc = sm.include_snow & snow_present & ~glacier & p.mask

            # ---- glacier lane: bare-ice ablation once snow is gone ----
            cp("vic.step.glacier")
            on_ice = glacier & ~snow_present
            glac = glacier_ablation(
                tair=tair, net_short=(1.0 - B(p.glac_albedo)) * sw_in,
                longwave_in=lw_in, wind=aero.wind.glacier, vp_air=vp_air,
                vpd=vpd, air_dens=air_dens, pressure=pressure, le=le,
                rain_mm=W(on_ice, rainfall, 0.0), ra=aero.resist.glacier,
                z_ref=aero.ref_height.glacier,
                roughness=aero.roughness.glacier,
                old_tsurf=state.glac_surf_temp,
                glac_surf_thick=B(p.glac_surf_thick), dt_sec=dt_sec,
                max_iter=gp.brent_maxiter, active_mask=on_ice & p.mask)
            glac_melt_mm = W(on_ice, glac.melt_mm, 0.0)
            glac_surf_temp = W(on_ice, glac.surf_temp,
                               W(glacier, 0.0, state.glac_surf_temp))

            # glacier water reservoir (surface_fluxes_glac.c:580-608)
            glac_inflow = W(glacier,
                            melt_out + glac_melt_mm + W(on_ice, rainfall, 0.0),
                            0.0)
            storage = state.glac_water_storage + glac_inflow
            kfac = B(p.glac_kmin) + B(p.glac_dk) * torch.exp(
                -B(p.glac_a) * swq * 1000.0)
            glac_outflow = W(glacier, kfac * storage, 0.0)
            glac_water_storage = W(glacier, storage - glac_outflow,
                                   state.glac_water_storage)

            # ---- snowpack density/depth (solve_snow.c:478-496) ----
            cp("vic.step.snow")
            snthrm = int(gp.snow_density) == 1
            density_new = snow_density_update(
                state.swq, state.depth, state.density, surf_temp,
                snowfall_ground, tair, dt_hours,
                liquid_water=surf_water + pack_water, snthrm=snthrm)
            density = W(swq > 0.0,
                        W(state.swq > 0.0, density_new,
                          new_snow_density(tair, snthrm=snthrm)), 0.0)
            depth = W(density > 0.0,
                      1000.0 * swq / torch.clamp(density, min=1.0), 0.0)
            if gp.spatial_snow:
                # partial coverage with the depletion curve's memory
                # (calc_snow_coverage.c:7-150), from the new pack and the
                # old distribution state (solve_snow.c:384)
                cr = calc_snow_coverage(
                    store_snow=state.snow_store_snow,
                    dfsc=torch.clamp(B(p.depth_full_snow_cover), min=1e-4),
                    old_coverage=state.coverage, swq=swq, old_swq=state.swq,
                    depth=depth, old_depth=state.depth,
                    melt_m=melt_out / 1000.0 + vapor_flux,
                    max_swq=state.snow_max_swq, snowfall_mm=snowfall_ground,
                    store_swq=state.snow_store_swq,
                    swq_slope=state.snow_swq_slope,
                    store_coverage=state.snow_store_coverage)
                coverage = W(swq > 0.0, cr.coverage, 0.0)
                # the complete-melt (solve_snow.c:462-476) and no-snow
                # (:500-501, 533-534) resets
                full_melt = snow_present & (swq <= 0.0)
                cov_state = dict(
                    snow_store_snow=W(full_melt, True, cr.store_snow),
                    snow_store_swq=W(~snow_present, 0.0, cr.store_swq),
                    snow_max_swq=cr.max_swq,
                    snow_swq_slope=W(full_melt, 0.0, cr.swq_slope),
                    snow_store_coverage=W(~snow_present, 1.0,
                                          cr.store_coverage))
            else:
                coverage = W(swq > 0.0, 1.0, 0.0)
                cov_state = {k: getattr(state, k) for k in COVERAGE_STATE}

            # MELTING flag (solve_snow.c:500-510, lat-aware season window)
            north = B(p.lat) >= 0
            in_season = W(north, 60 < doy < 273, doy < 60 or doy > 273)
            melting = W(swq > 0.0,
                        W((cold_content >= 0.0) & in_season, True,
                          W(state.melting & (snowfall_ground > c.TRACESNOW),
                            False, state.melting)),
                        False)

            # ---- coverage-change bookkeeping (solve_snow.c:406-448) ----
            old_cov = state.coverage
            delta_cov = W(snow_present,
                          torch.clamp(old_cov - coverage, min=0.0), 0.0)
            same_step = snow_present & (old_cov == 0.0) & (coverage == 0.0)
            delta_cov = W(same_step, 1.0, delta_cov)
            cov_w = coverage + delta_cov
            t = sm.terms
            pack_sum = (t.advection - t.delta_cc + t.latent + t.latent_sub
                        + t.sensible + t.refreeze_energy)
            if gp.spatial_snow:
                pack_sum = pack_sum + t.advected_sensible
            melt_energy = W(snow_present & (delta_cov > 0.0),
                            delta_cov * pack_sum, 0.0)

            # pack -> soil conduction (calc_surf_energy_bal.c:254)
            mean_depth = 0.5 * (state.depth + depth)
            kappa_snow = W(depth > 0.0,
                           c.K_SNOW * density * density
                           / torch.clamp(mean_depth, min=1e-10), 0.0)

            # ---- surface energy balance on snow-free ground ----
            cp("vic.step.surface")
            net_short_bare = sw_under * (
                (1.0 - (coverage + delta_cov)) * (1.0 - bare_albedo)
                + delta_cov * (1.0 - snow_alb))
            long_bare_in = (1.0 - coverage) * lw_under
            pre_args = dict(
                wcr=B(p.wcr), wpwp=B(p.wpwp), root=p.root,
                max_moist0=B(p.max_moist)[..., 0], b_infilt=B(p.b_infilt),
                rmin=p.rmin, rgl=p.rgl, lai=lai, net_short=net_short_bare,
                vpd=vpd, air_temp=tair, elevation=B(p.elevation))
            evap_pre = build_evap_pre(moist0, ice0, **pre_args)
            eb_kwargs = dict(
                eb_common, tair=tca, shortwave_net_bare=net_short_bare,
                long_bare_in=long_bare_in,
                overstory_snowing=p.overstory & snowing, wdew=wdew0,
                rainfall=rainfall, snow_coverage=coverage,
                kappa_snow=kappa_snow, tsnow_surf=surf_temp,
                melt_energy=melt_energy, evap_pre=evap_pre,
                inc_mask=inc,
                inc_terms=dict(swq=swq, surf_water=surf_water, density=density,
                               old_tsurf=state.surf_temp,
                               advection0=sm.inc_advection0,
                               lw_snow_in=coverage * lw_under,
                               net_short_snow_cov=coverage * net_short_snow,
                               cov=coverage, blowing_flux=blow_flux))
            if gp.dist_prcp:
                # the dry column's ET in the residual: no rain reaches it
                eb_kwargs.update(
                    dist_dry=dict(moist_l=moist_d, ice_l=ice_d, wdew=wdew_d,
                                  rainfall=torch.zeros_like(rainfall)),
                    evap_pre_dry=build_evap_pre(moist_d, ice_d, **pre_args),
                    mu_wet=mu)
            ts, fb, fd_interp, eb = solve_surface_temperature(
                eb_kwargs, state.node_temp[..., 0], tca,
                max_iter=gp.brent_maxiter, active=p.mask,
                fd_affine=fd_cheap and gp.fd_affine_residual)
            if eb is None:
                # finite differences: the accepted root's terms on the
                # profile the Brent used (the QUICK_FLUX solve returns them)
                eb = surf_energy_terms(ts, **(
                    eb_kwargs if fd_interp is None
                    else dict(eb_kwargs, fd_solve=None, fd_interp=fd_interp)))

            # thin-pack update from the joint solution
            # (calc_surf_energy_bal.c:589-660)
            vap = W(-eb.inc_vapor_flux > swq, -swq, eb.inc_vapor_flux)
            swq_i = swq + vap
            sw_i = torch.clamp(surf_water + vap, min=0.0)
            re = eb.refreeze_energy
            refroz = torch.minimum(
                torch.clamp(re * dt_sec / (c.LF * c.RHO_W), min=0.0), sw_i)
            re_pos = re >= 0.0
            sw_i = W(re_pos, sw_i - refroz, sw_i)
            melt_i = W(re_pos, 0.0, torch.abs(re) * dt_sec / (c.LF * c.RHO_W))
            swq_i = swq_i - melt_i
            melt_i = W(swq_i < 0.0, melt_i + swq_i, melt_i)
            swq_i = torch.clamp(swq_i, min=0.0)
            alive = swq_i > 0.0
            st_i = torch.clamp(ts, max=0.0)

            def I(new, old):
                return W(inc, new, old)

            swq = I(swq_i, swq)
            surf_water = I(W(alive, sw_i, 0.0), surf_water)
            surf_temp = I(W(alive, st_i, 0.0), surf_temp)
            cold_content = I(W(alive, c.CH_ICE * st_i * swq_i, 0.0),
                             cold_content)
            depth = I(W(alive, 1000.0 * swq_i / torch.clamp(density, min=1.0),
                        0.0), depth)
            coverage = I(W(alive, 1.0, 0.0), coverage)
            dead = inc & ~alive
            pack_temp = W(dead, 0.0, pack_temp)
            pack_water = W(dead, 0.0, pack_water)
            density = W(dead, 0.0, density)
            melt_out = melt_out + W(inc, melt_i * 1000.0, 0.0)
            vapor_flux = I(-vap, vapor_flux)
            melt_energy = W(inc, 0.0, melt_energy)
            tk_s = surf_temp + c.KELVIN
            tk_g = ts + c.KELVIN
            tk_s2, tk_g2 = tk_s * tk_s, tk_g * tk_g
            luo_out = (coverage * c.STEFAN_B * (tk_s2 * tk_s2)
                       + (1.0 - coverage) * c.STEFAN_B * (tk_g2 * tk_g2))

            return dict(
                ci=ci, snow_canopy_new=snow_canopy_new, wdew0=wdew0,
                tfoliage_new=tfoliage_new, canopy_sub_mm=canopy_sub_mm,
                cevap_liq_mm=cevap_liq_mm, tfol_fb=tfol_fb, snow_alb=snow_alb,
                albedo_under=albedo_under, net_short_snow=net_short_snow,
                sm=sm, swq=swq, surf_temp=surf_temp, pack_temp=pack_temp,
                surf_water=surf_water, pack_water=pack_water,
                melt_out=melt_out, cold_content=cold_content,
                vapor_flux=vapor_flux, glac_firn_mm=glac_firn_mm, inc=inc,
                glac=glac, on_ice=on_ice, glac_melt_mm=glac_melt_mm,
                glac_surf_temp=glac_surf_temp, glac_inflow=glac_inflow,
                kfac=kfac, glac_outflow=glac_outflow,
                glac_water_storage=glac_water_storage, density=density,
                depth=depth, coverage=coverage, melting=melting, cov_w=cov_w,
                melt_energy=melt_energy, net_short_bare=net_short_bare, ts=ts,
                fb=fb, eb=eb, luo_out=luo_out, cov_state=cov_state)

        def column(tca, luo, fd_cheap=False):
            """column_phases inside a vic.step.column span."""
            with trace.span("vic.step.column"), trace.phases() as cp:
                return column_phases(tca, luo, fd_cheap, cp)

        # ---- CLOSE_ENERGY: the canopy-air temperature's fixed point over
        # column() passes (surface_fluxes.c:455-656 + calc_atmos_energy_bal);
        # only snow-covered overstory lanes iterate, the others keep
        # Tcanopy = Tair (vic_tpu/model.py:796-851) ----
        iter_mask = ov_snow & p.mask
        ph("vic.step.close_energy" if gp.close_energy else None)
        if gp.close_energy:
            # per-lane safeguarded secant on F(tc) - tc, every lane until the
            # batch's largest change is within OVER_TOL (a NaN keeps it
            # going), one host read per pass; the batch is every share's
            # cells where the block is split
            tc_prev, g_prev, tc = tair, torch.zeros_like(tair), tair
            luo = state.long_under_out
            close_iters = 0
            while close_iters < c.CLOSE_ENERGY_MAXITER:
                with trace.span("vic.step.close_energy.pass"):
                    ri = column(tc, luo, fd_cheap=True)
                    tc_next, g_prev, live_max = canopy_air_step(
                        it=close_iters, canopy_sensible=ri["ci"].sensible,
                        soil_sensible=ri["eb"].sensible_heat,
                        pack_sensible=ri["sm"].terms.sensible,
                        cov_w=ri["cov_w"], tair=tair, air_dens=air_dens,
                        ra_over=aero.resist.canopy, tc=tc, tc_prev=tc_prev,
                        g_prev=g_prev, iter_mask=iter_mask, lane_mask=p.mask)
                    tc_prev, tc, luo = tc, tc_next, ri["luo_out"]
                    close_iters += 1
                    change = largest_change(live_max)
                    if votes is not None:
                        change = votes.max_nan(change)
                if change <= OVER_TOL_F32:
                    break
            trace.count("close_energy_passes", close_iters)
            r = column(tc, luo)
            # the final update at the settled temperature
            tcanopy, tcanopy_fb, atmos_sensible = canopy_air_final(
                canopy_sensible=r["ci"].sensible,
                soil_sensible=r["eb"].sensible_heat,
                pack_sensible=r["sm"].terms.sensible, cov_w=r["cov_w"],
                tair=tair, air_dens=air_dens, ra_over=aero.resist.canopy,
                iter_mask=iter_mask)
        else:
            close_iters = 0
            tcanopy = tair
            tcanopy_fb = torch.zeros_like(iter_mask)
            r = column(tair, state.long_under_out)
        ph(None)
        ci = r["ci"]
        snow_canopy_new = r["snow_canopy_new"]
        wdew0 = r["wdew0"]
        tfoliage_new = r["tfoliage_new"]
        canopy_sub_mm = r["canopy_sub_mm"]
        cevap_liq_mm = r["cevap_liq_mm"]
        tfol_fb = r["tfol_fb"]
        snow_alb = r["snow_alb"]
        albedo_under = r["albedo_under"]
        net_short_snow = r["net_short_snow"]
        sm = r["sm"]
        swq = r["swq"]
        surf_temp = r["surf_temp"]
        pack_temp = r["pack_temp"]
        surf_water = r["surf_water"]
        pack_water = r["pack_water"]
        melt_out = r["melt_out"]
        cold_content = r["cold_content"]
        vapor_flux = r["vapor_flux"]
        glac_firn_mm = r["glac_firn_mm"]
        inc = r["inc"]
        glac = r["glac"]
        on_ice = r["on_ice"]
        glac_melt_mm = r["glac_melt_mm"]
        glac_surf_temp = r["glac_surf_temp"]
        glac_inflow = r["glac_inflow"]
        kfac = r["kfac"]
        glac_outflow = r["glac_outflow"]
        glac_water_storage = r["glac_water_storage"]
        density = r["density"]
        depth = r["depth"]
        coverage = r["coverage"]
        melting = r["melting"]
        cov_w = r["cov_w"]
        melt_energy = r["melt_energy"]
        net_short_bare = r["net_short_bare"]
        ts = r["ts"]
        fb = r["fb"]
        eb = r["eb"]
        luo_out = r["luo_out"]
        t = sm.terms

        # pack terms of INCLUDE_SNOW lanes come from the joint soil balance
        adv_pack = W(inc, sm.inc_advection0, t.advection)
        dcc_pack = W(inc, eb.delta_cc, t.delta_cc)
        rfz_pack = W(inc, eb.refreeze_energy, t.refreeze_energy)
        # glacier lanes report the glacier slab or pack EB alone
        sens_under = W(glacier, W(on_ice, glac.terms.sensible, t.sensible),
                       eb.sensible_heat + t.sensible * cov_w)
        lat_under = W(glacier, W(on_ice, glac.terms.latent, t.latent),
                      eb.latent_heat + t.latent * cov_w)
        latsub_under = W(glacier,
                         W(on_ice, glac.terms.latent_sub, t.latent_sub),
                         eb.latent_heat_sub + t.latent_sub * cov_w)
        ns_under = net_short_bare + net_short_snow * coverage
        nl_under = eb.net_long_bare + t.net_long * coverage
        if gp.close_energy:
            # iterated lanes report at the atmosphere's level: canopy plus
            # understory, the net longwave the canopy's alone (put_data.c:
            # 1068-1092, calc_atmos_energy_bal.c:77-90)
            sens_rep = W(iter_mask, atmos_sensible, sens_under)
            lat_rep = W(iter_mask, ci.latent + lat_under, lat_under)
            latsub_rep = W(iter_mask, ci.latent_sub + latsub_under,
                           latsub_under)
            ns_rep = W(iter_mask, ci.net_short_over + ns_under, ns_under)
            nl_rep = W(iter_mask, ci.net_long_over, nl_under)
        else:
            sens_rep, lat_rep, latsub_rep = sens_under, lat_under, \
                latsub_under
            ns_rep, nl_rep = ns_under, nl_under

        # no soil/canopy ET on snow-covered, snowing or glacier lanes
        no_soil_evap = snowing | glacier
        evap_sfree = W(no_soil_evap, 0.0, eb.evap)
        layer_evap = W(no_soil_evap[..., None], 0.0, eb.layer_evap)
        wdew_new = W(no_soil_evap, wdew0, eb.wdew_new)
        throughfall = W(snowing, 0.0, eb.throughfall)
        ppt = W(glacier, 0.0, W(snowing, melt_out, throughfall))

        # ---- runoff & baseflow ----
        ph("vic.step.runoff")

        def runoff_of(moist, ice, lay_evap, ppt_col):
            return runoff_step(
                moist, ice, lay_evap, ppt_col, B(p.max_moist),
                B(p.resid_moist), B(p.depth), B(p.ksat), B(p.expt),
                B(p.b_infilt), B(p.ds), B(p.dsmax), B(p.ws), B(p.c_expt),
                dt_hours)

        ro = runoff_of(moist0, ice0, layer_evap, ppt)
        if gp.dist_prcp:
            # the dry column: no precipitation, its own ET and drainage
            # (runoff.c:222-241 with mu -> 1-mu)
            layer_evap_d = W(no_soil_evap[..., None], 0.0, eb.layer_evap_dry)
            wdew_new_d = W(no_soil_evap, wdew_d, eb.wdew_new_dry)
            ppt_d = W(snowing | glacier, 0.0, eb.throughfall_dry)
            ro_d = runoff_of(moist_d, ice_d, layer_evap_d, ppt_d)
        else:
            layer_evap_d, wdew_new_d, ppt_d, ro_d = layer_evap, wdew_new, \
                ppt, ro

        ph("vic.step.soil_nodes")
        if fd_nodes:
            # the profile solved at the accepted Ts in the final evaluation
            # (calc_surf_energy_bal.c:489-506, frozen_soil.c:67)
            node_temp = eb.t_nodes
        else:
            # QUICK_FLUX nodes: [Ts, T1, T2...]
            node_temp = torch.cat([ts[..., None], eb.t1[..., None],
                                   state.node_temp[..., 2:]], dim=-1)
        if frozen:
            _, ice_new = estimate_layer_ice(node_temp, ro.moist, geom,
                                            soil_ice, **frost_kw)
            ice_new_d = (estimate_layer_ice(node_temp, ro_d.moist, geom,
                                            soil_ice, **frost_kw)[1]
                         if gp.dist_prcp else ice_new)
        else:
            ice_new = ice0
            ice_new_d = ice_d if gp.dist_prcp else ice_new

        ph(None)
        snow_sub_mm = vapor_flux * 1000.0
        total_evap = evap_sfree + snow_sub_mm + canopy_sub_mm + cevap_liq_mm

        w = p.weight

        def agg(x):
            return (x * w).sum(-1)

        def aggl(x):
            return (x * w[..., None]).sum(-2)

        runoff_c = dw(ro.runoff, ro_d.runoff)
        baseflow_c = dw(ro.baseflow, ro_d.baseflow)
        cell_runoff = agg(runoff_c + glac_outflow)
        cell_baseflow = agg(baseflow_c)

        # ---- lake/wetland coupling (full_energy.c:714-800, lakes.eb.c;
        # vic_tpu/model.py:993-1310), before the state so the wetland
        # recharge enters the soil and the closure ----
        ph("vic.step.lake" if lake_params is not None else None)
        moist_wet_f, moist_dry_f = ro.moist, ro_d.moist
        recharge_lane_mm = torch.zeros_like(ro.runoff)
        lake_evap_mm = torch.zeros_like(cell_runoff)
        prec_cell = rain_cell = snow_cell = None
        lake_out = {}
        lake_state = {k: getattr(state, k) for k in LAKE_STATE_FIELDS}
        if lake_params is not None:
            lp = lake_params
            cell_area = p.cell_area
            rperc = lp.rpercent
            # wetland host lane: the first valid non-glacier band-0 lane
            # (argmax over 0/1 returns the first maximal index, as
            # jnp.argmax does over the bool mask)
            cand = p.mask & (p.band == 0) & ~p.is_glacier
            wl_idx = cand.to(torch.uint8).argmax(dim=1)
            wl_mask = ((torch.arange(p.max_hru, device=cand.device)[None, :]
                        == wl_idx[:, None]) & cand.any(1)[:, None])

            def take_wl(x):
                idx = wl_idx.reshape((-1,) + (1,) * (x.dim() - 1))
                return torch.take_along_dim(x, idx, 1)[:, 0]

            # pre-step dynamic lake fraction (full_energy.c:239)
            basin0 = lp.basin[..., 0]
            has_l = lp.has_lake
            liq_pre = torch.clamp(state.lake_volume - state.lake_ice_we,
                                  min=0.0)
            sarea_pre = torch.maximum(
                area_from_depth(lp, depth_from_volume(lp, liq_pre)),
                state.lake_ice_area)
            clake_pre = W(has_l, torch.clamp(
                sarea_pre / torch.clamp(basin0, min=1.0), 0.0, 1.0), 0.0)
            # the wetland lane routes all of its runoff into the lake at its
            # land share (1-lakefrac), the other lanes rpercent of theirs
            wl_w = (w * wl_mask).sum(-1)
            wet_ro = ((runoff_c + glac_outflow) * w * wl_mask).sum(-1)
            wet_bf = (baseflow_c * w * wl_mask).sum(-1)
            oth_ro = cell_runoff - wet_ro
            oth_bf = cell_baseflow - wet_bf
            r_in = (oth_ro * rperc
                    + wet_ro * (1.0 - clake_pre)) / 1000.0 * cell_area
            b_in = (oth_bf * rperc
                    + wet_bf * (1.0 - clake_pre)) / 1000.0 * cell_area
            # cell-level rain/snow partition for the lake column
            tair_c = forcing["air_temp"]
            rainonly_c = calc_rainonly(tair_c, forcing["prec"],
                                       p.max_snow_temp, p.min_rain_temp,
                                       int(gp.temp_th_type))
            vpd_c = torch.clamp(svp(tair_c) - forcing["vp"], min=0.0)
            lstate = LakeState(**{n: getattr(state, f) for f, n in zip(
                LAKE_STATE_FIELDS, LAKE_STATE_NAMES)})
            # bottom-layer relative moisture of each lane for the lake-bed
            # ARNO curve (lakes.eb.c:2104-2115)
            mm_bot = p.max_moist[..., -1]
            resid_bot = p.resid_moist[..., -1] * p.depth[..., -1] * 1000.0
            wl_rel_moist = (mm_bot[:, None] - ice_new[..., -1]
                            - resid_bot[:, None]) / torch.clamp(
                mm_bot - resid_bot, min=1.0)[:, None]
            lres = lake_step(
                lp, lstate, tair=tair_c, wind=forcing["wind"],
                sw_in=forcing["shortwave"], lw_in=forcing["longwave"],
                vp_air=forcing["vp"], vpd=vpd_c,
                pressure=forcing["pressure"],
                air_density=forcing["density"], rainfall_mm=rainonly_c,
                snowfall_mm=forcing["prec"] - rainonly_c, runoff_in_m3=r_in,
                baseflow_in_m3=b_in, lat=p.lat, day_in_year=doy,
                wind_h=take_wl(p.wind_h), snow_rough=p.snow_rough,
                new_snow_alb=p.new_snow_alb,
                alb_accum_a=p.snow_alb_accum_a,
                alb_accum_b=p.snow_alb_accum_b,
                alb_thaw_a=p.snow_alb_thaw_a, alb_thaw_b=p.snow_alb_thaw_b,
                ds=p.ds, dsmax=p.dsmax, ws_arno=p.ws, c_expt=p.c_expt,
                dt_sec=dt_sec, blowing=gp.blowing,
                wetland_moist=dwl(moist_wet_f, moist_dry_f),
                wetland_max_moist=p.max_moist, wetland_rel_moist=wl_rel_moist,
                lane_mask=p.mask)
            clake_post = W(has_l, torch.clamp(
                lres.sarea / torch.clamp(basin0, min=1.0), 0.0, 1.0), 0.0)

            # ---- per-lane storage advection for the changing lake area
            # (lakes.eb.c:2307-2334,2374-2533): the flooding recharge
            # saturates each lane's fringe, excess spilling down then up;
            # each column is blended with the saturated strip the lake
            # exposed or flooded ----
            mm_max = p.max_moist[:, None, :]
            m0_lane = dwl(moist_wet_f, moist_dry_f)
            cols = list((m0_lane + lres.wetland_dmoist_mm).unbind(-1))
            nlay = len(cols)
            for lay in range(nlay - 1):
                exc = torch.clamp(cols[lay] - mm_max[..., lay], min=0.0)
                cols[lay] = cols[lay] - exc
                cols[lay + 1] = cols[lay + 1] + exc
            for lay in range(nlay - 1, 0, -1):
                exc = torch.clamp(cols[lay] - mm_max[..., lay], min=0.0)
                cols[lay] = cols[lay] - exc
                cols[lay - 1] = cols[lay - 1] + exc
            cols[0] = torch.minimum(cols[0], mm_max[..., 0])
            m1 = torch.stack(cols, -1)
            lf = clake_pre[:, None]
            nf_l = W(has_l[:, None], lres.lane_nf, 0.0)
            maxnf_l = W(has_l[:, None], lres.lane_maxnf, 0.0)
            one_m_nf = torch.clamp(1.0 - nf_l, min=1e-6)
            m_adv = torch.minimum(torch.clamp(
                (m1 * (1.0 - lf)[..., None]
                 + mm_max * (lf - nf_l)[..., None]) / one_m_nf[..., None],
                min=0.0), mm_max)
            live_l = has_l[:, None] & (lf < 1.0) & p.mask
            dmoist_total = W(live_l[..., None], m_adv - m0_lane, 0.0)
            moist_wet_f = moist_wet_f + dmoist_total
            moist_dry_f = moist_dry_f + dmoist_total
            # snow and dew rescaled onto the new land fraction
            # (advect_snow_storage, advect_soil_veg_storage)
            sscale = W(live_l, W(maxnf_l > lf, 1.0 - maxnf_l, 1.0 - lf)
                       / one_m_nf, 1.0)
            snow_adv_mm = (swq + snow_canopy_new) * (sscale - 1.0) * 1000.0
            swq = swq * sscale
            surf_water = surf_water * sscale
            pack_water = pack_water * sscale
            depth = depth * sscale
            snow_canopy_new = snow_canopy_new * sscale
            wdew_adv_mm = wdew_new * (sscale - 1.0)
            wdew_new = wdew_new * sscale
            # closure credit: the advected water is exchanged with the lake
            recharge_lane_mm = (dmoist_total.sum(-1) + snow_adv_mm
                                + wdew_adv_mm)
            to_mm = 1000.0 / cell_area
            # the lake's own fluxes at Cv*Clake (put_data.c:405-413,789)
            lake_w = wl_w * clake_post
            over_lake_mm = 1000.0 / torch.clamp(lres.sarea, min=1.0)
            cell_runoff = ((1.0 - rperc) * oth_ro
                           + lres.runoff_out_m3 * over_lake_mm * lake_w)
            cell_baseflow = ((1.0 - rperc) * oth_bf
                             + lres.baseflow_out_m3 * over_lake_mm * lake_w)
            lake_evap_mm = lres.evap_m3 * over_lake_mm * lake_w
            # precip echoes at the PRE-step lake-scaled weights, plus the
            # lake's own precip on OUT_PREC only (full_energy.c:240-243,781)
            w_pre = w * (1.0 - wl_mask * clake_pre[:, None])
            cl0 = basin0 / torch.clamp(cell_area, min=1.0)
            lake_prec_add = ((forcing["prec"] - rainonly_c) * p.padj_s
                             + rainonly_c * p.padj_r) * cl0 * clake_pre
            prec_cell = (out_prec * w_pre).sum(-1) + lake_prec_add
            rain_cell = (out_rain * w_pre).sum(-1)
            snow_cell = (out_snow * w_pre).sum(-1)
            ls = lres.state
            dvol = ls.volume - state.lake_volume
            dswe = ls.swe - state.lake_swe
            lake_out = {
                "OUT_LAKE_DEPTH": lres.depth,
                "OUT_LAKE_VOLUME": ls.volume,
                "OUT_LAKE_SURF_AREA": lres.sarea,
                "OUT_LAKE_ICE_FRACT": lres.ice_fract,
                # lake_var.hice in m (put_data.c:447)
                "OUT_LAKE_ICE_HEIGHT": ls.ice_height,
                # the top water layer (put_data.c:475)
                "OUT_LAKE_SURF_TEMP": ls.temp[..., 0],
                "OUT_LAKE_EVAP": lake_evap_mm,
                "OUT_LAKE_RCHRG": lres.recharge_m3 * to_mm,
                "OUT_LAKE_AREA_FRAC": lake_w,
                "OUT_LAKE_ICE": W(ls.ice_area > 0.0, ls.ice_water_eq
                                  / torch.clamp(ls.ice_area, min=1.0)
                                  * c.ICE_DENSITY / c.RHO_W, 0.0),
                "OUT_LAKE_ICE_TEMP": W(ls.ice_area > 0.0, ls.tempi, 0.0),
                "OUT_LAKE_SWE": ls.swe,
                "OUT_LAKE_SWE_V": ls.swe * lres.sarea,
                "OUT_LAKE_DSWE_V": dswe * lres.sarea,
                "OUT_LAKE_DSWE": dswe * lres.sarea * to_mm,
                "OUT_LAKE_DSTOR_V": dvol,
                "OUT_LAKE_DSTOR": dvol * to_mm,
                "OUT_LAKE_MOIST": ls.volume * to_mm,
                "OUT_SURFSTOR": ls.volume * to_mm,
                "OUT_DELSURFSTOR": dvol * to_mm,
                "OUT_LAKE_BF_IN_V": b_in,
                "OUT_LAKE_BF_IN": b_in * to_mm,
                "OUT_LAKE_BF_OUT_V": lres.baseflow_out_m3,
                "OUT_LAKE_BF_OUT": lres.baseflow_out_m3 * to_mm,
                # no channel routing in the standalone model
                "OUT_LAKE_CHAN_IN_V": torch.zeros_like(b_in),
                "OUT_LAKE_CHAN_IN": torch.zeros_like(cell_runoff),
                "OUT_LAKE_CHAN_OUT_V": lres.runoff_out_m3,
                "OUT_LAKE_CHAN_OUT": lres.runoff_out_m3 * to_mm,
                "OUT_LAKE_EVAP_V": lres.evap_m3,
                "OUT_LAKE_PREC_V": lres.precip_in_m3,
                "OUT_LAKE_RCHRG_V": lres.recharge_m3,
                "OUT_LAKE_RO_IN_V": r_in,
                "OUT_LAKE_RO_IN": r_in * to_mm,
                "OUT_LAKE_VAPFLX_V": lres.vapor_flux_m3,
                "OUT_LAKE_VAPFLX": lres.vapor_flux_m3 * to_mm,
                "OUT_LAKE_WATER_ERROR": lres.water_error_mm,
                "OUT_LAKE_ENERGY_ERROR": lres.energy_error,
                # soil nodes under the wetland lane (put_data.c:368)
                "OUT_SOIL_TNODE_WL": take_wl(node_temp),
            }
            lake_state = {k: getattr(ls, n) for k, n in zip(
                LAKE_STATE_FIELDS, LAKE_STATE_NAMES)}
            # the wetland lane aggregates at Cv*(1-Clake) from here on
            # (put_data.c:195-196,271,789)
            w = w * (1.0 - wl_mask * clake_post[:, None])

        ph(None)
        # without DIST_PRCP the dry columns are carried as they are
        new_state = ModelState(
            moist=moist_wet_f, ice=ice_new, wdew=wdew_new,
            moist_dry=moist_dry_f if gp.dist_prcp else state.moist_dry,
            ice_dry=ice_new_d if gp.dist_prcp else state.ice_dry,
            wdew_dry=wdew_new_d if gp.dist_prcp else state.wdew_dry,
            snow_canopy=snow_canopy_new,
            swq=swq, surf_temp=surf_temp, pack_temp=pack_temp,
            surf_water=surf_water, pack_water=pack_water,
            density=density, depth=depth, albedo=snow_alb,
            last_snow=last_snow, melting=melting, coverage=coverage,
            cold_content=cold_content, snow_flag=snow_present,
            **r["cov_state"],
            node_temp=node_temp, tfoliage=tfoliage_new,
            long_under_out=luo_out, glac_water_storage=glac_water_storage,
            # mass balance = precip - water reaching the surface -
            # sublimation (surface_fluxes_glac.c:478), m w.e.
            glac_cum_mass_balance=state.glac_cum_mass_balance
            + W(glacier, (out_prec - glac_inflow - snow_sub_mm) / 1000.0
                - W(on_ice, glac.vapor_flux, 0.0), 0.0),
            glac_surf_temp=glac_surf_temp,
            surf_temp_fbcount=state.surf_temp_fbcount + fb.to(torch.int32),
            snow_temp_fbcount=state.snow_temp_fbcount
            + sm.surf_temp_fbflag.to(torch.int32),
            mu=mu, still_storm=still_storm, dry_time=dry_time,
            cell_valid=state.cell_valid,
            **lake_state)

        # ---- water balance closure (put_data.c aggregation): the
        # baseline is the transferred columns at the new mu, which the storm
        # transfers conserve ----
        ph("vic.step.water_balance")
        wdew_c = dw(wdew_new, wdew_new_d)
        storage0 = dw(moist_w.sum(-1), moist_d.sum(-1)) + dw(wdew_w, wdew_d) \
            + state.swq * 1000.0 + state.snow_canopy * 1000.0 \
            + state.glac_water_storage
        storage1 = dw(moist_wet_f.sum(-1), moist_dry_f.sum(-1)) + wdew_c \
            + swq * 1000.0 + snow_canopy_new * 1000.0 + glac_water_storage
        influx = out_prec + W(glacier, glac_melt_mm, 0.0) \
            + recharge_lane_mm - glac_firn_mm
        wb_err = (storage1 - storage0) - (
            influx - total_evap - (runoff_c + glac_outflow) - baseflow_c)

        # ---- outputs (put_data.c) ----
        ph("vic.step.outputs")
        pets = compute_pot_evap(
            tair, vpd, sw_in, eb.net_long_bare, B(p.elevation), dt_hours,
            aero.resist.snow_free, aero.resist.canopy, p.rmin, p.rarc,
            p.rgl, lai, veg_albedo, p.overstory)

        moist_f = dwl(moist_wet_f, moist_dry_f)
        ice_f = dwl(ice_new, ice_new_d)
        liq_f = moist_f - ice_f
        wpwp_b = B(p.wpwp)
        soil_wet = agg(torch.clamp(
            (moist_f - wpwp_b).sum(-1)
            / torch.clamp((B(p.max_moist) - wpwp_b).sum(-1), min=1e-10),
            0.0, 1.0))

        ts_blend = coverage * surf_temp + (1.0 - coverage) * ts
        rt_lane = W(p.overstory & snow_present, tcanopy, ts_blend)
        rtk = rt_lane + c.KELVIN
        rtk2 = rtk * rtk
        rad_temp = agg(rtk2 * rtk2) ** 0.25

        zero_c = torch.zeros_like(cell_runoff)
        if gp.blowing:
            # the sublimation split: blowing vs pack surface
            # (put_data.c:799-802), both loss-negative
            sub_blow_lane = -blow_flux * dt_sec * W(snow_present, 1.0, 0.0)
            out_sub_blowing = -agg(sub_blow_lane)
            out_sub_surface = -agg(snow_sub_mm - sub_blow_lane)
        else:
            out_sub_blowing, out_sub_surface = zero_c, -agg(snow_sub_mm)
        ra_used = W(snow_present, aero.resist.snow_covered,
                    W(on_ice, aero.resist.glacier, aero.resist.snow_free))
        cond1 = 1.0 / torch.clamp(ra_used, min=c.SMALL)
        cond2 = W(p.overstory,
                  1.0 / torch.clamp(aero.resist.canopy, min=c.SMALL), 0.0)
        agg_cond1 = agg(cond1)
        agg_cond2 = agg(cond2)
        agg_cond = agg(W(p.overstory, cond2, cond1))

        def recip(x):
            return W(x > c.SMALL, 1.0 / torch.clamp(x, min=c.SMALL),
                     c.HUGE_RESIST)

        soil_moist_l = aggl(moist_f)
        smliqfrac = aggl(liq_f) / torch.clamp(soil_moist_l, min=c.SMALL)
        grnd_flux_rep = W(on_ice, glac.terms.grnd_flux,
                          W(glacier, t.grnd_flux, eb.grnd_flux))
        glac_imbal = glac_firn_mm - glac_melt_mm \
            - W(on_ice, glac.vapor_flux, 0.0) * 1000.0
        glac_sub = W(on_ice, -glac.vapor_flux, 0.0) * 1000.0
        tair_c = forcing["air_temp"]
        svp_c = svp(tair_c)
        f32 = tair.dtype
        if frozen:
            # thawing/freezing fronts (find_0_degree_fronts) and per-node
            # fallback flags (frozen_soil.c:404-418)
            tdep, fdep = find_zero_fronts(node_temp, geom.zsum[:, None, :])
            tdepth_c = aggl(tdep) * 100.0
            fdepth_c = aggl(fdep) * 100.0
            soilt_fb = ((eb.node_fbcount > 0).to(f32) if fd_nodes
                        else torch.zeros_like(node_temp))
            soil_temp = estimate_layer_ice(node_temp, moist_f, geom)[0]
        else:
            tdepth_c = torch.zeros(cell_runoff.shape + (3,),
                                   dtype=cell_runoff.dtype,
                                   device=cell_runoff.device)
            fdepth_c = tdepth_c
            soilt_fb = torch.zeros_like(node_temp)
            soil_temp = node_temp[..., :1].expand(moist_f.shape)

        outputs = {
            "OUT_SWE": agg((swq + snow_canopy_new) * 1000.0),
            "OUT_SNOW_DEPTH": agg(depth * 100.0),
            "OUT_SNOW_COVER": agg(coverage),
            "OUT_SNOW_CANOPY": agg(snow_canopy_new * 1000.0),
            "OUT_WDEW": agg(wdew_c),
            "OUT_SOIL_MOIST": soil_moist_l,
            "OUT_SOIL_LIQ": aggl(liq_f),
            "OUT_SOIL_ICE": aggl(ice_f),
            "OUT_SOIL_MOIST_TOT": agg(moist_f.sum(-1)),
            "OUT_ROOTMOIST": agg((moist_f * (p.root > 0.0)).sum(-1)),
            "OUT_SOIL_WET": soil_wet,
            "OUT_ASAT": agg(dw(ro.asat, ro_d.asat)),
            "OUT_PREC": agg(out_prec) if prec_cell is None else prec_cell,
            "OUT_RAINF": agg(out_rain) if rain_cell is None else rain_cell,
            "OUT_SNOWF": agg(out_snow) if snow_cell is None else snow_cell,
            "OUT_EVAP": agg(total_evap) + lake_evap_mm,
            "OUT_EVAP_BARE": agg(W(bare, evap_sfree, 0.0)),
            "OUT_EVAP_CANOP": agg(W(snowing, cevap_liq_mm, dw(
                eb.canopy_evap_mm, eb.canopy_evap_mm_dry))),
            "OUT_TRANSP_VEG": agg(W(bare | snowing, 0.0, dw(
                layer_evap.sum(-1), layer_evap_d.sum(-1)))),
            "OUT_SUB_SNOW": agg(snow_sub_mm),
            "OUT_SUB_CANOP": agg(canopy_sub_mm),
            "OUT_SUB_BLOWING": out_sub_blowing,
            "OUT_TFOL_FBFLAG": agg(tfol_fb.to(f32)),
            "OUT_TCAN_FBFLAG": agg(tcanopy_fb.to(f32)),
            # the CLOSE_ENERGY passes of this record, the same for every cell
            "OUT_TCANOPY_ITER": torch.full_like(cell_runoff,
                                                float(close_iters)),
            "OUT_TCANOPY": agg(tcanopy),
            "OUT_VEGT": agg(W(p.overstory & ~snow_present, tfoliage_new,
                              rt_lane)),
            "OUT_RUNOFF": cell_runoff,
            "OUT_BASEFLOW": cell_baseflow,
            "OUT_INFLOW": agg(dw(ppt, ppt_d)),
            "OUT_SNOW_MELT": agg(melt_out),
            "OUT_WATER_ERROR": agg(wb_err),
            "OUT_PET_SATSOIL": agg(pets["satsoil"]),
            "OUT_PET_H2OSURF": agg(pets["h2osurf"]),
            "OUT_PET_SHORT": agg(pets["short"]),
            "OUT_PET_TALL": agg(pets["tall"]),
            "OUT_PET_NATVEG": agg(pets["natveg"]),
            "OUT_PET_VEGNOCR": agg(pets["vegnocr"]),
            "OUT_NET_SHORT": agg(ns_rep),
            "OUT_NET_LONG": agg(nl_rep),
            # energy fluxes are reported positive-upward (put_data.c)
            "OUT_LATENT": -agg(lat_rep),
            "OUT_LATENT_SUB": -agg(latsub_rep),
            "OUT_SENSIBLE": -agg(sens_rep),
            "OUT_GRND_FLUX": -agg(grnd_flux_rep),
            "OUT_DELTAH": -agg(W(glacier, 0.0, eb.delta_h)),
            "OUT_FUSION": -agg(W(glacier, 0.0, eb.fusion)),
            "OUT_SNOW_FLUX": agg(eb.snow_flux * cov_w),
            "OUT_ADVECTION": agg(adv_pack * cov_w),
            "OUT_DELTACC": agg(dcc_pack * cov_w),
            "OUT_RFRZ_ENERGY": agg(rfz_pack * cov_w),
            "OUT_MELT_ENERGY": agg(melt_energy),
            "OUT_ENERGY_ERROR": agg(eb.error),
            "OUT_SURF_TEMP": agg(ts_blend),
            "OUT_RAD_TEMP": rad_temp,
            "OUT_BARESOILT": agg(W(bare, ts_blend, 0.0)),
            "OUT_SNOW_SURF_TEMP": agg(surf_temp),
            "OUT_SNOW_PACK_TEMP": agg(pack_temp),
            "OUT_SOIL_TEMP": aggl(soil_temp),
            "OUT_SOIL_TNODE": aggl(node_temp),
            "OUT_ALBEDO": agg(albedo_under),
            "OUT_SALBEDO": agg(snow_alb),
            "OUT_SURFT_FBFLAG": agg(fb.to(f32)),
            "OUT_SNOWT_FBFLAG": agg(sm.surf_temp_fbflag.to(f32)),
            # met echo: raw cell-level forcing (put_data.c:227-249)
            "OUT_AIR_TEMP": tair_c,
            "OUT_WIND": torch.clamp(forcing["wind"],
                                    min=float(gp.min_wind_speed)),
            "OUT_SHORTWAVE": forcing["shortwave"],
            "OUT_LONGWAVE": forcing["longwave"],
            "OUT_DENSITY": forcing["density"],
            "OUT_PRESSURE": forcing["pressure"] / 1000.0,
            "OUT_VP": forcing["vp"] / 1000.0,
            "OUT_VPD": torch.clamp(svp_c - forcing["vp"], min=0.0) / 1000.0,
            "OUT_REL_HUMID": 100.0 * forcing["vp"]
            / torch.clamp(svp_c, min=1e-10),
            "OUT_GLAC_WAT_STOR": agg(glac_water_storage),
            "OUT_GLAC_AREA": agg(W(glacier, 1.0, 0.0)),
            "OUT_GLAC_MELT": agg(glac_melt_mm),
            "OUT_GLAC_SUB": agg(glac_sub),
            "OUT_GLAC_INFLOW": agg(glac_inflow),
            "OUT_GLAC_OUTFLOW": agg(glac_outflow),
            "OUT_GLAC_SURF_TEMP": agg(glac_surf_temp),
            "OUT_GLAC_MBAL": agg(state.glac_cum_mass_balance * 1000.0),
            "OUT_GLAC_ACCUM": agg(glac_firn_mm),
            "OUT_GLAC_IMBAL": agg(glac_imbal),
            "OUT_GLAC_OUTFLOW_COEF": agg(kfac),
            "OUT_GLAC_DELTACC": agg(W(on_ice, glac.terms.delta_cc, 0.0)),
            "OUT_GLAC_FLUX": agg(W(on_ice, glac.terms.grnd_flux, 0.0)),
            "OUT_GLAC_MELT_ENERGY": agg(W(on_ice, glac.terms.melt_energy,
                                          0.0)),
            "OUT_GLAC_TSURF_FBFLAG": agg(W(on_ice, glac.fbflag,
                                           False).to(f32)),
            "OUT_QAIR": agg(c.EPS_RATIO * vp_air / pressure),
            "OUT_SOIL_LIQ_TOT": agg(liq_f.sum(-1)),
            "OUT_SOIL_ICE_TOT": agg(ice_f.sum(-1)),
            "OUT_SMLIQFRAC": smliqfrac,
            "OUT_SMFROZFRAC": 1.0 - smliqfrac,
            "OUT_POROSITY": p.max_moist / (p.depth * 1000.0),
            "OUT_SOIL_DEPTH": p.depth,
            "OUT_DELSOILMOIST": agg(dw(moist_wet_f.sum(-1),
                                       moist_dry_f.sum(-1))
                                    - dw(moist_w.sum(-1), moist_d.sum(-1))),
            "OUT_DELSWE": agg((swq + snow_canopy_new - state.swq
                               - state.snow_canopy) * 1000.0),
            "OUT_DELINTERCEPT": agg(wdew_c - dw(wdew_w, wdew_d)),
            "OUT_REFREEZE": agg(rfz_pack * cov_w) / c.LF * dt_sec,
            "OUT_SUB_SURFACE": out_sub_surface,
            "OUT_ADV_SENS": (-agg(t.advected_sensible * cov_w)
                             if gp.spatial_snow else zero_c),
            "OUT_AERO_COND": agg_cond,
            "OUT_AERO_COND1": agg_cond1,
            "OUT_AERO_COND2": agg_cond2,
            "OUT_AERO_RESIST": recip(agg_cond),
            "OUT_AERO_RESIST1": recip(agg_cond1),
            "OUT_AERO_RESIST2": recip(agg_cond2),
            "OUT_R_NET": agg(ns_rep + nl_rep),
            "OUT_IN_LONG": agg(lw_in),
            "OUT_SOILT_FBFLAG": aggl(soilt_fb),
            "OUT_FDEPTH": fdepth_c,
            "OUT_TDEPTH": tdepth_c,
            "OUT_SUBSIDENCE": zero_c,
            "OUT_SURF_FROST_FRAC": agg((ice_f[..., 0] > 0.0).to(f32)),
            "OUT_SURFSTOR": zero_c,
            "OUT_DELSURFSTOR": zero_c,
            "OUT_SURF_COND": zero_c,
        }
        if geom is not None:
            # static node-depth echo (put_data.c:522)
            outputs["OUT_ZSUM_NODE"] = geom.zsum.expand(p.n_cell, -1)
        if "tskc" in forcing:
            outputs["OUT_TSKC"] = agg(B(forcing["tskc"]))

        # ---- band-resolved outputs (put_data.c band accumulation) ----
        if n_band > 1:
            in_bands = [(p.band == b) & p.mask for b in range(n_band)]

            def band_agg(x):
                return torch.stack([W(in_b, p.cv * x, 0.0).sum(-1)
                                    for in_b in in_bands], -1)

            glac_flux = W(on_ice, glac.terms.grnd_flux, 0.0)
            outputs.update({
                "OUT_SWE_BAND": band_agg((swq + snow_canopy_new) * 1000.0),
                "OUT_SNOW_DEPTH_BAND": band_agg(depth * 100.0),
                "OUT_SNOW_CANOPY_BAND": band_agg(snow_canopy_new * 1000.0),
                "OUT_SNOW_COVER_BAND": band_agg(coverage),
                "OUT_ALBEDO_BAND": band_agg(albedo_under),
                "OUT_LATENT_BAND": -band_agg(lat_under),
                "OUT_SENSIBLE_BAND": -band_agg(sens_under),
                "OUT_NET_SHORT_BAND": band_agg(ns_under),
                "OUT_NET_LONG_BAND": band_agg(nl_under),
                "OUT_SNOW_MELT_BAND": band_agg(melt_out),
                "OUT_GLAC_MELT_BAND": band_agg(glac_melt_mm),
                "OUT_GLAC_WAT_STOR_BAND": band_agg(glac_water_storage),
                "OUT_AREA_BAND": band_agg(torch.ones_like(coverage)),
                "OUT_ELEV_BAND": band_agg(B(p.elevation) * 0.0
                                          + p.band_elev),
                "OUT_ADVECTION_BAND": band_agg(adv_pack * cov_w),
                "OUT_ADV_SENS_BAND": (
                    -band_agg(t.advected_sensible * cov_w)
                    if gp.spatial_snow else band_agg(
                        torch.zeros_like(coverage))),
                "OUT_DELTACC_BAND": band_agg(dcc_pack * cov_w),
                "OUT_GRND_FLUX_BAND": -band_agg(grnd_flux_rep),
                "OUT_IN_LONG_BAND": band_agg(lw_in),
                "OUT_LATENT_SUB_BAND": -band_agg(
                    eb.latent_heat_sub + t.latent_sub * cov_w),
                "OUT_MELT_ENERGY_BAND": band_agg(melt_energy),
                "OUT_RFRZ_ENERGY_BAND": band_agg(rfz_pack * cov_w),
                "OUT_SNOW_FLUX_BAND": band_agg(eb.snow_flux * cov_w),
                "OUT_SNOW_PACKT_BAND": band_agg(pack_temp),
                "OUT_SNOW_SURFT_BAND": band_agg(surf_temp),
                "OUT_GLAC_ACCUM_BAND": band_agg(glac_firn_mm),
                "OUT_GLAC_AREA_BAND": band_agg(W(glacier, 1.0, 0.0)),
                "OUT_GLAC_IMBAL_BAND": band_agg(glac_imbal),
                "OUT_GLAC_INFLOW_BAND": band_agg(glac_inflow),
                "OUT_GLAC_MBAL_BAND": band_agg(
                    state.glac_cum_mass_balance * 1000.0),
                "OUT_GLAC_OUTFLOW_BAND": band_agg(glac_outflow),
                "OUT_GLAC_SUB_BAND": band_agg(glac_sub),
                "OUT_GLAC_DELTACC_BAND": band_agg(
                    W(on_ice, glac.terms.delta_cc, 0.0)),
                "OUT_GLAC_FLUX_BAND": band_agg(glac_flux),
            })

        if zwt_curves is not None:
            # water-table positions (wrap_compute_zwt, compute_zwt.c): each
            # layer, the top nl-1 layers lumped, the whole column; method 1
            # reports the lowest layer's unless every layer is saturated
            cz = zwt_curves["zwt"][:, None]
            cm = zwt_curves["moist"][:, None]
            zwt_l = compute_zwt(moist_f, cz[:, :, :nl], cm[:, :, :nl])
            zwt2 = compute_zwt(moist_f[..., :-1].sum(-1), cz[:, :, nl],
                               cm[:, :, nl])
            zwt3 = compute_zwt(moist_f.sum(-1), cz[:, :, nl + 1],
                               cm[:, :, nl + 1])
            all_sat = ((B(p.max_moist) - moist_f) <= 1e-10).all(-1)
            outputs.update({
                "OUT_ZWT": agg(W(all_sat, 0.0, zwt_l[..., -1])),
                "OUT_ZWT2": agg(zwt2), "OUT_ZWT3": agg(zwt3),
                "OUT_ZWTL": aggl(zwt_l)})

        outputs.update(lake_out)

        if gp.continue_on_error:
            # freeze the cells whose state went non-finite (vicNl.c:521-558
            # isValid, as a masked update); their outputs are multiplied by
            # 0, so a NaN output stays NaN, as vic_tpu's do
            finite = (torch.isfinite(new_state.moist).all(-1).all(-1)
                      & torch.isfinite(new_state.swq).all(-1)
                      & torch.isfinite(new_state.node_temp).all(-1).all(-1))
            cell_valid = state.cell_valid & finite

            def by_cell(v, x):
                return v.reshape((-1,) + (1,) * (x.dim() - 1))

            new_state = ModelState(**{
                f: W(by_cell(cell_valid, getattr(new_state, f)),
                     getattr(new_state, f), getattr(state, f))
                for f in STATE_FIELDS})
            new_state.cell_valid = cell_valid
            vmask = cell_valid.to(f32)
            outputs = {k: v * by_cell(vmask, v) for k, v in outputs.items()}
            outputs["OUT_CELL_VALID"] = vmask

        if outvars is not None:
            keep = set(outvars) | {"OUT_WATER_ERROR"}
            if gp.continue_on_error:
                keep.add("OUT_CELL_VALID")
            outputs = {k: v for k, v in outputs.items() if k in keep}
        return new_state, outputs

    def step(state: ModelState, forcing):
        trace.count("records")
        with trace.span("vic.step"), trace.phases() as ph:
            return step_phases(state, forcing, ph)

    return step


def gs_wind_h(p: DeviceParams, veg_displ):
    """Wind measurement height per HRU: veg wind_h, at least displacement
    + 2 m."""
    return torch.maximum(p.wind_h, veg_displ + 2.0)


def surf_atten_of(lai, p: DeviceParams):
    """exp(-rad_atten * LAI) on every vegetated lane, 1 on bare/glacier
    lanes (full_energy.c:282)."""
    return torch.where(p.is_bare | p.is_glacier, 1.0,
                       torch.exp(-p.rad_atten * lai))


def run(state: ModelState, forcing_stacked: dict, params: DeviceParams, gp,
        geom=None, zwt_curves=None, lake_params=None, outvars=None):
    """Step through [n_rec, ...] stacked forcing (see make_step for geom
    and lake_params). Returns (final_state,
    outputs stacked over records)."""
    step = make_step(params, gp, geom, zwt_curves, lake_params,
                     outvars=outvars)
    n_rec = len(forcing_stacked["month"])
    per_rec = []
    for i in range(n_rec):
        forc = {k: v[i] for k, v in forcing_stacked.items()}
        state, outputs = step(state, forc)
        per_rec.append(outputs)
    stacked = {k: torch.stack([o[k] for o in per_rec]) for k in per_rec[0]}
    return state, stacked


def make_forcing_stack(forc: dict, timeaxis, device) -> dict:
    """Host forcing dict of [n_rec, n_cell] arrays + time axis -> float32
    tensors on `device`, with 'month' and 'day_in_year' kept as host
    int32 arrays."""
    out = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                              device=device) for k, v in forc.items()}
    out["month"] = np.asarray(timeaxis.month, np.int32)
    out["day_in_year"] = np.asarray(timeaxis.day_in_year, np.int32)
    return out
