"""The lakes' water balance and the CLOSE_ENERGY loop's final update, as
plain versions beside their kernels (`lake_water_balance`, K9's final
mode), on the CPU.

- The port's lake_step against vic_tpu's on a seeded solve_lake result
  (solve_lake replaced in both packages by the same float32 values), at
  test_torch_lake.py's lake tolerances; the seed's lakes drive every branch
  of the balance, and the test asserts that each was reached: evaporation
  over its cap, a lake growing into its wetland with enough water for the
  recharge and with too little, a weir with head > 0, the cap at
  maxvolume, a lake that dries out, lanes outside lane_mask, a dead lake
  and a NaN volume.
- `lake_water_balance_plain` against the torch code it was factored out of
  (`_inline_water_balance`, kept here as it stood in `lake_step`), bit for
  bit, on the seed and on the lakes and NaN-lakes steps' own arguments.
- `canopy_air_final_plain` against the lines of `model.make_step` it was
  factored out of, bit for bit.
- The CPU step reaches only the plain versions and launches nothing.
- A basin whose levels do not fall, or hold a NaN, is refused when the
  lake parameters load and when the step is built.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.lake as jl
from vic_tpu.config import GlobalParams
from vic_tpu.testing import synthetic_domain
from vic_tpu_torch import constants as c
from vic_tpu_torch import kernels
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.model import make_step
from vic_tpu_torch.physics import canopy_air
from vic_tpu_torch.physics import lake as tl
from vic_tpu_torch.prepare import lake_params_from_numpy
from vic_tpu_torch.testing import LAKE_WATER_ULPS

torch.set_num_threads(1)

FP_TOL = 1e-4           # lake_step against vic_tpu (test_torch_lake.py)
DT = 86400.0
N_LANE, N_LAYER = 4, 3
W = torch.where
# the seed's lakes: what each is made to do
LAKES = ("over_cap", "grow_enough", "grow_short", "weir", "over_max",
         "dries_out", "dead", "nan")


def _isum(x):
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _inline_water_balance(lp, st, res, *, runoff_in_m3, baseflow_in_m3, ds,
                          dsmax, ws_arno, dt_sec, c_expt, wetland_moist,
                          wetland_max_moist, wetland_rel_moist, active,
                          lane_mask, seen=None):
    """lake_step's water balance as it stood inline in lake_step before it
    became lake_water_balance_plain, with the lanes' branch decisions
    counted into `seen` (on lanes of the mask)."""
    area_from_depth, depth_from_volume = tl.area_from_depth, \
        tl.depth_from_volume_plain
    seen = {} if seen is None else seen

    def count(name, mask):
        seen[name] = seen.get(name, 0) + int(mask.sum())

    basin0 = lp.basin[..., 0]
    s1 = res.state
    sarea = res.sarea
    lakefrac = torch.clamp(torch.maximum(sarea, st.ice_area)
                           / torch.clamp(basin0, min=1.0), 0.0, 1.0)
    store_start_m3 = st.volume + st.swe * sarea

    live = lp.has_lake & active
    inflow = runoff_in_m3 + baseflow_in_m3
    gains = res.ice_throughfall_m3 + res.store_dump_m3 + inflow \
        + res.snowmelt_m3
    n_lane = lane_mask.shape[1]

    dsmax_step = dsmax / 24.0
    cexp = torch.ones_like(st.volume) * 2.0 if c_expt is None else c_expt

    volume = s1.volume
    iwe = s1.ice_water_eq
    evap_call = res.evap_m3
    zero = torch.zeros_like(volume)
    gains_total = evap_total = recharge_m3 = zero
    baseflow_total = runoff_total = baseflow_out = runoff_out = zero
    max_newfraction = zero
    dmoist_lanes, nf_lanes, maxnf_lanes = [], [], []

    for h in range(n_lane):
        valid = live & lane_mask[:, h]
        count("lane outside the mask", ~lane_mask[:, h])
        count("dead lake", ~live)
        count("NaN volume", valid & torch.isnan(volume))
        # gains + evaporation cap, re-booked every call (lakes.eb.c:1965-1976)
        liquid0 = torch.clamp(volume - iwe, min=0.0)
        over = evap_call > liquid0 + gains
        count("evaporation over its cap", valid & over)
        evap_h = W(over, torch.clamp(liquid0 + gains, min=0.0), evap_call)
        evap_call = W(valid, evap_h, evap_call)
        volume = W(valid, W(over, iwe, volume + gains - evap_h), volume)
        gains_total = gains_total + W(valid, gains, 0.0)
        evap_total = evap_total + W(valid, evap_h, 0.0)

        # new lake extent before recharge (lakes.eb.c:1999-2013)
        volume_save = volume
        liquid1 = torch.clamp(volume - iwe, min=0.0)
        surfacearea = torch.maximum(
            area_from_depth(lp, depth_from_volume(lp, liquid1)),
            res.new_ice_area)
        maxnf_h = torch.clamp(surfacearea / torch.clamp(basin0, min=1.0),
                              0.0, 1.0)
        max_newfraction = W(valid, maxnf_h, max_newfraction)

        # flooding recharge of this lane's soil (lakes.eb.c:2046-2096)
        if wetland_moist is not None:
            moist_h = wetland_moist[:, h, :]
            max_h = wetland_max_moist[:, h, :]
            grow = valid & (maxnf_h > lakefrac)
            gfrac = (maxnf_h - lakefrac) / torch.clamp(1.0 - lakefrac,
                                                       min=1e-6)
            room = torch.clamp(max_h - moist_h, min=0.0)
            want = room * gfrac[..., None]
            rech_h = _isum(want) / 1000.0 * (1.0 - lakefrac) * basin0
            liquid2 = torch.clamp(volume - iwe, min=0.0)
            enough = liquid2 > rech_h
            count("growth with enough water", grow & enough & (rech_h > 0.0))
            count("growth with too little water", grow & ~enough)
            avail_mm = 1000.0 * liquid2 / torch.clamp(
                (maxnf_h - lakefrac) * basin0, min=c.SMALL)
            cum_before = torch.cumsum(room, dim=-1) - room
            fill = torch.minimum(torch.clamp(avail_mm[..., None] - cum_before,
                                             min=0.0), room)
            dmoist_h = W(grow[..., None],
                         W(enough[..., None], want, fill * gfrac[..., None]),
                         0.0)
            rech_h = W(grow, W(enough, rech_h, liquid2), 0.0)
            volume = volume - W(valid, rech_h, 0.0)
            recharge_m3 = recharge_m3 + W(valid, rech_h, 0.0)
            rel_moist = (torch.clamp(wetland_rel_moist[:, h], 0.0, 1.0)
                         if wetland_rel_moist is not None
                         else torch.ones_like(volume))
        else:
            dmoist_h = None
            rel_moist = torch.ones_like(volume)

        # ARNO baseflow through the lake bed (lakes.eb.c:2100-2126),
        # Dsmax/24 per call with no dt scaling (quirk kept)
        baseflow_mm = dsmax_step * ds / ws_arno * rel_moist
        over_ws = rel_moist > ws_arno
        count("bed baseflow above ws", valid & over_ws)
        frac2 = W(over_ws, (rel_moist - ws_arno)
                  / torch.clamp(1.0 - ws_arno, min=c.SMALL), 0.0)
        baseflow_mm = baseflow_mm + W(
            over_ws, dsmax_step * (1.0 - ds / ws_arno)
            * torch.pow(torch.clamp(frac2, min=c.SMALL), cexp), 0.0)
        baseflow_mm = torch.clamp(baseflow_mm, min=0.0)
        liquid3 = torch.clamp(volume - iwe, min=0.0)
        area3 = area_from_depth(lp, depth_from_volume(lp, liquid3))
        bf_h = torch.minimum(torch.clamp(baseflow_mm * area3 / 1000.0,
                                         min=0.0), liquid3)
        volume = volume - W(valid, bf_h, 0.0)
        baseflow_total = baseflow_total + W(valid, bf_h, 0.0)
        baseflow_out = W(valid, bf_h, baseflow_out)

        # weir outflow (lakes.eb.c:2152-2200)
        liquid4 = torch.clamp(volume - iwe, min=0.0)
        ldepth4 = depth_from_volume(lp, liquid4)
        circum = 2.0 * math.pi * torch.sqrt(torch.clamp(area3, min=0.0)
                                            / math.pi)
        head = ldepth4 - lp.mindepth
        count("weir with head > 0", valid & (head > 0.0))
        ro_h = W(head > 0.0,
                 lp.wfrac * circum * dt_sec * 1.6
                 * torch.pow(torch.clamp(head, min=0.0), 1.5), 0.0)
        ro_h = torch.minimum(ro_h, liquid4)
        ro_h = torch.minimum(torch.clamp(ro_h, min=0.0),
                             torch.clamp(volume - lp.minvolume, min=0.0))
        vol_after_weir = volume - W(valid, ro_h, 0.0)
        # growth caps (lakes.eb.c:2183-2200)
        excess_save = torch.clamp(vol_after_weir - volume_save, min=0.0)
        ro_h = ro_h + W(valid, excess_save, 0.0)
        vol_after_weir = vol_after_weir - W(valid, excess_save, 0.0)
        cap = torch.maximum(lp.maxvolume, iwe)
        excess_max = W(vol_after_weir - lp.maxvolume > c.SMALL,
                       torch.clamp(vol_after_weir - cap, min=0.0), 0.0)
        count("excess over maxvolume", valid & (excess_max > 0.0))
        ro_h = ro_h + W(valid, excess_max, 0.0)
        vol_after_weir = vol_after_weir - W(valid, excess_max, 0.0)
        vol_after_weir = W(vol_after_weir < c.SMALL, 0.0, vol_after_weir)
        # the liquid depth vanishes (activenod == 0, lakes.eb.c:2240-2247)
        liquid5 = torch.clamp(vol_after_weir - iwe, min=0.0)
        dry = depth_from_volume(lp, liquid5) <= c.SMALL
        count("lake dries out", valid & dry)
        ro_h = ro_h + W(valid & dry, liquid5, 0.0)
        vol_after_weir = W(valid & dry, iwe, vol_after_weir)
        volume = W(valid, vol_after_weir, volume)
        runoff_total = runoff_total + W(valid, ro_h, 0.0)
        runoff_out = W(valid, ro_h, runoff_out)

        # per-lane final fraction for the storage advection
        liq_f = torch.clamp(volume - iwe, min=0.0)
        ar_f = torch.maximum(area_from_depth(lp, depth_from_volume(lp, liq_f)),
                             res.new_ice_area)
        nf_lanes.append(torch.clamp(ar_f / torch.clamp(basin0, min=1.0),
                                    0.0, 1.0))
        maxnf_lanes.append(maxnf_h)
        if dmoist_h is not None:
            dmoist_lanes.append(dmoist_h)

    dmoist = torch.stack(dmoist_lanes, 1) if dmoist_lanes else None
    lane_nf = torch.stack(nf_lanes, 1)
    lane_maxnf = torch.stack(maxnf_lanes, 1)

    liquid5 = torch.clamp(volume - iwe, min=0.0)
    ldepth5 = depth_from_volume(lp, liquid5)
    dry = ldepth5 <= c.SMALL
    ldepth5 = W(dry, 0.0, ldepth5)
    area5 = area_from_depth(lp, W(dry, 0.0, ldepth5))
    sarea_end = torch.maximum(area5, res.new_ice_area)

    # closure telemetry: every pass after the first re-adds the same gains
    # (the reference's per-HRU quirk) and is credited as influx
    extra_gains = torch.clamp(gains_total - gains, min=0.0)
    store_end_m3 = volume + s1.swe * sarea
    water_error_m3 = (store_end_m3 - store_start_m3) - (
        res.precip_in_m3 + inflow + extra_gains - evap_total
        - res.vapor_flux_m3 - recharge_m3 - baseflow_total - runoff_total)
    water_error_mm = W(live, water_error_m3 / torch.clamp(sarea, min=1.0)
                       * 1000.0, 0.0)
    return dict(volume=volume, evap_m3=evap_call, runoff_out_m3=runoff_out,
                baseflow_out_m3=baseflow_out, recharge_m3=recharge_m3,
                max_newfraction=max_newfraction, depth=ldepth5,
                sarea=sarea_end, water_error_mm=water_error_mm,
                lane_nf=lane_nf, lane_maxnf=lane_maxnf,
                wetland_dmoist_mm=dmoist)


def _lake_params(n):
    """vic_tpu's synthetic basins for n lakes, as float32 numpy and as the
    port's LakeParams."""
    lp_np = jl.make_lake_params(synthetic_domain(n_cell=n).soil,
                                GlobalParams(dt=24))
    lp_np = {f.name: np.asarray(getattr(lp_np, f.name))
             for f in dataclasses.fields(lp_np)}
    lp_np = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
             for k, v in lp_np.items()}
    return lp_np, lake_params_from_numpy(lp_np, "cpu")


def seeded_balance(seed=14):
    """The seed's lakes (LAKES) with N_LANE HRU lanes and N_LAYER wetland
    layers: (lake parameters as numpy, the port's LakeParams, the starting
    state and solve_lake's result as {field: float32 numpy}, the water
    balance's other arguments as numpy)."""
    rng = np.random.default_rng(seed)
    n = len(LAKES)
    lp_np, lp = _lake_params(n)
    maxvol = lp_np["maxvolume"]
    basin0 = lp_np["basin"][:, 0]
    f32 = np.float32

    def u(lo, hi, shape=(n,)):
        return rng.uniform(lo, hi, shape).astype(f32)

    lake = {k: i for i, k in enumerate(LAKES)}
    frac = u(0.6, 0.8)                       # of maxvolume
    frac[lake["grow_short"]] = 2e-3
    frac[lake["weir"]] = 0.95
    frac[lake["over_max"]] = 1.3
    volume = (maxvol * frac).astype(f32)
    iwe = np.zeros(n, f32)
    iwe[lake["dries_out"]] = volume[lake["dries_out"]] * f32(0.5)
    # ice holds most of the over-full lake: the little liquid spills no
    # weir and the cap at maxvolume takes the rest
    iwe[lake["over_max"]] = maxvol[lake["over_max"]] * f32(1.25)
    volume[lake["nan"]] = np.nan
    evap = (u(0.5, 1.5) * f32(1e4)).astype(f32)
    evap[lake["over_cap"]] = f32(1e12)
    evap[lake["dries_out"]] = f32(1e12)
    # a small surface at the step's start: the new extent grows into the
    # wetland
    sarea = (basin0 * u(0.01, 0.2)).astype(f32)
    sarea[lake["grow_short"]] = basin0[lake["grow_short"]] * f32(1e-4)
    st = dict(volume=volume, ice_area=np.zeros(n, f32),
              swe=u(0.0, 0.01))
    s1 = dict(volume=volume, ice_water_eq=iwe, swe=u(0.0, 0.01))
    res = dict(ice_throughfall_m3=u(0.0, 1e3), store_dump_m3=u(0.0, 10.0),
               precip_in_m3=u(0.0, 1e3), snowmelt_m3=u(0.0, 1e2),
               evap_m3=evap, vapor_flux_m3=u(0.0, 10.0),
               new_ice_area=np.where(u(0, 1) < 0.5, 0.0,
                                     basin0 * u(0.0, 0.3)).astype(f32),
               sarea=sarea)
    lane_mask = rng.uniform(size=(n, N_LANE)) < 0.8
    lane_mask[:, 0] = True
    lane_mask[lake["weir"], 1] = False
    active = np.ones(n, bool)
    active[lake["dead"]] = False
    kw = dict(runoff_in_m3=u(0.0, 2e3), baseflow_in_m3=u(0.0, 5e2),
              ds=u(0.05, 0.3), dsmax=u(5.0, 30.0), ws_arno=u(0.5, 0.9),
              c_expt=u(1.5, 3.0),
              wetland_moist=u(20.0, 150.0, (n, N_LANE, N_LAYER)),
              wetland_max_moist=u(300.0, 500.0, (n, N_LAYER)),
              wetland_rel_moist=u(0.2, 1.2, (n, N_LANE)),
              active=active, lane_mask=lane_mask)
    return lp_np, lp, st, s1, res, kw


def _port_result(st, s1, res, n):
    """The port's LakeState and SolveLakeResult from the seed's fields, the
    fields the balance does not read filled with a constant."""
    fill = torch.full((n,), 0.25)

    def state(fields):
        return tl.LakeState(**{
            f.name: (torch.tensor(fields[f.name]) if f.name in fields
                     else torch.zeros(n, dtype=torch.bool)
                     if f.name == "melting"
                     else torch.full((n, tl.MAX_LAKE_NODES), 4.0)
                     if f.name == "temp" else fill)
            for f in dataclasses.fields(tl.LakeState)})

    s0 = state(st)
    r = {k: torch.tensor(v) for k, v in res.items()}
    result = tl.SolveLakeResult(**{
        k: (state(s1) if k == "state" else r[k] if k in r
            else torch.zeros(n, dtype=torch.bool) if k == "ice_fbflag"
            else fill)
        for k in tl.SolveLakeResult._fields})
    return s0, result


def _jax_result(s0, result):
    """vic_tpu's LakeState and SolveLakeResult of the same values."""
    def jstate(s):
        return jl.LakeState(**{f.name: jnp.asarray(getattr(s, f.name)
                                                    .numpy())
                               for f in dataclasses.fields(s)})
    return jstate(s0), jl.SolveLakeResult(**{
        k: jstate(v) if k == "state" else jnp.asarray(v.numpy())
        for k, v in result._asdict().items()})


def _balance_kwargs(kw, lane_max=True):
    """The water balance's keyword arguments as lake_step hands them on:
    wetland_max_moist broadcast to the lanes."""
    out = {k: torch.tensor(v) for k, v in kw.items()}
    if lane_max:
        out["wetland_max_moist"] = out["wetland_max_moist"][:, None, :] \
            .expand(out["wetland_moist"].shape)
    return dict(out, dt_sec=DT)


def _step_forcing(n):
    """lake_step's meteorological arguments, which only solve_lake reads."""
    f = np.full(n, 1.0, np.float32)
    return dict(tair=f, wind=f, sw_in=f, lw_in=f, vp_air=f, vpd=f,
                pressure=f, air_density=f, rainfall_mm=f, snowfall_mm=f,
                lat=f, day_in_year=np.full(n, 30, np.int32), wind_h=f,
                snow_rough=f, new_snow_alb=f, alb_accum_a=f, alb_accum_b=f,
                alb_thaw_a=f, alb_thaw_b=f)


def _equal(got, ref, what):
    """Bit for bit, NaN where the other is NaN."""
    if got is None or ref is None:
        assert got is None and ref is None, what
        return
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    assert bool(same.all()), f"{what}: {int((~same).sum())} differ"


def test_lake_step_matches_vic_tpu_on_every_branch(monkeypatch):
    """Both packages' lake_step on the same solve_lake result: every output
    within FP_TOL of vic_tpu's (the water error within its ulp bound), and
    the seed reaches every branch of the balance."""
    lp_np, lp, st, s1, res, kw = seeded_balance()
    n = len(LAKES)
    s0, result = _port_result(st, s1, res, n)
    j0, jresult = _jax_result(s0, result)
    monkeypatch.setattr(tl, "solve_lake", lambda *a, **k: result)
    monkeypatch.setattr(jl, "solve_lake", lambda *a, **k: jresult)
    forcing = _step_forcing(n)
    got = tl.lake_step(lp, s0, dt_sec=DT, **{
        k: torch.tensor(v) for k, v in dict(forcing, **kw).items()})
    jlp = jl.LakeParams(**{k: jnp.asarray(v) for k, v in lp_np.items()})
    ref = jl.lake_step(jlp, j0, dt_sec=DT, **{
        k: jnp.asarray(v) for k, v in dict(forcing, **kw).items()})
    for name, a, b in zip(got._fields, got, ref):
        if name == "state":
            for f in dataclasses.fields(b):
                np.testing.assert_allclose(
                    getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name)),
                    rtol=FP_TOL, atol=FP_TOL, err_msg=f"state.{f.name}")
        elif name == "water_error_mm":
            bound = LAKE_WATER_ULPS * np.spacing(np.abs(
                np.asarray(ref.state.volume, np.float32))).astype(
                    np.float64) / np.maximum(np.asarray(ref.sarea),
                                             1.0) * 1000.0
            diff = np.abs(a.numpy() - np.asarray(b))
            nan = np.isnan(np.asarray(b))
            assert np.array_equal(np.isnan(a.numpy()), nan), name
            assert (diff[~nan] <= bound[~nan] + FP_TOL).all(), name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FP_TOL,
                                       atol=FP_TOL, err_msg=name)
    seen = {}
    _inline_water_balance(lp, s0, result, **_balance_kwargs(kw), seen=seen)
    missing = [k for k in ("evaporation over its cap",
                           "growth with enough water",
                           "growth with too little water",
                           "weir with head > 0", "excess over maxvolume",
                           "lake dries out", "lane outside the mask",
                           "dead lake", "NaN volume",
                           "bed baseflow above ws") if not seen.get(k)]
    assert not missing, f"branches not reached: {missing} ({seen})"
    assert bool(torch.isnan(got.state.volume).any())


def test_water_balance_plain_is_the_inline_code_on_the_seed():
    """lake_water_balance_plain gives what lake_step's inline balance gave,
    bit for bit, with and without the wetland and its relative moisture."""
    lp_np, lp, st, s1, res, kw = seeded_balance()
    s0, result = _port_result(st, s1, res, len(LAKES))
    args = _balance_kwargs(kw)
    variants = (args, dict(args, wetland_rel_moist=None, c_expt=None),
                dict(args, wetland_moist=None, wetland_max_moist=None,
                     wetland_rel_moist=None,
                     lane_mask=args["lane_mask"][:, :1]))
    for v in variants:
        got = tl.lake_water_balance_plain(lp, s0, result, **v)
        ref = _inline_water_balance(lp, s0, result, **v)
        for k in tl.WaterBalance._fields:
            _equal(getattr(got, k), ref[k], k)


def _captured_balance(config, n_cell, n_rec, build=None):
    """The arguments of lake_water_balance_plain in each record of
    `config`'s CPU run (or of build(n_cell, n_rec, "cpu")'s)."""
    calls = []
    plain = tl.lake_water_balance_plain

    def wrapper(*a, **k):
        calls.append((a, k))
        return plain(*a, **k)

    gp, params, stack, state, extras = (build or CONFIGS[config])(
        n_cell, n_rec, "cpu")
    step = make_step(params, gp, **extras)
    tl.lake_water_balance_plain = wrapper
    try:
        for r in range(n_rec):
            state, _ = step(state, {k: v[r] for k, v in stack.items()})
    finally:
        tl.lake_water_balance_plain = plain
    return calls


def _nan_lakes(n_cell, n_rec, device):
    """lakes with CONTINUEONERROR and NaN air in cell 1 from record 2."""
    gp, params, stack, state, extras = CONFIGS["lakes"](n_cell, n_rec,
                                                        device)
    air = stack["air_temp"].clone()
    air[2:, 1] = float("nan")
    return (gp.replace(continue_on_error=True), params,
            dict(stack, air_temp=air), state, extras)


@pytest.mark.parametrize("config", ["lakes", "nan_lakes"])
def test_water_balance_plain_is_the_inline_code_in_the_step(config):
    """The same, on the arguments the lakes step gives it in each of its
    records (open, then iced lakes; with NaN air in one cell)."""
    calls = _captured_balance("lakes", 4, 4,
                              _nan_lakes if config == "nan_lakes" else None)
    assert len(calls) == 4
    for a, k in calls:
        got = tl.lake_water_balance_plain(*a, **k)
        ref = _inline_water_balance(*a, **k)
        for f in tl.WaterBalance._fields:
            _equal(getattr(got, f), ref[f], f)
    if config == "nan_lakes":
        assert bool(torch.isnan(calls[-1][0][2].state.volume).any())


def _final_inline(canopy_sensible, soil_sensible, pack_sensible, cov_w,
                  tair, air_dens, ra_over, iter_mask):
    """model.make_step's final update as it stood inline."""
    under_sens = soil_sensible + pack_sensible * cov_w
    ca = canopy_air.calc_atmos_energy_bal(canopy_sensible + under_sens,
                                          tair, air_dens, ra_over)
    return (W(iter_mask, ca.tcanopy, tair), W(iter_mask, ca.fbflag, False),
            W(iter_mask, ca.sensible, under_sens))


def test_canopy_air_final_plain_is_the_inline_code():
    """canopy_air_final_plain against the lines it replaced, bit for bit,
    on seeded lanes (NaN and fallback lanes among them) and on the
    arguments the blowing_close and heavy_nolakes steps give it."""
    rng = np.random.default_rng(14)
    shape = (64, 8)

    def u(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    kw = dict(canopy_sensible=u(-300, 300), soil_sensible=u(-100, 100),
              pack_sensible=u(-50, 50), cov_w=u(0, 1), tair=u(-30, 10),
              air_dens=u(1.0, 1.4), ra_over=u(1.0, 200.0),
              iter_mask=torch.tensor(rng.uniform(size=shape) < 0.6))
    kw["canopy_sensible"][3, :4] = float("nan")
    got = canopy_air.canopy_air_final_plain(**kw)
    ref = _final_inline(**kw)
    for g, r, what in zip(got, ref, ("tcanopy", "fbflag", "sensible")):
        _equal(g, r, what)
    assert bool((got[1] & kw["iter_mask"]).any())
    assert bool((~got[1] & kw["iter_mask"]).any())

    calls = []
    plain = canopy_air.canopy_air_final_plain

    def wrapper(**k):
        calls.append(k)
        return plain(**k)

    canopy_air.canopy_air_final_plain = wrapper
    try:
        for config in ("blowing_close", "heavy_nolakes"):
            gp, params, stack, state, extras = CONFIGS[config](2, 1, "cpu")
            make_step(params, gp, **extras)(
                state, {k: v[0] for k, v in stack.items()})
    finally:
        canopy_air.canopy_air_final_plain = plain
    assert len(calls) == 2
    for k in calls:
        for g, r, what in zip(plain(**k), _final_inline(**k),
                              ("tcanopy", "fbflag", "sensible")):
            _equal(g, r, what)


@pytest.mark.parametrize("config", ["lakes", "blowing_close"])
def test_cpu_step_reaches_only_the_plain_versions(config):
    """On the CPU the step calls the plain water balance once a record and
    the plain depth twice (the depth before the step and solve_lake's);
    with CLOSE_ENERGY the plain canopy-air update once a pass and the plain
    final update once a record; and no kernel launches."""
    names = {"lakes": ((tl, "lake_water_balance_plain"),
                       (tl, "depth_from_volume_plain")),
             "blowing_close": ((canopy_air, "canopy_air_step_plain"),
                               (canopy_air, "canopy_air_final_plain"))}[config]
    counts = dict.fromkeys((n for _, n in names), 0)
    originals = {n: getattr(m, n) for m, n in names}

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    gp, params, stack, state, extras = CONFIGS[config](2, 2, "cpu")
    step = make_step(params, gp, **extras)
    kernels.reset_launches()
    for m, n in names:
        setattr(m, n, counted(n, originals[n]))
    passes = []
    try:
        for r in range(2):
            state, out = step(state, {k: v[r] for k, v in stack.items()})
            passes.append(int(out["OUT_TCANOPY_ITER"][0]))
    finally:
        for m, n in names:
            setattr(m, n, originals[n])
    assert all(v == 0 for v in kernels.launches.values())
    if config == "lakes":
        # the water balance solves its own depths (lake_basin.cuh's, or
        # the geometry functions here): outside it, two a record
        assert counts["lake_water_balance_plain"] == 2
        assert counts["depth_from_volume_plain"] \
            == 2 * 2 + 2 * (5 * params.max_hru + 1)
    else:
        assert counts["canopy_air_final_plain"] == 2
        assert counts["canopy_air_step_plain"] == sum(passes)


@pytest.mark.parametrize("fault", ["rising", "nan"])
def test_basin_whose_levels_do_not_fall_is_refused(fault):
    """The basin geometry and the kernels' level searches
    (csrc/lake_basin.cuh) need levels that fall with k and hold no NaN:
    lake_params_from_numpy and make_step refuse any other basin, and take
    the lakes config's own and a flat tail of levels at the bottom, as
    io.lakeparam pads a profile of fewer nodes."""
    gp, params, stack, state, extras = CONFIGS["lakes"](2, 1, "cpu")
    lp = extras["lake_params"]
    make_step(params, gp, **extras)
    arrays = {f.name: getattr(lp, f.name).numpy()
              for f in dataclasses.fields(lp)}
    flat = lp.z.numpy().copy()
    flat[:, -4:] = 0.0
    lake_params_from_numpy(arrays, "cpu")
    lake_params_from_numpy(dict(arrays, z=flat), "cpu")
    z = lp.z.numpy().copy()
    z[1, 3] = z[1, 2] + 1.0 if fault == "rising" else float("nan")
    with pytest.raises(ValueError, match="at cells \\[1\\]"):
        lake_params_from_numpy(dict(arrays, z=z), "cpu")
    bad = dataclasses.replace(lp, z=torch.from_numpy(z))
    with pytest.raises(ValueError, match="must fall"):
        make_step(params, gp, **dict(extras, lake_params=bad))
