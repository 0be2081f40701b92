"""Snow over lake ice (`lake_ice_melt`) as the plain version beside its
kernel (K12, the whole function in one launch on csrc/lane_brent.cuh), on
the CPU.

- `lake_ice_melt_plain` against the torch code it was factored out of
  (`_inline_lake_ice_melt`, kept here as it stood in physics/lake.py), bit
  for bit, on a seed whose lakes reach every branch (asserted: the surface
  melting at 0 C into the pack, the surface layer, the lake ice and
  through all of it, a thin pack, a Brent lake, the fallback to
  old_tsurf, fresh snow spilling into the pack, NaN air) and on the
  arguments the lakes, heavy and NaN-lakes steps give it.
- `lake_ice_melt_plain` against vic_tpu's lake_ice_melt on the seed, at
  test_torch_lake.py's tolerance, the fallback flags equal.
- K12's inputs and outputs are the wrapper's names in
  csrc/lake_ice_melt.cu's order, and its residual's fields the balance's
  arguments.
- The CPU step reaches only the plain version and launches nothing.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.lake as jl
from vic_tpu_torch import constants as c
from vic_tpu_torch import kernels
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.kernels import build
from vic_tpu_torch.model import make_step
from vic_tpu_torch.physics import lake as tl
from vic_tpu_torch.testing import ICE_MELT_KINDS, ice_melt_inputs

torch.set_num_threads(1)

FP_TOL = 1e-4           # lake_ice_melt against vic_tpu (test_torch_lake.py)
W = torch.where
# the branches the seed's lakes must reach (_inline_lake_ice_melt's counts)
BRANCHES = ("case1", "case2", "case3", "complete", "thin", "brent",
            "fallback", "spill", "nan")


def _inline_lake_ice_melt(*, swq, surf_temp, pack_temp, surf_water,
                          pack_water, lake_ice_m, hice, rainfall_mm,
                          snowfall_mm, tair, wind, vp_air, vpd, pressure,
                          air_dens, longwave_in, net_short, tcutoff, ra,
                          z_ref, roughness, dt_sec, max_iter: int = 30,
                          blowing_flux=0.0, active=None, seen=None):
    """lake_ice_melt as it stood in physics/lake.py before it became
    lake_ice_melt_plain (its CPU branch), with the lakes' branches counted
    into `seen`."""
    seen = {} if seen is None else seen

    def count(name, mask):
        seen[name] = seen.get(name, 0) + int(mask.sum())

    MSW = c.MAX_SURFACE_SWE
    snowfall = snowfall_mm / 1000.0
    rainfall = rainfall_mm / 1000.0
    old_tsurf = surf_temp

    snow_ice = swq - pack_water - surf_water
    ice = snow_ice + lake_ice_m
    surface_swq = torch.clamp(ice, max=MSW)
    surf_covers = surface_swq <= snow_ice
    pack_swq = W(surf_covers, snow_ice - surface_swq, 0.0)
    pack_ice = W(surf_covers, lake_ice_m, ice - surface_swq)

    surface_cc = c.CH_ICE * surface_swq * surf_temp
    pack_cc = c.CH_ICE * (pack_swq + pack_ice) * pack_temp
    snowfall_cc = W(tair > 0.0, 0.0, c.CH_ICE * snowfall * tair)

    # distribute fresh snowfall (ice_melt.c:232-258)
    spill = snowfall > (MSW - surface_swq)
    delta_pack_swq = W(spill, surface_swq + snowfall - MSW, 0.0)
    delta_pack_cc = W(
        spill,
        W(delta_pack_swq > surface_swq,
          surface_cc + (snowfall - MSW)
          / torch.clamp(snowfall, min=c.SMALL) * snowfall_cc,
          delta_pack_swq / torch.clamp(surface_swq, min=c.SMALL)
          * surface_cc),
        0.0)
    surface_swq = W(spill, MSW, surface_swq + snowfall)
    surface_cc = surface_cc + snowfall_cc - delta_pack_cc
    pack_swq = pack_swq + delta_pack_swq
    pack_cc = pack_cc + delta_pack_cc
    surf_temp = W(surface_swq > 0.0,
                  surface_cc / (c.CH_ICE * torch.clamp(surface_swq,
                                                       min=c.SMALL)), 0.0)
    pack_temp = W(pack_swq + pack_ice > 0.0,
                  pack_cc / (c.CH_ICE * torch.clamp(pack_swq + pack_ice,
                                                    min=c.SMALL)), 0.0)
    snow_ice = snow_ice + snowfall
    ice = ice + snowfall
    surf_water = surf_water + rainfall

    avgcond, sw_conducted, sw_under_ice = tl.icerad(
        net_short, hice, snow_ice * c.RHO_W / tl.RHOSNOW)

    lv_ice = (677.0 - 0.07 * tair) * c.JOULES_PER_CAL * c.GRAMS_PER_KG
    term_kwargs = dict(
        ra=ra, z_ref=z_ref, roughness=roughness, wind=wind,
        net_short=net_short, longwave_in=longwave_in, air_dens=air_dens,
        lv=lv_ice, tair=tair, pressure=pressure, vpd=vpd, vp_air=vp_air,
        rain_m=rainfall, surf_water=surf_water, tcutoff=tcutoff,
        avgcond=avgcond, sw_conducted=sw_conducted,
        blowing_flux=torch.as_tensor(blowing_flux, dtype=swq.dtype,
                                     device=swq.device))

    terms0 = tl.ice_energy_terms(torch.zeros_like(swq), dt_sec=dt_sec,
                              **term_kwargs)
    melt_cond = terms0.rest == 0.0

    # ---- branch A: surface at 0 C, melt/refreeze (ice_melt.c:309-410) ----
    refreeze = terms0.refreeze_energy
    refrozen = torch.minimum(torch.clamp(refreeze * dt_sec / (c.LF * c.RHO_W),
                                         min=0.0), surf_water)
    freezing = refreeze >= 0.0
    refz = W(freezing, refrozen, 0.0)
    a_surface_swq = surface_swq + refz
    a_snow_ice = snow_ice + refz
    a_ice = ice + refz
    a_surf_water = torch.clamp(surf_water - refz, min=0.0)
    snowmelt = W(freezing, 0.0,
                 torch.abs(refreeze) * dt_sec / (c.LF * c.RHO_W))

    vflux = terms0.vapor_flux
    vflux_a = W(a_surf_water < -vflux, -a_surf_water, vflux)
    a_surf_water = torch.clamp(a_surf_water + vflux_a, min=0.0)

    case1 = snowmelt <= pack_swq
    case2 = ~case1 & (snowmelt <= a_snow_ice)
    case3 = ~case1 & ~case2 & (snowmelt < a_ice)
    complete = ~case1 & ~case2 & ~case3

    sw1 = a_surf_water + snowmelt
    ps1 = pack_swq - snowmelt
    sw2 = a_surf_water + snowmelt + pack_water
    ss2 = a_surface_swq - (snowmelt - pack_swq)
    sw3 = a_surf_water + a_snow_ice + pack_water
    icemelt3 = snowmelt - a_snow_ice
    lake3 = lake_ice_m - icemelt3
    ss3 = W(a_surface_swq > snowmelt, a_surface_swq - snowmelt, 0.0)
    pi3 = W(a_surface_swq > snowmelt, pack_ice,
            pack_ice - (snowmelt - a_surface_swq))
    sw4 = a_surf_water + a_snow_ice + pack_water
    snowmelt4 = a_ice

    a_state = dict(
        surface_swq=W(case1, a_surface_swq,
                      W(case2, ss2, W(case3, ss3, 0.0))),
        pack_swq=W(case1, ps1, 0.0),
        surf_water=W(case1, sw1, W(case2, sw2, W(case3, sw3, sw4))),
        pack_water=W(case1, pack_water, 0.0),
        snow_ice=W(case1, a_snow_ice - snowmelt,
                   W(case2, a_snow_ice - snowmelt, 0.0)),
        lake_ice=W(case3, lake3, W(complete, 0.0, lake_ice_m)),
        pack_ice=W(case3, pi3, W(complete, 0.0, pack_ice)),
        ice=W(complete, 0.0, a_ice - W(complete, 0.0, snowmelt)),
        surf_temp=torch.zeros_like(surf_temp),
        pack_temp=W(complete, 0.0, pack_temp),
        vapor_flux=vflux_a,
        ice_melt=W(case3, icemelt3, W(complete, lake_ice_m, 0.0)),
        snowmelt=W(complete, snowmelt4, snowmelt))

    # ---- branch B: subfreezing surface, Brent (ice_melt.c:425-520) ----
    thin = surface_swq <= c.MIN_SWQ_EB_THRES
    brent_active = ~melt_cond & ~thin
    if active is not None:
        brent_active = brent_active & active
    solve = tl.lake_ice_brent_plain
    res = solve(old_tsurf - c.SNOW_DT, old_tsurf + c.SNOW_DT, brent_active,
                dt=dt_sec, max_iter=max_iter, max_tries=tl.MAXTRIES,
                **term_kwargs)
    ok = res.converged & ~thin
    b_surf_temp = W(ok, res.root, old_tsurf)     # TFALLBACK (+ thin)
    fbflag = ~ok & ~melt_cond
    terms_b = tl.ice_energy_terms(b_surf_temp, dt_sec=dt_sec,
                                  **term_kwargs)

    # all surface liquid refreezes (ice_melt.c:480-487)
    b_surface_swq = surface_swq + surf_water
    b_snow_ice = snow_ice + surf_water
    b_ice = ice + surf_water
    bv = terms_b.vapor_flux
    exceeds = b_surface_swq < -bv
    surf_over_snow = b_surface_swq > b_snow_ice
    snow_has = b_snow_ice > -bv
    b_state = dict(
        surface_swq=torch.clamp(
            W(exceeds, W(surf_over_snow, b_surface_swq, 0.0),
              b_surface_swq + bv), min=0.0),
        pack_swq=pack_swq, surf_water=torch.zeros_like(surf_water),
        pack_water=pack_water,
        snow_ice=W(exceeds, W(surf_over_snow, 0.0, b_snow_ice),
                   W(snow_has, b_snow_ice + bv, 0.0)),
        lake_ice=torch.clamp(
            W(exceeds,
              W(surf_over_snow, lake_ice_m - (b_surface_swq - b_snow_ice),
                lake_ice_m),
              W(snow_has, lake_ice_m, lake_ice_m + (bv + b_snow_ice))),
            min=0.0),
        pack_ice=pack_ice,
        ice=torch.clamp(W(exceeds, W(surf_over_snow, pack_ice,
                                     pack_swq + pack_ice), b_ice + bv),
                        min=0.0),
        surf_temp=b_surf_temp, pack_temp=pack_temp,
        vapor_flux=W(exceeds, -b_surface_swq, bv),
        ice_melt=torch.zeros_like(swq), snowmelt=torch.zeros_like(swq))

    def sel(k):
        return W(melt_cond, a_state[k], b_state[k])

    surface_swq = sel("surface_swq")
    pack_swq = sel("pack_swq")
    surf_water = sel("surf_water")
    pack_water = sel("pack_water")
    snow_ice = sel("snow_ice")
    lake_ice = sel("lake_ice")
    pack_ice = sel("pack_ice")
    ice = sel("ice")
    surf_temp = sel("surf_temp")
    pack_temp = sel("pack_temp")
    vapor_flux = sel("vapor_flux")
    ice_melt_m = sel("ice_melt")
    terms = tl.IceEBTerms(*(W(melt_cond, a, b)
                         for a, b in zip(terms0, terms_b)))

    # ---- liquid capacity + pack refreeze (ice_melt.c:528-590) ----
    max_liquid = c.SNOW_LIQUID_WATER_CAPACITY * torch.minimum(snow_ice,
                                                              surface_swq)
    melt_out = torch.clamp(surf_water - max_liquid, min=0.0)
    surf_water = torch.minimum(surf_water, max_liquid)

    pack_water = pack_water + melt_out
    pack_cc = c.CH_ICE * (pack_swq + pack_ice) * pack_temp
    pack_refreeze_e = pack_water * c.LF * c.RHO_W
    cold_enough = pack_cc < -pack_refreeze_e
    pack_swq_f = pack_swq + pack_water
    ice_f = ice + pack_water
    snow_ice_f = snow_ice + pack_water
    pack_cc_f = pack_cc + pack_refreeze_e
    pack_temp_f = W(pack_swq_f + pack_ice > 0.0,
                    torch.clamp(pack_cc_f / (c.CH_ICE * torch.clamp(
                        pack_swq_f + pack_ice, min=c.SMALL)), max=0.0), 0.0)
    delta_pack = -pack_cc / (c.LF * c.RHO_W)
    pack_swq = W(cold_enough, pack_swq_f, pack_swq + delta_pack)
    ice = W(cold_enough, ice_f, ice + delta_pack)
    snow_ice = W(cold_enough, snow_ice_f, snow_ice + delta_pack)
    pack_water = W(cold_enough, 0.0,
                   torch.clamp(pack_water - delta_pack, min=0.0))
    pack_temp = W(cold_enough, pack_temp_f, 0.0)

    max_liquid_pack = c.SNOW_LIQUID_WATER_CAPACITY * pack_swq
    melt_out = torch.clamp(pack_water - max_liquid_pack, min=0.0)
    pack_water = torch.minimum(pack_water, max_liquid_pack)

    # ---- re-layer around MAX_SURFACE_SWE (ice_melt.c:593-625) ----
    ice = pack_ice + pack_swq + surface_swq
    deep = ice > MSW
    surface_cc = c.CH_ICE * surf_temp * surface_swq
    pack_cc = c.CH_ICE * pack_temp * (pack_swq + pack_ice)
    excess = surface_swq - MSW
    frac_s = excess / torch.clamp(surface_swq, min=c.SMALL)
    pack_cc_1 = pack_cc + surface_cc * frac_s
    surface_cc_1 = surface_cc * (1.0 - frac_s)
    pack_swq_1 = pack_swq + excess
    deficit = MSW - surface_swq
    frac_p = deficit / torch.clamp(pack_swq + pack_ice, min=c.SMALL)
    pack_cc_2 = pack_cc * (1.0 - frac_p)
    surface_cc_2 = surface_cc + pack_cc * frac_p
    pack_swq_2 = pack_swq - deficit

    too_thick = surface_swq > MSW
    exact = surface_swq == MSW
    surface_swq_d = W(exact, surface_swq, torch.full_like(surface_swq, MSW))
    pack_swq_d = W(exact, pack_swq, W(too_thick, pack_swq_1, pack_swq_2))
    surface_cc_d = W(exact, surface_cc,
                     W(too_thick, surface_cc_1, surface_cc_2))
    pack_cc_d = W(exact, pack_cc, W(too_thick, pack_cc_1, pack_cc_2))

    surface_swq = W(deep, surface_swq_d, surface_swq)
    pack_swq = W(deep, torch.clamp(pack_swq_d, min=0.0), 0.0)
    pack_ice = W(deep, pack_ice, 0.0)
    surf_temp = W(deep, surface_cc_d / (c.CH_ICE * torch.clamp(
        surface_swq_d, min=c.SMALL)), surf_temp)
    pack_temp = W(deep, pack_cc_d / (c.CH_ICE * torch.clamp(
        pack_swq_d + pack_ice, min=c.SMALL)), 0.0)

    swq_out = snow_ice + surf_water + pack_water
    cold_content = c.CH_ICE * surf_temp * surface_swq
    for name, mask in (("case1", case1), ("case2", case2),
                       ("case3", case3), ("complete", complete)):
        count(name, melt_cond & mask)
    count("thin", thin & ~melt_cond)
    count("brent", res.converged & ~thin)
    count("fallback", fbflag & ~thin)
    count("spill", spill)
    count("nan", torch.isnan(tair))
    return tl.IceMeltResult(
        swq=torch.clamp(swq_out, min=0.0), surf_temp=surf_temp,
        pack_temp=pack_temp, surf_water=surf_water, pack_water=pack_water,
        melt_m=melt_out, ice_melt_m=ice_melt_m,
        lake_ice_m=torch.clamp(lake_ice, min=0.0),
        vapor_flux=-vapor_flux, qnet=terms.rest, surf_temp_fbflag=fbflag,
        cold_content=cold_content, terms=terms, sw_under_ice=sw_under_ice)


def _seed(seed=15):
    kw, kinds = ice_melt_inputs(64, seed)
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}, kinds


def _equal(got, ref, what):
    """Bit for bit, NaN equal to NaN."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if got.dtype == torch.float32:
        same = (got.view(torch.int32) == ref.view(torch.int32)) \
            | (torch.isnan(got) & torch.isnan(ref))
        assert bool(same.all()), (what, int((~same).sum()))
    else:
        assert torch.equal(got, ref), what


def _equal_results(got, ref):
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if name == "terms":
            for tname in b._fields:
                _equal(getattr(a, tname), getattr(b, tname),
                       f"terms.{tname}")
        elif name != "solve":
            _equal(a, b, name)


def test_plain_is_the_inline_code_on_the_seed():
    """lake_ice_melt_plain is the code it was factored out of, bit for bit,
    on the seed's lakes, which reach every branch of it."""
    kw, kinds = _seed()
    seen = {}
    ref = _inline_lake_ice_melt(**kw, seen=seen)
    got = tl.lake_ice_melt_plain(**kw)
    _equal_results(got, ref)
    assert {k: v for k, v in seen.items() if k in BRANCHES and not v} == {}
    # the Brent's outputs ride along: the fallback where it did not converge
    assert torch.equal(got.surf_temp_fbflag[kinds == "masked"],
                       torch.ones(int((kinds == "masked").sum()),
                                  dtype=torch.bool))
    assert bool(got.solve.converged[kinds == "brent"].all())
    assert set(ICE_MELT_KINDS) == set(kinds)


_j_ice_melt = jax.jit(jl.lake_ice_melt, static_argnames=("dt_sec",
                                                         "max_iter"))


def test_plain_matches_vic_tpu_on_the_seed():
    """lake_ice_melt_plain against vic_tpu's lake_ice_melt on the seed:
    every field and term within 1e-4, the fallback flags equal, NaN on the
    same lakes."""
    kw, _ = _seed()
    got = tl.lake_ice_melt_plain(**kw)
    ref = _j_ice_melt(**{k: jnp.asarray(v.numpy())
                         if isinstance(v, torch.Tensor) else v
                         for k, v in kw.items()})
    np.testing.assert_array_equal(got.surf_temp_fbflag.numpy(),
                                  np.asarray(ref.surf_temp_fbflag))
    for name, a, b in zip(got._fields, got, ref):
        pairs = zip(a._fields, a, b) if name == "terms" else ((name, a, b),)
        for what, x, y in pairs:
            np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                       rtol=FP_TOL, atol=FP_TOL,
                                       err_msg=what)


def _nan_lakes(n_cell, n_rec, device):
    """lakes with CONTINUEONERROR and NaN air in cell 1 from record 1."""
    gp, params, stack, state, extras = CONFIGS["lakes"](n_cell, n_rec,
                                                        device)
    air = stack["air_temp"].clone()
    air[1:, 1] = float("nan")
    return (gp.replace(continue_on_error=True), params,
            dict(stack, air_temp=air), state, extras)


# (build function, cells, records): the lakes freeze and carry snow from the
# second record; heavy's lakes freeze from its third, their snow blows from
# about its sixth
STEPS = {"lakes": (CONFIGS["lakes"], 4, 2), "heavy": (CONFIGS["heavy"], 8, 7),
         "nan_lakes": (_nan_lakes, 4, 2)}


def _captured(config):
    """The arguments of lake_ice_melt_plain in each record of `config`'s
    CPU run."""
    build_fn, n_cell, n_rec = STEPS[config]
    calls = []
    plain = tl.lake_ice_melt_plain

    def wrapper(**k):
        calls.append(k)
        return plain(**k)

    gp, params, stack, state, extras = build_fn(n_cell, n_rec, "cpu")
    step = make_step(params, gp, **extras)
    tl.lake_ice_melt_plain = wrapper
    try:
        for r in range(n_rec):
            state, _ = step(state, {k: v[r] for k, v in stack.items()})
    finally:
        tl.lake_ice_melt_plain = plain
    return calls


@pytest.mark.parametrize("config", list(STEPS))
def test_plain_is_the_inline_code_in_the_step(config):
    """The same, on the arguments the step gives it in each record (iced
    lakes under snow; heavy's with the blowing-snow flux; NaN air in one
    cell)."""
    calls = _captured(config)
    assert len(calls) == STEPS[config][2]
    for k in calls:
        _equal_results(tl.lake_ice_melt_plain(**k),
                       _inline_lake_ice_melt(**k))
    last = calls[-1]
    if config == "heavy":
        assert bool((last["blowing_flux"] != 0.0).any())
    if config == "nan_lakes":
        assert bool(torch.isnan(last["tair"]).any())


def _parameters(fn):
    return set(inspect.signature(fn).parameters)


def _enum(src, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def _camel(name):
    return "k" + "".join(w[:1].upper() + w[1:] for w in name.split("_"))


def test_ice_melt_kernel_rows_are_the_wrappers():
    """K12 reads kernels.ICE_MELT_INPUTS (lake_ice_melt's arguments) in
    csrc/lake_ice_melt.cu's In order and writes IceEBTerms' fields, then
    kernels.ICE_MELT_OUTPUTS, in IceTerm's and IceOut's; with qnet (the
    terms' rest), the fallback flag and the Brent's outputs they are every
    field of IceMeltResult. Its residual's fields are dt and
    kernels.ICE_EB_INPUTS, ice_energy_terms' arguments."""
    src = (build.CSRC / "lake_ice_melt.cu").read_text()
    names = {"lake_ice_m": "kLakeIce", "rainfall_mm": "kRainMm",
             "snowfall_mm": "kSnowMm", "longwave_in": "kLongwave",
             "roughness": "kRough", "blowing_flux": "kBlowing"}
    assert _enum(src, "In") == [names.get(k, _camel(k)) for k in
                                kernels.ICE_MELT_INPUTS] + ["kNumIn"]
    assert _enum(src, "IceTerm") == [_camel(k) for k in
                                     tl.IceEBTerms._fields] + ["kNumTerms"]
    out = {"swq": "kSwqOut", "surf_temp": "kSurfTempOut",
           "pack_temp": "kPackTempOut", "surf_water": "kSurfWaterOut",
           "pack_water": "kPackWaterOut", "lake_ice_m": "kLakeIceOut",
           "vapor_flux": "kVaporOut"}
    assert _enum(src, "IceOut") == [out.get(k, _camel(k)) for k in
                                    kernels.ICE_MELT_OUTPUTS] + ["kNumOut"]
    assert set(tl.IceMeltResult._fields) == {
        *kernels.ICE_MELT_OUTPUTS, "qnet", "surf_temp_fbflag", "terms",
        "solve"}
    body = re.search(r"struct IceResidual \{\s*float([^;]*);", src).group(1)
    assert [w.strip() for w in body.split(",")] == ["dt"] + list(
        kernels.ICE_EB_INPUTS)
    assert set(kernels.ICE_EB_INPUTS) == _parameters(
        tl.ice_energy_terms) - {"tsurf", "dt_sec"}
    assert set(kernels.ICE_MELT_INPUTS) == _parameters(
        tl.lake_ice_melt_plain) - {"dt_sec", "max_iter", "active"}


def test_cpu_step_reaches_only_the_plain_version():
    """On the CPU the lakes step calls lake_ice_melt_plain, and with it the
    plain Brent, once a record, and launches no kernel."""
    counts = {"lake_ice_melt_plain": 0, "lake_ice_brent_plain": 0}
    originals = {n: getattr(tl, n) for n in counts}

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    gp, params, stack, state, extras = CONFIGS["lakes"](2, 2, "cpu")
    step = make_step(params, gp, **extras)
    kernels.reset_launches()
    for n, fn in originals.items():
        setattr(tl, n, counted(n, fn))
    try:
        for r in range(2):
            state, _ = step(state, {k: v[r] for k, v in stack.items()})
    finally:
        for n, fn in originals.items():
            setattr(tl, n, fn)
    assert counts == {"lake_ice_melt_plain": 2, "lake_ice_brent_plain": 2}
    assert all(v == 0 for v in kernels.launches.values())


def test_kernel_refuses_cpu_tensors():
    kw, _ = _seed()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lake_ice_melt(**kw)
