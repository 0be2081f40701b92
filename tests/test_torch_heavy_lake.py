"""The pieces of the heavy configuration with LAKES against vic_tpu's, one
function at a time, on the CPU, and the options it still refuses.

The lakes are vic_tpu's synthetic basins, iced over and under snow, with
wind strong enough to blow it: the blowing-snow flux over lake ice
(vic_tpu/physics/lake.py:1364-1384), its sublimation in the ice's energy
balance (ice_energy_terms, lake_ice_melt) and solve_lake with it. Inputs
are drawn with numpy from fixed seeds and handed to both packages as the
same float32 values. Tolerances: the energy-balance terms and the functions
holding a Brent at rtol = atol = 1e-4 with their converged flags equal;
calc_blowing_snow at rtol 1e-4 (BLOWING_RTOL, a flipped decision late in its
24 bisection steps), atol 1e-9 kg/m^2/s; solve_lake as tests/test_torch_lake.py
holds it. Only the SPATIAL_FROST case compiles vic_tpu's frozen and heavy
steps, at one cell and one record, to hold SPATIAL_SNOW on them
(tests/test_torch_golden_heavy.py holds the heavy step itself).
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.blowing_snow as jbs
from vic_tpu.model import run as jax_run
import vic_tpu.physics.lake as jl
from vic_tpu.config import GlobalParams
from vic_tpu.testing import synthetic_domain
from vic_tpu_torch import model
from vic_tpu_torch.entry import (_build, build_frozen, build_heavy,
                                 frozen_params, heavy_forcing, heavy_params)
from vic_tpu_torch.physics import blowing_snow as tbs
from vic_tpu_torch.physics import lake as tl
from vic_tpu_torch.prepare import lake_params_from_numpy
from vic_tpu_torch.state import initial_state
from vic_tpu_torch.testing import (LAKE_ENERGY_ULPS, frozen_run_failures,
                                   heavy_lake_run_failures,
                                   mixed_column_excess)
from vic_tpu_torch.testing import synthetic_domain as t_synthetic_domain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FP_TOL = 1e-4
BLOWING_RTOL = 1e-4
BLOWING_ATOL = 1e-9   # kg/m^2/s
DT = 10800.0          # the heavy configuration's 3-hourly step
N = 6                 # lakes
WINDS = (6.0, 9.0, 12.0, 15.0, 18.0, 22.0)   # m/s, one per lake


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, tol, what):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "bi":
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                   err_msg=what)


@functools.lru_cache(maxsize=None)
def iced_lakes():
    """vic_tpu's lake parameters (floats in float32, as __graft_entry__
    casts them) for N synthetic basins, a state with each lake iced over
    under 2-6 cm of snow, and a cold windy 3-hourly forcing, all as numpy
    float32 arrays."""
    rng = np.random.default_rng(11)
    dom = synthetic_domain(n_cell=N)
    lp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        jl.make_lake_params(dom.soil, GlobalParams(dt=3)))
    st = jl.initial_lake_state(lp, dom.soil.avg_temp)
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa
    area = np.asarray(lp.basin)[:, 0].astype(np.float32)
    hice = f(0.2, 0.4)
    temp = np.linspace(0.2, 3.9, 20, dtype=np.float32)[None, :] \
        * np.ones((N, 1), np.float32)
    state = {f_.name: np.asarray(getattr(st, f_.name))
             for f_ in dataclasses.fields(st)}
    state.update(
        temp=temp, ice_area=area, ice_height=hice,
        ice_water_eq=(area * hice * 917.0 / 999.842594).astype(np.float32),
        swe=f(0.02, 0.06), tempi=f(-8.0, -2.0), surf_temp=f(-8.0, -2.0),
        pack_temp=f(-6.0, -1.0), surf_water=np.zeros(N, np.float32),
        pack_water=np.zeros(N, np.float32), salbedo=f(0.7, 0.85),
        last_snow=np.float32([1, 2, 3, 4, 6, 8]),
        melting=np.zeros(N, bool))
    tair = f(-20.0, -10.0)
    svp = 610.78 * np.exp(17.269 * tair / (237.3 + tair))
    vp = (svp * f(0.5, 0.8)).astype(np.float32)
    forcing = dict(
        tair=tair, wind=np.float32(WINDS), vp=vp, sw_in=f(0.0, 150.0),
        lw_in=f(170.0, 230.0), vpd=(svp - vp).astype(np.float32),
        pressure=f(90000.0, 100000.0), air_density=f(1.25, 1.4),
        snowfall_mm=np.where(np.arange(N) % 2, f(0.5, 2.0), 0.0).astype(
            np.float32),
        rainfall_mm=np.zeros(N, np.float32),
        wind_h=np.full(N, 10.0, np.float32),
        snow_rough=np.full(N, 0.0005, np.float32),
        lat=np.asarray(dom.soil.lat, np.float32), day_in_year=30,
        new_snow_alb=np.full(N, 0.85, np.float32),
        alb_accum_a=np.full(N, 0.94, np.float32),
        alb_accum_b=np.full(N, 0.58, np.float32),
        alb_thaw_a=np.full(N, 0.82, np.float32),
        alb_thaw_b=np.full(N, 0.46, np.float32))
    return lp, state, forcing


def t_args(tree):
    return {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in tree.items()}


def j_args(tree):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def port_solve_lake():
    """The port's solve_lake(blowing=True) on iced_lakes(), with the
    keyword arguments of its calc_blowing_snow_plain and lake_ice_melt
    calls."""
    lp, state, forcing = iced_lakes()
    calls = {}
    originals = {"lake_ice_melt": (tl, tl.lake_ice_melt),
                 "calc_blowing_snow_plain": (tbs, tbs.calc_blowing_snow_plain)}

    def wrap(name, fn):
        def w(**kw):
            calls[name] = kw
            return fn(**kw)
        return w

    for name, (mod, fn) in originals.items():
        setattr(mod, name, wrap(name, fn))
    try:
        res = tl.solve_lake(
            lake_params_from_numpy(lp, "cpu"), tl.LakeState(**t_args(state)),
            dt_sec=DT, active=torch.ones(N, dtype=torch.bool), blowing=True,
            **t_args(forcing))
    finally:
        for name, (mod, fn) in originals.items():
            setattr(mod, name, fn)
    return res, calls


def test_the_fixture_blows_snow_over_lake_ice():
    """Every lake is iced under snow, and the wind blows it from some of
    them and not from the calmest."""
    _, calls = port_solve_lake()
    blow = calls["lake_ice_melt"]["blowing_flux"]
    assert blow.shape == (N,)
    assert bool((calls["lake_ice_melt"]["swq"] > 0.0).all())
    assert bool((blow != 0.0).sum() >= 2) and float(blow[0]) == 0.0


def test_ice_energy_terms_with_blowing_flux_match():
    """Every term of the ice surface balance with a blowing-snow flux,
    including the exact tsurf == 0 melt branch, against vic_tpu's."""
    rng = np.random.default_rng(3)
    n = 64
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    args = dict(ra=f(50.0, 300.0), z_ref=f(2.0, 10.0),
                roughness=f(1e-4, 1e-2), wind=f(0.5, 15.0),
                net_short=f(0.0, 200.0), longwave_in=f(150.0, 300.0),
                air_dens=f(1.2, 1.4), lv=f(2.8e6, 2.9e6), tair=f(-25.0, 2.0),
                pressure=f(9e4, 1e5), vpd=f(0.0, 200.0), vp_air=f(50.0, 600.0),
                rain_m=f(0.0, 1e-3), surf_water=f(0.0, 1e-2),
                tcutoff=f(-0.01, 0.0), avgcond=f(1.0, 20.0),
                sw_conducted=f(0.0, 5.0), blowing_flux=-f(0.0, 2e-5))
    tsurf = np.where(np.arange(n) % 4 == 0, 0.0, f(-20.0, 0.0)).astype(
        np.float32)
    got = tl.ice_energy_terms(torch.tensor(tsurf), dt_sec=DT, **t_args(args))
    ref = jl.ice_energy_terms(jnp.asarray(tsurf), dt_sec=DT, **j_args(args))
    assert bool((got.rest == 0.0).any())    # the melt branch is reached
    for name, a, b in zip(got._fields, got, ref):
        close(a, b, FP_TOL, name)
    # the flux is in the vapor flux and the sublimation term
    still = tl.ice_energy_terms(torch.tensor(tsurf), dt_sec=DT, **t_args(
        dict(args, blowing_flux=np.zeros(n, np.float32))))
    assert not torch.equal(got.latent_sub, still.latent_sub)


_j_ice_melt = jax.jit(jl.lake_ice_melt, static_argnames=("dt_sec",
                                                         "max_iter"))


def test_lake_ice_melt_with_blowing_flux_matches():
    """Snow over lake ice with its Brent solve (K12's plain version) under
    the blowing-snow flux solve_lake hands it: every field and term within
    1e-4, the fallback flags equal."""
    _, calls = port_solve_lake()
    kw = calls["lake_ice_melt"]
    got = tl.lake_ice_melt(**kw)
    ref = _j_ice_melt(**{k: jnp.asarray(v.numpy())
                         if isinstance(v, torch.Tensor) else v
                         for k, v in kw.items()})
    assert bool(((kw["blowing_flux"] != 0.0)
                 & (got.surf_temp < 0.0)).any())
    close(got.surf_temp_fbflag, ref.surf_temp_fbflag, 0, "fbflag")
    for name, a, b in zip(got._fields, got, ref):
        if name == "terms":
            for tname, x, y in zip(a._fields, a, b):
                close(x, y, FP_TOL, f"terms.{tname}")
        else:
            close(a, b, FP_TOL, name)


def test_calc_blowing_snow_on_lake_lanes_matches():
    """calc_blowing_snow on the [n_cell] lake lanes with the frozen-pond
    scalars as float32 tensors, against vic_tpu's with the same scalars as
    Python numbers (vic_tpu/physics/lake.py:1372-1382)."""
    _, calls = port_solve_lake()
    kw = calls["calc_blowing_snow_plain"]
    assert kw["tair"].shape == (N,) and not bool(kw["is_bare"].any())
    got = tbs.calc_blowing_snow_plain(**kw)
    jkw = {k: (jnp.asarray(v.numpy()) if v.dim() else float(v))
           for k, v in kw.items()
           if k not in ("quad_nodes", "log_terms", "dt_sec")}
    assert {k: jkw[k] for k in tl.FROZEN_POND} == pytest.approx(
        tl.FROZEN_POND)
    ref = jbs.calc_blowing_snow(dt_sec=kw["dt_sec"], **jkw)
    for name, a, b in zip(("flux", "transport"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=BLOWING_RTOL, atol=BLOWING_ATOL,
                                   err_msg=name)
    assert int((got[0] != 0.0).sum()) >= 2


_j_solve_lake = jax.jit(functools.partial(jl.solve_lake, dt_sec=DT,
                                          blowing=True))


def test_solve_lake_with_blowing_matches():
    """solve_lake(blowing=True) on the iced, snow-covered lakes against
    vic_tpu's: each result within 1e-4, the storage residuals within their
    ulp bounds and the columns but where a mix near 4 C fell the other way
    (vic_tpu_torch.testing), as tests/test_torch_lake.py holds them."""
    lp, state, forcing = iced_lakes()
    got, _ = port_solve_lake()
    ref = _j_solve_lake(lp, jl.LakeState(**j_args(state)),
                        active=jnp.ones(N, bool), **j_args(forcing))
    vol = np.asarray(ref.state.volume, np.float64)
    area = np.maximum(np.asarray(ref.sarea, np.float64), 1.0)
    energy = (vol * 1000.0 * 4220.0 * 300.0).astype(np.float32)
    for name, a, b in zip(got._fields, got, ref):
        if name == "state":
            for f_ in dataclasses.fields(b):
                x, y = getattr(a, f_.name), getattr(b, f_.name)
                if f_.name == "temp":
                    assert mixed_column_excess(to_np(x), np.asarray(y),
                                               FP_TOL) == [], "temp"
                else:
                    close(x, y, FP_TOL, f"state.{f_.name}")
        elif name in ("energy_error", "delta_h"):
            bound = LAKE_ENERGY_ULPS * np.spacing(energy) / (area * DT)
            diff = np.abs(to_np(a) - np.asarray(b))
            assert (diff <= bound + FP_TOL).all(), name
        else:
            close(a, b, FP_TOL, name)
    # the flux reached the result: the lakes' vapor flux differs from a
    # solve without it
    still = tl.solve_lake(
        lake_params_from_numpy(lp, "cpu"), tl.LakeState(**t_args(state)),
        dt_sec=DT, active=torch.ones(N, dtype=torch.bool), blowing=False,
        **t_args(forcing))
    assert not torch.equal(got.vapor_flux_m3, still.vapor_flux_m3)


def test_heavy_flags_are_graft_entrys():
    """heavy_params sets the flags of __graft_entry__._build(heavy=True)."""
    import __graft_entry__
    ref = __graft_entry__._build(1, n_rec=2, heavy=True)[0]
    got = heavy_params(2)
    for k in ("dt", "snow_step", "frozen_soil", "implicit", "quick_flux",
              "nnode", "close_energy", "dist_prcp", "blowing", "lakes",
              "full_energy", "glacier_id", "snow_band", "nlayer",
              "spatial_frost", "fd_affine_residual", "soil_sweep_maxiter"):
        assert getattr(got, k) == getattr(ref, k), k


@pytest.mark.parametrize("config", ["frozen", "heavy"])
def test_make_step_refuses_spatial_frost(config):
    """FROZEN_SOIL with SPATIAL_FROST was refused by name until the
    subarea average of the layer ice (vic_tpu/physics/frozen_soil.py:
    731-740) came: the frozen and heavy steps now build with it and step
    their first record to finite values. With SPATIAL_SNOW too, refused by
    that name until it was ported, the first record of one cell matches
    vic_tpu's (the frozen rule; the heavy configuration's with LAKES)."""
    build = build_frozen if config == "frozen" else build_heavy
    gp, params, stack, state, extras = build(1, 1, "cpu")
    frost = gp.replace(spatial_frost=True)
    _, outs = model.make_step(params, frost, **extras)(
        state, {k: v[0] for k, v in stack.items()})
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())
    flags = dict(spatial_frost=True, spatial_snow=True)
    if config == "frozen":
        t_gp, params, stack, state, extras = _build(
            frozen_params(1).replace(**flags), 1, 1, "cpu")
        jgp, jparams, jstack, jstate, jgeom = fixture.frozen_inputs(
            1, 1, **flags)
        j_final, j_outs = jax.jit(lambda s, f: jax_run(
            s, f, jparams, jgp, geom=jgeom))(jstate, jstack)
    else:
        t_gp, params, stack, state, extras = _build(
            heavy_params(1).replace(**flags), 1, 1, "cpu", zwt=True,
            forcing=heavy_forcing)
        jgp, jparams, jstack, jstate, jgeom, jzwt, jlp = \
            fixture.heavy_inputs(1, 1, **flags)
        j_final, j_outs = jax.jit(lambda s, f, z, lp: jax_run(
            s, f, jparams, jgp, geom=jgeom, zwt_curves=z, lake_params=lp))(
                jstate, jstack, jzwt, jlp)
    t_final, t_outs = model.run(state, stack, params, t_gp, **extras)
    ref = {f"out/{k}": np.asarray(v) for k, v in j_outs.items()}
    ref.update({f"state/{f.name}": np.asarray(getattr(j_final, f.name))
                for f in dataclasses.fields(j_final)})
    got = {f"out/{k}": v.numpy() for k, v in t_outs.items()}
    got.update({f"state/{k}": v for k, v in t_final.numpy().items()})
    assert sorted(got) == sorted(ref)
    if config == "frozen":
        assert frozen_run_failures(ref, got, FP_TOL) == []
    else:
        assert heavy_lake_run_failures(
            ref, got, FP_TOL, params.cell_area.numpy(), DT) == []


def test_initial_state_refuses_spatial_frost():
    """initial_state refused SPATIAL_FROST with FROZEN_SOIL until the
    subarea average came: it now partitions the cold start's layer water
    over the subareas, into more ice than a single area gives on a cold
    start at the thaw edge."""
    gp = frozen_params(1).replace(spatial_frost=True)
    _, _, _, _, extras = build_frozen(1, 1, "cpu")
    domain = t_synthetic_domain(n_cell=1, n_band=2, with_glacier=True)
    surf = [-0.5]
    frost = initial_state(domain, gp, "cpu", surf_temp_init=surf,
                          geom=extras["geom"])
    one = initial_state(domain, gp.replace(spatial_frost=False), "cpu",
                        surf_temp_init=surf, geom=extras["geom"])
    assert torch.equal(frost.node_temp, one.node_temp)
    assert not torch.equal(frost.ice, one.ice)
