"""The port's blowing snow, blowing-flux snow balances and canopy-air balance
against vic_tpu's, function by function, on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages as
the same float32 values. Elementwise functions are held at rtol = 1e-5
(atol as stated per case); the ones holding a bisection or a quadrature at
rtol = 1e-4 (a flipped bisection decision late in the 24 steps moves the
shear velocity by its last steps' width); functions holding a Brent as the
other physics tests hold them (tests/test_torch_physics.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.physics import blowing_snow as jbs
from vic_tpu.physics import canopy_air as jca
from vic_tpu.physics import snow as jsnow
from vic_tpu_torch.entry import build_blowing_close
from vic_tpu_torch.model import make_step
from vic_tpu_torch.physics import blowing_snow as tbs
from vic_tpu_torch.physics import canopy_air as tca
from vic_tpu_torch.physics import snow as tsnow

torch.set_num_threads(1)

SHAPE = (4, 8)
ELEM_TOL = 1e-5
LOOP_TOL = 1e-4
FLUX_ATOL = 1e-9      # kg/m^2/s, far below the -5e-5 floor


def draw(seed, lo, hi, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def close(got, ref, rtol, atol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def T(a):
    return torch.tensor(np.asarray(a))


def test_quadrature_nodes_are_jax_linspace():
    np.testing.assert_array_equal(tbs.QUAD_NODES,
                                  np.asarray(jnp.linspace(0.0, 1.0, 16)))


def test_laplace_logs_are_jax_logs():
    """The float32 logs of the Laplace bounds' arguments, where vic_tpu
    takes jnp.log of the same Python floats."""
    _, logs = tbs.tables("cpu")
    ref = [float(jnp.log(a)) for a in tbs.laplace_log_arguments()]
    np.testing.assert_allclose(logs.numpy(), np.float32(ref), rtol=1e-6)


def test_get_prob_and_thresh():
    tair, age = draw(1, -25.0, 2.0), draw(2, 0.0, 200.0)
    sw = np.where(draw(3, 0, 1) < 0.3, draw(4, 0.0, 0.01), 0.0).astype(
        np.float32)
    u10, z0 = draw(5, 0.5, 25.0), draw(6, 1e-4, 0.01)
    close(tbs.get_prob(T(tair), T(age), T(sw), T(u10)),
          jbs.get_prob(tair, age, sw, u10), ELEM_TOL, 1e-7, "get_prob")
    close(tbs.get_thresh(T(tair), T(sw), T(z0)),
          jbs.get_thresh(tair, sw, z0), ELEM_TOL, 0.0, "get_thresh")


def test_shear_residual_and_solve_shear():
    x, u = draw(7, 0.1, 2.0), draw(8, 0.5, 25.0)
    close(tbs.shear_residual(T(x), T(u)), jbs.shear_residual(x, u),
          ELEM_TOL, 1e-5, "shear_residual")
    z0 = draw(9, 1e-4, 0.01)
    ut = np.asarray(jbs.get_thresh(draw(10, -25.0, 0.0),
                                   np.zeros(SHAPE, np.float32), z0))
    got = tbs.solve_shear(T(u), T(z0), T(ut))
    ref = jbs.solve_shear(u, z0, ut)
    for g, r, name in zip(got, ref, ("ushear", "zo_salt")):
        close(g, r, LOOP_TOL, 0.0, name)


def _flux_inputs():
    u10, z0 = draw(11, 2.0, 25.0), draw(12, 1e-4, 0.01)
    tair = draw(13, -25.0, -1.0)
    es = np.asarray(jbs.svp(tair))
    eact = (es * draw(14, 0.3, 1.05)).astype(np.float32)
    ls = ((677.0 - 0.07 * tair) * 4.1868 * 1000.0).astype(np.float32)
    tk = tair + 273.15
    F = np.asarray((ls / (jbs.KA_AIR * tk)) * (ls * jbs.MW / (jbs.R_GAS * tk)
                                              - 1.0)
                   + 1.0 / (2.06e-5 * (tk / 273.0) ** 1.75
                            * (0.622 * es / (287.0 * tk)))).astype(np.float32)
    ut = np.asarray(jbs.get_thresh(tair, np.zeros(SHAPE, np.float32), z0))
    fe = np.where(draw(15, 0, 1) < 0.3, 1500.0, 2500.0).astype(np.float32)
    return dict(u10=u10, es=es, eact=eact, air_dens=draw(16, 1.1, 1.4),
                z0=z0, fe=fe, F=F, utshear=ut, tair=tair)


def test_sub_with_height():
    x = _flux_inputs()
    z = draw(17, 0.01, 5.0)
    ushear = draw(18, 0.3, 1.2)
    args = (z, x["es"], x["u10"], x["z0"], x["eact"], x["F"],
            draw(19, 0.005, 0.05), draw(20, 0.0, 0.5), ushear)
    close(tbs.sub_with_height(*map(T, args)), jbs.sub_with_height(*args),
          ELEM_TOL, 1e-12, "sub_with_height")


def test_sub_flux_one():
    x = _flux_inputs()
    got = tbs._sub_flux_one(T(x["u10"]), T(x["es"]), T(x["eact"]),
                            T(x["air_dens"]), T(x["z0"]), T(x["fe"]),
                            T(x["F"]), T(x["utshear"]),
                            torch.tensor(tbs.QUAD_NODES))
    ref = jbs._sub_flux_one(x["u10"], x["tair"], x["tair"], x["es"],
                            x["eact"], x["air_dens"], 2.0, x["z0"], x["fe"],
                            x["F"], np.zeros(SHAPE, np.float32), x["utshear"])
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.0
    for g, r, name in zip(got, ref, ("subflux", "transport")):
        close(g, r, LOOP_TOL, FLUX_ATOL, name)


# CalcBlowingSnow's inputs traced from the instrumented C binary
# (tests/test_blowing_snow.py:111-127): Dt(h) Tair LastSnow SurfWater Wind
# Ls AirDens Press EactAir ZO Zrh snowdepth lag_one sigma_slope Tsnow
# isBare fe disp rough
TRACED = np.array([
    [3.0, -6.8024, 2, 0.0, 4.270211179, 2841189.91, 1.249317108,
     95500.0, 232.9, 0.0012, 2.0012, 0.08672765232, 0.8999999762, 1.0,
     -22.95073692, 0, 2000.0, 0.3, 0.05],
    [3.0, 4.8308, 13, 0.0, 1.462055485, 2835101.533, 1.197034519,
     95500.0, 548.5, 0.0012, 2.0012, 0.4442905796, 0.8999999762, 1.0,
     -2.176682735, 0, 2000.0, 0.3, 0.05],
    [3.0, -5.8216, 0, 0.0, 6.031728762, 2841002.687, 1.244733493,
     95500.0, 215.0, 0.0012, 2.0012, 0.2213331431, 0.8999999762, 1.0,
     -22.31191621, 0, 2000.0, 0.3, 0.05],
    [3.0, -8.9738, 0, 0.0, 4.660892522, 2840084.814, 1.259585887,
     95500.0, 144.6, 0.0012, 2.0012, 0.04553707334, 0.8999999762, 1.0,
     -19.18005409, 1, 2000.0, 0.05422764228, 0.01],
])
NAMES = ("dt_sec", "tair", "last_snow", "surf_water_m", "wind_2m", "ls",
         "air_dens", "pressure", "eact", "z0_snow", "zrh", "snowdepth",
         "lag_one", "sigma_slope", "tsnow", "is_bare", "fetch",
         "displacement", "roughness")


def _blowing(inputs):
    """calc_blowing_snow of both packages on the same float32 inputs."""
    jin = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in inputs.items()}
    tin = {k: (T(v) if isinstance(v, np.ndarray) else v)
           for k, v in inputs.items()}
    return jbs.calc_blowing_snow(**jin), tbs.calc_blowing_snow(**tin)


def test_calc_blowing_snow_on_the_traced_c_inputs():
    cols = {n: TRACED[:, i] for i, n in enumerate(NAMES)}
    inputs = {n: v.astype(np.float32) for n, v in cols.items()}
    inputs["dt_sec"] = float(cols["dt_sec"][0] * 3600.0)
    inputs["zrh"] = float(cols["zrh"][0])
    inputs["is_bare"] = cols["is_bare"].astype(bool)
    ref, got = _blowing(inputs)
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.0
    for g, r, name in zip(got, ref, ("flux", "transport")):
        close(g, r, LOOP_TOL, FLUX_ATOL, name)


def test_calc_blowing_snow_on_the_steps_inputs():
    """At the arguments the blowing_close step hands calc_blowing_snow in
    its fourth record (packs on the ground, 8 m/s more wind)."""
    captured = []
    orig = tbs.calc_blowing_snow_plain
    tbs.calc_blowing_snow_plain = lambda **k: (captured.append(k),
                                               orig(**k))[1]
    try:
        gp, params, stack, state, _ = build_blowing_close(4, 4, "cpu")
        step = make_step(params, gp)
        for r in range(4):
            state, _ = step(state, {k: v[r] for k, v in stack.items()})
    finally:
        tbs.calc_blowing_snow_plain = orig
    k = {n: v for n, v in captured[-1].items()
         if n not in ("quad_nodes", "log_terms")}
    inputs = {n: (v.numpy() if isinstance(v, torch.Tensor) else v)
              for n, v in k.items()}
    ref, got = _blowing(inputs)
    assert int((got[0] != 0).sum()) > 0
    for g, r, name in zip(got, ref, ("flux", "transport")):
        close(g, r, LOOP_TOL, FLUX_ATOL, name)


def _snow_inputs(seed):
    return [draw(seed, 1.0, 1.3), draw(seed + 1, 100.0, 1500.0),
            draw(seed + 2, 2.45e6, 2.55e6),
            np.full(SHAPE, 85000.0, np.float32), draw(seed + 3, 20.0, 500.0),
            draw(seed + 4, -20.0, 2.0), draw(seed + 5, 0.0, 800.0)]


def test_latent_heat_from_snow_with_a_blowing_flux():
    x = _snow_inputs(30)
    blow = -draw(36, 0.0, 5e-5)
    ref = jsnow.latent_heat_from_snow(*map(jnp.asarray, x),
                                      blowing_flux=jnp.asarray(blow))
    got = tsnow.latent_heat_from_snow(*map(T, x), blowing_flux=T(blow))
    for g, r, name in zip(got, ref, ("latent", "latent_sub", "vapor")):
        close(g, r, ELEM_TOL, 1e-6, name)


def test_snow_melt_with_a_blowing_flux():
    """snow_melt at the blowing_close step's arguments of its fourth record,
    where the blowing flux is nonzero on packs."""
    captured = []
    orig = tsnow.snow_melt
    import vic_tpu_torch.model as tmodel
    tmodel.snow_melt = lambda **k: (captured.append(k), orig(**k))[1]
    try:
        gp, params, stack, state, _ = build_blowing_close(4, 4, "cpu")
        step = make_step(params, gp)
        for r in range(4):
            state, _ = step(state, {k: v[r] for k, v in stack.items()})
    finally:
        tmodel.snow_melt = orig
    k = captured[-1]
    assert bool((k["blowing_flux"] != 0).any())
    ref = jsnow.snow_melt(**{n: (jnp.asarray(v.numpy())
                                 if isinstance(v, torch.Tensor) else v)
                             for n, v in k.items()},
                          displacement=jnp.zeros(tuple(k["swq"].shape)))
    got = tsnow.snow_melt(**k)
    for name in ("swq", "surf_temp", "pack_temp", "surf_water", "pack_water",
                 "melt", "vapor_flux", "cold_content", "surf_temp_fbflag",
                 "include_snow"):
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        if r.dtype.kind == "f":
            close(g, r, LOOP_TOL, LOOP_TOL, name)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_calc_atmos_energy_bal():
    ins = draw(40, -300.0, 300.0)
    tair, dens, ra = draw(41, -20.0, 10.0), draw(42, 1.1, 1.4), \
        draw(43, 5.0, 200.0)
    ref = jca.calc_atmos_energy_bal(ins, tair, dens, ra)
    got = tca.calc_atmos_energy_bal(T(ins), T(tair), T(dens), T(ra))
    assert bool(np.asarray(ref.fbflag).any()) and not \
        bool(np.asarray(ref.fbflag).all())
    for name in ("tcanopy", "sensible", "error"):
        close(getattr(got, name), getattr(ref, name), ELEM_TOL, 1e-4, name)
    np.testing.assert_array_equal(got.fbflag.numpy(),
                                  np.asarray(ref.fbflag))


@pytest.mark.parametrize("it", [0, 3])
def test_canopy_air_step_is_the_close_energy_loop_body(it):
    """canopy_air_step_plain against vic_tpu's loop body (model.py:799-837)
    written out with its own calc_atmos_energy_bal."""
    x = dict(canopy_sensible=draw(50, -80.0, 80.0),
             soil_sensible=draw(51, -80.0, 80.0),
             pack_sensible=draw(52, -80.0, 80.0), cov_w=draw(53, 0.0, 1.0),
             tair=draw(54, -20.0, 0.0), air_dens=draw(55, 1.1, 1.4),
             ra_over=draw(56, 5.0, 200.0), tc=draw(57, -20.0, 0.0),
             tc_prev=draw(58, -20.0, 0.0), g_prev=draw(59, -1.0, 1.0))
    x["g_prev"][0, :3] = 0.0
    iter_mask = draw(60, 0.0, 1.0) < 0.6
    lane_mask = draw(61, 0.0, 1.0) < 0.9
    j = {k: jnp.asarray(v) for k, v in x.items()}
    under = j["soil_sensible"] + j["pack_sensible"] * j["cov_w"]
    ca = jca.calc_atmos_energy_bal(j["canopy_sensible"] + under, j["tair"],
                                   j["air_dens"], j["ra_over"])
    g = jnp.where(iter_mask, ca.tcanopy, j["tair"]) - j["tc"]
    denom = g - j["g_prev"]
    sec = g * (j["tc"] - j["tc_prev"]) / jnp.where(
        jnp.abs(denom) < 1e-12, 1.0, denom)
    damped = jnp.logical_or(it == 0, jnp.logical_or(
        jnp.abs(denom) < 1e-12, jnp.abs(sec) > 10.0))
    tc_next = j["tc"] - jnp.where(damped, -0.5 * g, sec)
    live = jnp.max(jnp.where(lane_mask, jnp.abs(tc_next - j["tc"]), 0.0))
    got = tca.canopy_air_step_plain(
        it=it, iter_mask=torch.tensor(iter_mask),
        lane_mask=torch.tensor(lane_mask), **{k: T(v) for k, v in x.items()})
    close(got[0], tc_next, ELEM_TOL, 1e-5, "tc_next")
    close(got[1], g, ELEM_TOL, 1e-5, "g")
    close(got[2], live, ELEM_TOL, 1e-5, "live_max")
    nan_tc = T(x["tc"]).clone()
    nan_tc[lane_mask.nonzero()[0][0], lane_mask.nonzero()[1][0]] = np.nan
    nan_live = tca.canopy_air_step_plain(
        it=it, iter_mask=torch.tensor(iter_mask),
        lane_mask=torch.tensor(lane_mask),
        **dict({k: T(v) for k, v in x.items()}, tc=nan_tc))[2]
    assert bool(torch.isnan(nan_live))       # a NaN keeps the loop going
