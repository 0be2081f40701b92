"""The port's lake model (vic_tpu_torch.physics.lake, ops.tridiag) against
vic_tpu's, function by function, on the CPU.

The states come from vic_tpu's own freeze -> snow-on-ice -> ice-out cycle
(tests/test_lake.py:166-200: 3 synthetic lakes, 30 cold daily steps, then
warm ones until the ice is out), so every branch the lake has is reached.
Each function gets its inputs from the port's solve_lake at a state of that
cycle (captured at its call) and runs through both packages from the very
same float32 values.

Tolerances: elementwise 1e-5; a function holding a Brent or fixed point
1e-4 with its converged flags equal; lake_step 1e-4. Two kinds of leaf are
held at a derived bound instead (ROADMAP.md queue 3):
- the storage-change residuals (delta_h, the energy and water errors),
  differences of float32 column sums of ~1e16 J and ~1e8 m^3: within
  LAKE_ENERGY_ULPS ulps of the column energy over (surface x dt), and
  within LAKE_WATER_ULPS ulps of the lake volume over the surface
  (vic_tpu_torch.testing);
- the convective mix near 4 C, where neighbouring layers' densities differ
  by about one float32 ulp and an ulp of difference in a temperature
  decides whether a pair mixes: a layer may differ from vic_tpu's only
  inside a run of adjacent layers whose densities lie within
  vic_tpu_torch.testing.LAKE_RHO_BAND of each other, and by no more than
  that run's temperature spread.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.lake as jl
from vic_tpu.config import GlobalParams
from vic_tpu.ops.tridiag import thomas_solve as j_thomas
from vic_tpu.testing import synthetic_domain
from vic_tpu_torch.ops.tridiag import thomas_solve
from vic_tpu_torch.physics import lake as tl
from vic_tpu_torch.prepare import lake_params_from_numpy
from vic_tpu_torch.testing import (LAKE_ENERGY_ULPS, LAKE_WATER_ULPS,
                                   mixed_column_excess)

torch.set_num_threads(1)

ELEM_TOL = 1e-5
FP_TOL = 1e-4
DT = 86400.0
N_COLD, N_WARM = 30, 60

WARM = dict(tair=12.0, sw=280.0, lw=360.0, vp=1000.0)
COLD = dict(tair=-15.0, sw=30.0, lw=180.0, vp=100.0, snow_mm=2.0)


def met(dom, n=3, *, tair, sw, lw, vp, snow_mm=0.0):
    """tests/test_lake.py's met_kwargs as numpy float32 arrays."""
    f = lambda v: np.full(n, v, np.float32)   # noqa: E731
    return dict(
        tair=f(tair), wind=f(3.0), sw_in=f(sw), lw_in=f(lw), vp_air=f(vp),
        vpd=f(100.0), pressure=f(95000.0), air_density=f(1.2),
        rainfall_mm=f(0.0), snowfall_mm=f(snow_mm), runoff_in_m3=f(500.0),
        baseflow_in_m3=f(100.0),
        lat=np.asarray(dom.soil.lat, np.float32),
        day_in_year=np.full(n, 30, np.int32), wind_h=f(10.0),
        snow_rough=f(0.03), new_snow_alb=f(0.85), alb_accum_a=f(0.94),
        alb_accum_b=f(0.58), alb_thaw_a=f(0.82), alb_thaw_b=f(0.46),
        ds=np.asarray(dom.soil.ds, np.float32),
        dsmax=np.asarray(dom.soil.dsmax, np.float32),
        ws_arno=np.asarray(dom.soil.ws, np.float32))


def jx(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)


def tt(tree):
    """numpy/jax leaves -> torch tensors (host scalars stay)."""
    def one(a):
        if isinstance(a, (np.ndarray, jax.Array)):
            return torch.tensor(np.asarray(a))
        return a
    return {k: one(v) for k, v in tree.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def t_state(st):
    return tl.LakeState(**{f.name: torch.tensor(np.asarray(getattr(st,
                                                                   f.name)))
                           for f in dataclasses.fields(st)})


def ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def assert_close(got, ref, tol, what):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "bi":
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                   err_msg=what)


def assert_mixed_column(got, ref, what):
    """Layer temperatures within FP_TOL of vic_tpu's but where a mix near
    4 C fell the other way (vic_tpu_torch.testing.mixed_column_excess)."""
    assert mixed_column_excess(to_np(got), to_np(ref), FP_TOL) == [], what


@functools.lru_cache(maxsize=None)
def cycle():
    """vic_tpu's lake states over the cycle, its step results and the
    forcing of each step; the port's parameters."""
    gp = GlobalParams(dt=24)
    dom = synthetic_domain(n_cell=3)
    lp_np = jl.make_lake_params(dom.soil, gp)
    lp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), lp_np)
    st = jl.initial_lake_state(lp, dom.soil.avg_temp)
    kw_c, kw_w = met(dom, **COLD), met(dom, **WARM)
    step = jax.jit(lambda s, kw: jl.lake_step(lp, s, dt_sec=DT, **kw))
    states, results, forcing = [], [], []
    for i in range(N_COLD + N_WARM):
        kw = kw_c if i < N_COLD else kw_w
        r = step(st, jx(kw))
        states.append(st)
        results.append(r)
        forcing.append(kw)
        st = r.state
        if i >= N_COLD and float(r.ice_fract.max()) == 0.0 \
                and float(st.swe.max()) == 0.0:
            break
    return dict(lp=lp, lp_t=lake_params_from_numpy(lp, "cpu"),
                states=states, results=results, forcing=forcing, dom=dom)


# the cycle's steps the function tests start from: open water freezing,
# partial ice, ice under snow, the thaw, the last warm step
PICKS = {"freeze": 0, "partial_ice": 2, "snow_on_ice": 20,
         "thaw": N_COLD + 1, "warm": -1}


@functools.lru_cache(maxsize=None)
def captured(pick):
    """The keyword arguments the port's solve_lake hands each kernel's
    plain version (and lake_ice_melt) at the cycle's step `pick`."""
    cyc = cycle()
    i = PICKS[pick]
    st, kw = cyc["states"][i], cyc["forcing"][i]
    calls = {}
    names = ("lake_open_water_plain", "water_under_ice_plain",
             "lake_ice_brent_plain", "lake_ice_melt",
             "depth_from_volume_plain")
    originals = {n: getattr(tl, n) for n in names}

    def wrap(name, fn):
        def w(*a, **k):
            calls.setdefault(name, (a, k))
            return fn(*a, **k)
        return w

    for n, fn in originals.items():
        setattr(tl, n, wrap(n, fn))
    try:
        res = tl.lake_step(cyc["lp_t"], t_state(st), dt_sec=DT, **tt(kw))
    finally:
        for n, fn in originals.items():
            setattr(tl, n, fn)
    return calls, res


def j_grid(grid):
    return jl.LayerGrid(*(jnp.asarray(to_np(x)) for x in grid))


def j_kwargs(kw):
    out = {}
    for k, v in kw.items():
        if isinstance(v, tl.LayerGrid):
            out[k] = j_grid(v)
        elif isinstance(v, torch.Tensor):
            out[k] = jnp.asarray(v.numpy())
        else:
            out[k] = v
    return out


# vic_tpu's functions compiled once for the shapes of the cycle
def _open_water(dt_sec, **kw):
    web = jl.water_energy_balance(dt_sec=dt_sec, **kw)
    return web, jl.tracer_mixer(web.temp, kw["grid"], jl.specheat(kw["temp"]))


_j_open_water = jax.jit(_open_water, static_argnames="dt_sec")
_j_under_ice = jax.jit(jl.water_under_ice, static_argnames="dt_sec")
_j_ice_melt = jax.jit(jl.lake_ice_melt,
                      static_argnames=("dt_sec", "max_iter"))
_j_solve_lake = jax.jit(functools.partial(jl.solve_lake, dt_sec=DT))


# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(20, 0), (7, 1), (1, 2)])
def test_thomas_solve_matches(n, seed):
    rng = np.random.default_rng(seed)
    shape = (16, n)
    dl = rng.uniform(-1, 0, shape).astype(np.float32)
    du = rng.uniform(-1, 0, shape).astype(np.float32)
    d = (2.5 + rng.uniform(0, 1, shape)).astype(np.float32)
    b = rng.uniform(-5, 5, shape).astype(np.float32)
    ref = np.asarray(j_thomas(*map(jnp.asarray, (dl, d, du, b))))
    got = thomas_solve(*map(torch.tensor, (dl, d, du, b)))
    assert_close(got, ref, ELEM_TOL, "thomas_solve")
    # and it solves the system
    x = got.numpy().astype(np.float64)
    ax = d * x
    ax[:, 1:] += dl[:, 1:] * x[:, :-1]
    ax[:, :-1] += du[:, :-1] * x[:, 1:]
    np.testing.assert_allclose(ax, b, atol=1e-4)


def test_geometry_matches():
    """area/volume/depth of the basin and the layer grid, on depths through
    the single-node, two-node and many-node ranges and exact multiples of
    the 0.6 m surface layer."""
    cyc = cycle()
    lp, lp_t = cyc["lp"], cyc["lp_t"]
    rng = np.random.default_rng(3)
    for depths in (np.float32([0.0, 0.15, 0.45]), np.float32([0.9, 1.2, 3.0]),
                   rng.uniform(0.0, 10.0, 3).astype(np.float32),
                   np.float32([6.0, 9.99, 10.0])):
        d_j, d_t = jnp.asarray(depths), torch.tensor(depths)
        assert_close(tl.area_from_depth(lp_t, d_t),
                     jl.area_from_depth(lp, d_j), ELEM_TOL, "area")
        vol = tl.volume_from_depth(lp_t, d_t)
        assert_close(vol, jl.volume_from_depth(lp, d_j), ELEM_TOL, "volume")
        assert_close(tl.depth_from_volume(lp_t, vol),
                     jl.depth_from_volume(lp, jnp.asarray(vol.numpy())),
                     ELEM_TOL, "depth")
        g_t, g_j = tl.make_grid(lp_t, d_t), jl.make_grid(lp, d_j)
        for name, a, b in zip(g_t._fields, g_t, g_j):
            assert_close(a, b, ELEM_TOL, f"grid.{name}")


@pytest.mark.parametrize("pick", list(PICKS))
def test_column_functions_match(pick):
    """eddy_diffusivity, temp_area, energycalc, iceform and tracer_mixer on
    the open-water column the port's solve_lake sets up."""
    calls, _ = captured(pick)
    kw = calls["lake_open_water_plain"][1]
    temp, grid = kw["temp"], kw["grid"]
    jtemp, jgrid = jnp.asarray(temp.numpy()), j_grid(grid)
    on = torch.ones_like(temp[..., 0], dtype=torch.bool)
    de = tl.eddy_diffusivity(on, kw["wind"], temp, kw["lat"], grid)
    jde = jl.eddy_diffusivity(jnp.asarray(on.numpy()),
                              jnp.asarray(kw["wind"].numpy()), jtemp,
                              jnp.asarray(kw["lat"].numpy()), jgrid)
    assert_close(de, jde, ELEM_TOL, "eddy_diffusivity")
    rho, cp = tl.water_density(temp), tl.specheat(temp)
    assert_close(rho, jl.water_density(jtemp), 0.0, "water_density")
    assert_close(cp, jl.specheat(jtemp), 0.0, "specheat")
    sw = kw["shortwave_net"]
    force = torch.full_like(sw, -40.0)
    got = tl.temp_area(sw * 0.7, sw * 0.3, force, temp, rho, de, DT, grid,
                       cp)
    ref = jl.temp_area(*(jnp.asarray(x.numpy()) for x in
                         (sw * 0.7, sw * 0.3, force, temp, rho, de)), DT,
                       jgrid, jnp.asarray(cp.numpy()))
    assert_close(got[0], ref[0], ELEM_TOL, "temp_area T")
    assert_close(got[2], ref[2], ELEM_TOL, "temp_area energy_out_bottom")
    e_bound = LAKE_ENERGY_ULPS * ulp(ref[1]).max()
    assert np.abs(to_np(got[1]) - np.asarray(ref[1])).max() <= e_bound
    cold = got[0] - 1.5
    icf = tl.iceform(cold, kw["tcutoff"], kw["fracprv"], DT, grid, cp,
                     kw["lvolume"])
    jicf = jl.iceform(jnp.asarray(cold.numpy()),
                      jnp.asarray(kw["tcutoff"].numpy()),
                      jnp.asarray(kw["fracprv"].numpy()), DT, jgrid,
                      jnp.asarray(cp.numpy()),
                      jnp.asarray(kw["lvolume"].numpy()))
    for name, a, b in zip(icf._fields, icf, jicf):
        assert_close(a, b, FP_TOL, f"iceform.{name}")
    # an unstable column: warm water under the cold surface
    unstable = temp.flip(-1)
    assert_mixed_column(tl.tracer_mixer(unstable, grid, cp),
                        jl.tracer_mixer(jnp.asarray(unstable.numpy()), jgrid,
                                        jnp.asarray(cp.numpy())),
                        "tracer_mixer")


def _assert_delta_h(got, ref, energy, surface, what):
    bound = LAKE_ENERGY_ULPS * ulp(energy) / np.maximum(
        to_np(surface) * DT, 1e-12)
    assert (np.abs(to_np(got) - to_np(ref)) <= bound + FP_TOL).all(), what


@pytest.mark.parametrize("pick", list(PICKS))
def test_water_energy_balance_matches(pick):
    """The open-water fixed point and its mix (K10's plain version)."""
    calls, _ = captured(pick)
    kw = calls["lake_open_water_plain"][1]
    web, t_open = tl.lake_open_water_plain(**kw)
    jkw = j_kwargs(kw)
    jweb, jt_open = _j_open_water(**jkw)
    assert_close(web.converged, jweb.converged, 0, "converged")
    energy = jl.energycalc(jkw["temp"], jkw["grid"], jl.specheat(jkw["temp"]),
                           jl.water_density(jkw["temp"]))
    for name, a, b in zip(web._fields, web, jweb):
        if name == "delta_h":
            _assert_delta_h(a, b, energy, kw["grid"].surface[..., 0], name)
        elif name == "temp":
            assert_mixed_column(a, b, name)
        elif name != "converged":
            assert_close(a, b, FP_TOL, name)
    assert_mixed_column(t_open, jt_open, "t_open")


@pytest.mark.parametrize("pick", list(PICKS))
def test_water_under_ice_matches(pick):
    """The under-ice qw fixed point (K11's plain version)."""
    calls, _ = captured(pick)
    kw = calls["water_under_ice_plain"][1]
    got = tl.water_under_ice_plain(**kw)
    jkw = j_kwargs(kw)
    ref = _j_under_ice(**jkw)
    assert_close(got.converged, ref.converged, 0, "converged")
    energy = jl.energycalc(jkw["temp"], jkw["grid"], jl.specheat(jkw["temp"]),
                           jl.water_density(jkw["temp"]))
    assert_mixed_column(got.temp, ref.temp, "temp")
    assert_close(got.qw, ref.qw, FP_TOL, "qw")
    assert_close(got.energy_out_bottom, ref.energy_out_bottom, FP_TOL,
                 "energy_out_bottom")
    _assert_delta_h(got.delta_h, ref.delta_h, energy,
                    kw["grid"].surface[..., 0], "delta_h")


@pytest.mark.parametrize("pick", list(PICKS))
def test_lake_ice_melt_matches(pick):
    """Snow over lake ice with its Brent solve (K12's plain version)."""
    calls, _ = captured(pick)
    kw = calls["lake_ice_melt"][1]
    got = tl.lake_ice_melt(**kw)
    ref = _j_ice_melt(**j_kwargs(kw))
    assert_close(got.surf_temp_fbflag, ref.surf_temp_fbflag, 0, "fbflag")
    for name, a, b in zip(got._fields, got, ref):
        if name == "terms":
            for tname, x, y in zip(a._fields, a, b):
                assert_close(x, y, FP_TOL, f"terms.{tname}")
        else:
            assert_close(a, b, FP_TOL, name)


def test_lake_ice_brent_is_reached():
    """The cycle's snow-on-ice step brackets and converges the ice Brent,
    and the plain Brent's roots match vic_tpu's batched_brent on the same
    residual within its final bracket."""
    from vic_tpu.ops.rootfind import batched_brent as j_brent
    calls, _ = captured("snow_on_ice")
    a, kw = calls["lake_ice_brent_plain"]
    got = tl.lake_ice_brent_plain(*a, **kw)
    dt = kw.pop("dt")
    kw.pop("max_tries")
    max_iter = kw.pop("max_iter")
    jkw = j_kwargs(kw)
    ref = j_brent(lambda t: jl.ice_energy_terms(t, dt_sec=dt, **jkw).rest,
                  *(jnp.asarray(x.numpy()) for x in a[:2]), max_iter=max_iter,
                  active=jnp.asarray(a[2].numpy()))
    assert bool(got.bracketed.any()) and bool(got.converged.any())
    assert_close(got.converged, ref.converged, 0, "converged")
    both = got.converged.numpy() & np.asarray(ref.converged)
    diff = np.abs(got.root.numpy() - np.asarray(ref.root))[both]
    assert (diff <= 2 * (2 * 1.2e-7 * np.abs(np.asarray(ref.root))[both]
                         + 1e-4)).all()


def test_lakeice_and_colavg_match():
    cyc = cycle()
    rng = np.random.default_rng(5)
    n = 8
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    args = dict(sw_ice=f(0, 200), fracprv=f(0.02, 1), snowflux=f(-60, 20),
                qw=f(-5, 30), sw_absorbed=f(0, 50), ice_water_eq=f(0, 5e6),
                volume=f(1e7, 5e7), sarea=f(1e6, 1.2e7))
    got = tl.lakeice(dt_sec=DT, **{k: torch.tensor(v) for k, v in
                                   args.items()})
    ref = jl.lakeice(dt_sec=DT, **{k: jnp.asarray(v) for k, v in
                                   args.items()})
    for name, a, b in zip(got._fields, got, ref):
        assert_close(a, b, ELEM_TOL, name)
    grid = tl.make_grid(cyc["lp_t"], torch.tensor(np.float32([0.4, 3.3, 9])))
    t_open = torch.tensor(rng.uniform(0, 12, (3, 20)).astype(np.float32))
    t_ice = torch.tensor(rng.uniform(0, 4, (3, 20)).astype(np.float32))
    fr = torch.tensor(np.float32([0.0, 0.5, 1.0]))
    assert_close(tl.colavg(t_open, t_ice, fr, grid),
                 jl.colavg(*(jnp.asarray(x.numpy()) for x in
                             (t_open, t_ice, fr)), j_grid(grid)),
                 ELEM_TOL, "colavg")


def _assert_step(got, ref, what):
    """A LakeStepResult (or its state) against vic_tpu's."""
    for name, a, b in zip(got._fields, got, ref):
        if name == "state":
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if f.name == "temp":
                    assert_mixed_column(x, y, f"{what} state.temp")
                else:
                    assert_close(x, y, FP_TOL, f"{what} state.{f.name}")
        elif a is None:
            assert b is None
        elif name in ("energy_error", "delta_h"):
            vol = np.asarray(ref.state.volume, np.float64)
            energy = vol * 1000.0 * 4220.0 * 300.0
            _assert_delta_h(a, b, energy, np.maximum(
                np.asarray(ref.sarea), 1.0), f"{what} {name}")
        elif name == "water_error_mm":
            bound = LAKE_WATER_ULPS * ulp(ref.state.volume) / np.maximum(
                np.asarray(ref.sarea), 1.0) * 1000.0
            assert (np.abs(to_np(a) - np.asarray(b)) <= bound + FP_TOL).all()
        else:
            assert_close(a, b, FP_TOL, f"{what} {name}")


@pytest.mark.parametrize("pick", list(PICKS))
def test_solve_lake_matches(pick):
    cyc = cycle()
    i = PICKS[pick]
    st, kw = cyc["states"][i], dict(cyc["forcing"][i])
    for k in ("runoff_in_m3", "baseflow_in_m3", "ds", "dsmax", "ws_arno"):
        kw.pop(k)
    kw["vp"] = kw.pop("vp_air")
    active = np.ones(3, bool)
    got = tl.solve_lake(cyc["lp_t"], t_state(st), dt_sec=DT,
                        active=torch.tensor(active), **tt(kw))
    ref = _j_solve_lake(cyc["lp"], st, active=jnp.asarray(active), **jx(kw))
    _assert_step(got, ref, f"solve_lake {pick}")


def test_lake_step_through_the_ice_cycle():
    """Every step of the freeze -> snow-on-ice -> ice-out cycle from
    vic_tpu's state: the port's step matches vic_tpu's, and the cycle
    reaches each branch (full ice, snow over it, the ice out)."""
    cyc = cycle()
    assert len(cyc["states"]) < N_COLD + N_WARM, "the ice never went out"
    ice = np.array([float(r.ice_fract.min()) for r in cyc["results"]])
    assert ice[:N_COLD].max() > 0.9
    assert float(cyc["results"][N_COLD - 1].state.swe.min()) > 0.01
    worst = 0.0
    for st, kw, ref in zip(cyc["states"], cyc["forcing"], cyc["results"]):
        got = tl.lake_step(cyc["lp_t"], t_state(st), dt_sec=DT, **tt(kw))
        _assert_step(got, ref, "lake_step")
        worst = max(worst, float(got.water_error_mm.abs().max()))
    assert worst <= 1e-2


def test_initial_lake_state_matches():
    cyc = cycle()
    dom = cyc["dom"]
    got = tl.initial_lake_state(cyc["lp_t"],
                                torch.tensor(dom.soil.avg_temp,
                                             dtype=torch.float32))
    ref = jl.initial_lake_state(cyc["lp"], dom.soil.avg_temp)
    for f in dataclasses.fields(ref):
        assert_close(getattr(got, f.name), getattr(ref, f.name), 0.0, f.name)


def test_plain_and_dispatch_on_cpu():
    """On CPU tensors the call sites take the plain versions and launch
    nothing."""
    from vic_tpu_torch import kernels
    kernels.reset_launches()
    captured.cache_clear()
    calls, _ = captured("snow_on_ice")
    assert set(calls) >= {"lake_open_water_plain", "water_under_ice_plain",
                          "lake_ice_brent_plain", "depth_from_volume_plain"}
    assert all(v == 0 for v in kernels.launches.values())
    lp = SimpleNamespace(z=cycle()["lp_t"].z, basin=cycle()["lp_t"].basin,
                         maxdepth=cycle()["lp_t"].maxdepth)
    vol = torch.tensor(np.float32([0.0, 1e7, 5e7]))
    assert torch.equal(tl.depth_from_volume(lp, vol),
                       tl.depth_from_volume_plain(lp, vol))
