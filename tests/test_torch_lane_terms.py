"""The energy terms K5 (surface_brent) and K2 (snowpack_brent) hand back,
through their plain versions, against vic_tpu, and the kernels' lane tables
and outputs by name and row (each kernel against its plain version on the
card: tests/test_torch_kernels.py, which runs without JAX).

- K2's plain version (`snow.snowpack_brent_plain`): the terms at 0 C, the
  melt test, the Brent's root and flags and the terms at the accepted
  temperature, against vic_tpu's `snow_energy_terms` at 0 C and at the root
  of vic_tpu's own Brent on the same lanes, on the arguments the port's step
  hands it in light's first record, blowing_close's fourth (a blowing-snow
  flux) and spatial_snow's second (fractional coverage, packs melting at
  0 C).
- K5's plain version (`surface.surface_brent_plain`, through
  `solve_surface_temperature`): the root and the terms at it against
  vic_tpu's `solve_surface_temperature` and its `surf_energy_terms` at
  vic_tpu's root, on light's, frozen_quick's (the fusion term),
  spatial_snow's and dist_prcp's (the dry column) arguments.

Tolerances: each terms field at rtol 1e-4 and its unit's atol
(vic_tpu_torch.testing.terms_atol: 1e-4 W/m^2 or C, water depths 1e-8 m of
water, the residual at the root, K5's error and K2's rest, 1e-3 W/m^2 as
ROADMAP.md queue 3's leaf: ~0 by construction, it moves by the residual's
slope times a few ulps of the root), roots within 1e-4 C, flags and melt
tests equal.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.snow as j_snow
import vic_tpu.physics.surface as j_surface
import vic_tpu_torch.physics.snow as t_snow
import vic_tpu_torch.physics.surface as t_surface
from vic_tpu.ops.rootfind import batched_brent as j_batched_brent
from vic_tpu_torch import constants as c
from vic_tpu_torch import kernels, model
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.kernels import build
from vic_tpu_torch.testing import TERMS_RTOL, terms_atol

torch.set_num_threads(1)

N_CELL = 4
TOL = 1e-4
ROOT_TOL = 1e-4
# configuration -> the record whose step gives the arguments
SNOW_CASES = {"light": 0, "blowing_close": 3, "spatial_snow": 1}
SURFACE_CASES = {"light": 0, "frozen_quick": 1, "spatial_snow": 1,
                 "dist_prcp": 2}


def to_j(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, dict):
        return {k: to_j(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_j(v) for v in x)
    return x


@functools.lru_cache(maxsize=None)
def captured(config, record, home, name):
    """(args, kwargs) of the first call of `home`.`name` in the port's CPU
    step of `config`'s record `record`."""
    module = {"model": model, "snow": t_snow}[home]
    gp, params, stack, state, extras = CONFIGS[config](N_CELL, record + 1,
                                                       "cpu")
    step = model.make_step(params, gp, **extras)
    for r in range(record):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    calls = []
    orig = getattr(module, name)

    def wrapper(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, wrapper)
    try:
        step(state, {k: v[record] for k, v in stack.items()})
    finally:
        setattr(module, name, orig)
    return calls[0]


def close(got, ref, name, atol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.broadcast_to(np.asarray(ref), got.shape)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=atol, err_msg=name)


def close_terms(got, ref, residual, label):
    """Every tensor field of the port's terms against vic_tpu's field of
    the same name, at TERMS_RTOL and the field's own atol."""
    n = 0
    for field in got._fields:
        g = getattr(got, field)
        if not isinstance(g, torch.Tensor):
            continue
        g = g.numpy()
        np.testing.assert_allclose(
            g, np.broadcast_to(np.asarray(getattr(ref, field)), g.shape),
            rtol=TERMS_RTOL, atol=terms_atol(field, residual),
            err_msg=f"{label}: {field}")
        n += 1
    assert n >= len(ref._fields) - 7, label


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("config", sorted(SNOW_CASES))
def test_snowpack_brent_plain_matches_vic_tpu(config):
    """The terms at 0 C, the melt test, the root and flags on the lanes it
    solves, and the terms at the accepted temperature, against vic_tpu's
    snow_energy_terms and Brent on the same arguments."""
    (lo, hi, active), kw = captured(config, SNOW_CASES[config], "snow",
                                    "snowpack_brent_plain")
    got = t_snow.snowpack_brent_plain(lo, hi, active, **kw)

    inputs = {k: v for k, v in kw.items() if k not in ("max_iter",
                                                       "max_tries")}
    jin = dict(to_j(inputs), displacement=jnp.zeros(tuple(lo.shape)))

    def terms(t):
        return j_snow.snow_energy_terms(t, **jin)

    terms0 = terms(jnp.zeros(tuple(lo.shape)))
    melt = terms0.rest == 0.0
    thin = ~melt & (jin["surface_swq"] <= c.MIN_SWQ_EB_THRES)
    solved = ~melt & ~thin & to_j(active)
    res = j_batched_brent(lambda t: terms(t).rest, to_j(lo), to_j(hi),
                          max_iter=kw["max_iter"], max_tries=kw["max_tries"],
                          active=solved)
    np.testing.assert_array_equal(got.melt_cond.numpy(), np.asarray(melt))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(res.converged))
    np.testing.assert_array_equal(got.bracketed.numpy(),
                                  np.asarray(res.bracketed))
    close(got.root, res.root, "root", ROOT_TOL)
    close_terms(got.terms0, terms0, "rest", f"{config} at 0 C")
    b = jnp.where(res.converged, res.root, jin["old_tsurf"])
    close_terms(got.terms_b, terms(b), "rest", f"{config} at the root")
    assert bool(got.bracketed.any())


def test_snow_cases_reach_the_melt_test_and_the_blowing_flux():
    """spatial_snow's packs melt at 0 C on some lanes and are solved on
    others; blowing_close's residual carries a blowing-snow flux."""
    (lo, hi, active), kw = captured("spatial_snow", 1, "snow",
                                    "snowpack_brent_plain")
    got = t_snow.snowpack_brent_plain(lo, hi, active, **kw)
    assert bool(got.melt_cond.any()) and bool(got.bracketed.any())
    _, kw = captured("blowing_close", 3, "snow", "snowpack_brent_plain")
    assert bool((kw["blowing_flux"] != 0.0).any())


# ------------------------------------------------------------------- K5
def jax_surface_kwargs(k):
    """vic_tpu's surf_energy_terms keywords from the port's: zeros for the
    canopy geometry vic_tpu also takes, and without FROZEN_SOIL for the
    fusion inputs it never reads."""
    j = to_j(k)
    lanes = tuple(k["vpd"].shape)
    zeros = jnp.zeros(lanes)
    j["inc_terms"] = dict(j["inc_terms"])
    j["inc_terms"].setdefault("blowing_flux", zeros)
    if not k.get("frozen_soil"):
        j.update(moist0_vol=zeros, max_moist0_vol=zeros + 0.4,
                 ice0_vol=zeros, bubble0=zeros + 10.0, expt0=zeros + 10.0,
                 fs_active=jnp.zeros(lanes, bool))
    j.update(displacement_canopy=zeros, roughness_canopy=zeros,
             ref_height_canopy=zeros)
    return j


@pytest.mark.parametrize("config", sorted(SURFACE_CASES))
def test_surface_brent_plain_terms_match_vic_tpu(config):
    """The root, its fallback flag and the terms at it against vic_tpu's
    solve_surface_temperature and surf_energy_terms at vic_tpu's root."""
    (eb, t0_old, tair), k = captured(config, SURFACE_CASES[config], "model",
                                     "solve_surface_temperature")
    ts, fb, fd_interp, terms = t_surface.solve_surface_temperature(
        eb, t0_old, tair, **k)
    assert fd_interp is None
    jkw = jax_surface_kwargs(eb)
    j_ts, j_fb, _ = j_surface.solve_surface_temperature(
        jkw, to_j(t0_old), to_j(tair), True, max_iter=k["max_iter"],
        active=to_j(k["active"]))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(j_fb))
    close(ts, j_ts, "ts", ROOT_TOL)
    close_terms(terms, j_surface.surf_energy_terms(j_ts, **jkw), "error",
                config)
    # the terms at the port's own root are the step's arithmetic
    again = t_surface.surf_energy_terms(ts, **eb)
    for field in terms._fields:
        a, b = getattr(terms, field), getattr(again, field)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), field


def test_surface_cases_reach_their_forms():
    """frozen_quick's residual carries the fusion term on lanes with
    top-layer ice, dist_prcp's the dry column on lanes with mu < 1, and
    spatial_snow's fractional coverage."""
    (eb, _, _), k = captured("frozen_quick", 1, "model",
                             "solve_surface_temperature")
    assert eb["frozen_soil"] and bool((eb["ice0_vol"] > 0).any())
    (eb, _, _), _ = captured("dist_prcp", 2, "model",
                             "solve_surface_temperature")
    assert eb["dist_dry"] is not None and bool((eb["mu_wet"] < 1.0).any())
    (eb, _, _), _ = captured("spatial_snow", 1, "model",
                             "solve_surface_temperature")
    cov = eb["snow_coverage"]
    assert bool(((cov > 0.0) & (cov < 1.0)).any())


def test_cpu_step_evaluates_the_quick_flux_terms_once():
    """On the QUICK_FLUX path the step takes the terms at the root from the
    solve (the plain version on the CPU, K5 on the card) and makes no
    surf_energy_terms call of its own."""
    gp, params, stack, state, extras = CONFIGS["light"](2, 1, "cpu")
    step = model.make_step(params, gp, **extras)
    calls = []
    orig = model.surf_energy_terms
    model.surf_energy_terms = lambda *a, **k: (calls.append(1),
                                               orig(*a, **k))[1]
    try:
        step(state, {k: v[0] for k, v in stack.items()})
    finally:
        model.surf_energy_terms = orig
    assert not calls


# -------------------------------------- the terms rule against planted faults
def _planted(fault):
    """(terms, the same terms with a fault a kernel could carry, the
    residual's field, whether the fault stays within 1e-4 m everywhere)
    on the port's plain terms at its own root."""
    if fault == "inc_vapor_flux over water density":
        (eb, t0, tair), k = captured("light", 0, "model",
                                     "solve_surface_temperature")
        terms = t_surface.solve_surface_temperature(eb, t0, tair, **k)[3]
        bad = terms.inc_vapor_flux * c.ICE_DENSITY / c.RHO_W
        return terms, terms._replace(inc_vapor_flux=bad), "error", False
    config = "blowing_close" if "blowing" in fault else "light"
    (lo, hi, active), kw = captured(config, SNOW_CASES[config], "snow",
                                    "snowpack_brent_plain")
    terms = t_snow.snowpack_brent_plain(lo, hi, active, **kw).terms_b
    vf = terms.vapor_flux
    if "blowing" in fault:
        bad = vf - kw["blowing_flux"] * kw["dt"] / c.RHO_W
    else:
        bad = torch.where(vf.abs() < 1e-3, vf * c.RHO_W / c.ICE_DENSITY, vf)
    return terms, terms._replace(vapor_flux=bad), "rest", True


@pytest.mark.parametrize("fault", [
    "vapor_flux over ice density on lanes under 1e-3 m",
    "vapor_flux without the blowing flux",
    "inc_vapor_flux over water density"])
def test_terms_rule_fails_planted_water_faults(fault):
    """The water fluxes K2 and K5 write (m a step) are held in their own
    unit: K2's vapor flux divided by ice density where it should be water
    density on the lanes under 1e-3 m, or written without its blowing-snow
    flux, and K5's snow vapour flux divided by water density where it
    should be ice density, each fail the rule that holds the kernels'
    terms (the first two lie within 1e-4 m, an atol that held every field
    in one unit)."""
    good, bad, residual, small = _planted(fault)
    close_terms(good, good, residual, fault)
    field = "inc_vapor_flux" if fault.startswith("inc") else "vapor_flux"
    diff = (getattr(bad, field) - getattr(good, field)).abs()
    assert float(diff.max()) > 0.0
    assert (float(diff.max()) < 1e-4) == small
    with pytest.raises(AssertionError, match=field):
        close_terms(bad, good, residual, fault)


# ------------------------------------------------- lane tables and outputs
def _enum(src, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def _camel(name):
    return "k" + "".join(w[:1].upper() + w[1:] for w in name.split("_"))


def test_surface_terms_are_the_kernels_rows():
    """K5 writes kernels.SURFACE_TERMS and, with DIST_PRCP,
    SURFACE_DRY_TERMS, in csrc/surface_brent.cu's Term and DryTerm order;
    with layer_evap, layer_evap_dry and its input net_short_bare they are
    every field of SurfEBResult but the finite-difference profile's; its
    lane table ends with SURFACE_BOUNDS (BoundIn)."""
    src = (build.CSRC / "surface_brent.cu").read_text()
    assert _enum(src, "Term") == [_camel(k) for k in kernels.SURFACE_TERMS] \
        + ["kNumTerms"]
    assert _enum(src, "DryTerm") == [
        _camel(k) for k in kernels.SURFACE_DRY_TERMS] + ["kNumDryTerms"]
    assert _enum(src, "BoundIn") == [
        _camel(k + "_in") for k in kernels.SURFACE_BOUNDS] + ["kNumBoundIn"]
    written = set(kernels.SURFACE_TERMS + kernels.SURFACE_DRY_TERMS) | {
        "layer_evap", "layer_evap_dry", "net_short_bare"}
    assert written == set(t_surface.SurfEBResult._fields) - {
        "t_nodes", "node_fbcount"}
    assert re.search(r"fill_lane_inputs\(&in, lanes, nf, kBoundIn \+ "
                     r"kNumBoundIn, nm,\s*kNumSurfaceMask \+ 1, h\)", src)


def test_snowpack_terms_are_the_kernels_rows():
    """K2 writes snow.SnowEBTerms' fields at 0 C and at the root in
    csrc/vic_kernels.cu's SnowTerm order, and its residual's terms() forms
    each of them (csrc/pack_residuals.cuh SnowTerms)."""
    k2 = (build.CSRC / "vic_kernels.cu").read_text()
    assert _enum(k2, "SnowTerm") == [
        _camel(k) for k in t_snow.SnowEBTerms._fields] + ["kNumSnowTerms"]
    res = (build.CSRC / "pack_residuals.cuh").read_text()
    body = re.search(r"struct SnowTerms \{\s*float([^;]*);", res).group(1)
    assert len([w for w in body.split(",") if w.strip()]) == \
        len(t_snow.SnowEBTerms._fields)


@pytest.mark.parametrize("floats,flags", [(0, 0), (22, 1), (23, 0)])
def test_lane_outputs_are_slices_of_one_allocation(floats, flags):
    """K2's and K5's outputs (the Brent's four, their terms, K2's melt
    test) share one allocation without overlap, each of its dtype, the
    floats 4-byte aligned."""
    shape, dev = (5, 3), torch.device("cpu")
    root, flat, extra = kernels._lane_outputs(shape, dev, floats=floats,
                                              flags=flags)
    assert [t.dtype for t in root] == [torch.float32, torch.bool,
                                       torch.bool, torch.int32]
    assert flat.dtype == torch.float32 and flat.numel() == floats * 15
    assert extra.shape == (flags,) + shape and extra.dtype == torch.bool
    parts = list(root) + [flat, extra]
    base = root.root.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in parts)
    spans = sorted((t.data_ptr() - base, t.numel() * t.element_size())
                   for t in parts if t.numel())
    assert spans[0][0] == 0 and all(
        a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert flat.data_ptr() % 4 == 0 and root.iterations.data_ptr() % 4 == 0


def test_surface_and_snowpack_wrappers_refuse_cpu_tensors():
    t = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.surface_brent(t, t, t > 0, max_iter=60, eb_kwargs={})
    with pytest.raises(ValueError, match="CUDA"):
        kernels.snowpack_brent(t, t, None, dt=86400.0, max_iter=60,
                               max_tries=5)
