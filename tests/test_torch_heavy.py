"""The heavy path's new functions in the port against vic_tpu's.

Inputs are made from a seed with numpy, or captured from the port's own
heavy_nolakes step on the CPU (4 cells, its fourth 3-hourly record: a
CLOSE_ENERGY pass on frozen finite-difference nodes with DIST_PRCP's dry
column), and handed to both packages as the same float32 bits:

- the DIST_PRCP storm transfers and their two halves, rtol = atol = 1e-5;
- the water-table curves, equal in float64, and their lookup at 1e-5;
- surf_energy_terms on the affine two-probe profile with the dry column at
  1e-5;
- solve_surface_temperature(fd_affine=True) with frozen nodes: roots at
  1e-4, converged flags equal, the probe profiles it returns at 1e-4 (each a
  node sweep).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.config import GlobalParams
from vic_tpu.physics import dist_prcp as jdist
from vic_tpu.physics import evap as jevap
from vic_tpu.physics import frozen_soil as jfs
from vic_tpu.physics import hydrology_misc as jhyd
from vic_tpu.physics import surface as jsurface
from vic_tpu.prepare import prepare_domain as jax_prepare_domain
from vic_tpu.testing import synthetic_domain as jax_synthetic_domain
from vic_tpu_torch import model
from vic_tpu_torch.entry import build_heavy_nolakes
from vic_tpu_torch.physics import dist_prcp as tdist
from vic_tpu_torch.physics import frozen_soil as tfs
from vic_tpu_torch.physics import hydrology_misc as thyd
from vic_tpu_torch.physics import surface as tsurface
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

N_CELL, MAX_HRU, NL = 4, 8, 3
DT_SEC = 3 * 3600.0
ELEM_TOL = 1e-5
BRENT_TOL = 1e-4
RECORD = 3          # the record whose step the residual's inputs come from
JAX_GP = GlobalParams(dt=3, snow_step=3, nlayer=NL, nnode=5,
                      quick_flux=False, frozen_soil=True, implicit=True,
                      soil_sweep_maxiter=10)


def close(got, ref, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def seeded(seed, *shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---- DIST_PRCP storm transfers ----

def transfer_inputs(seed):
    """wet/dry columns, their cap, old and new wet fractions (some at 1,
    some shrinking, some growing) and the two masks."""
    shape = (N_CELL, MAX_HRU, NL)
    wet = seeded(seed, *shape, lo=10.0, hi=300.0)
    dry = seeded(seed + 1, *shape, lo=10.0, hi=300.0)
    cap = seeded(seed + 2, N_CELL, 1, NL, lo=200.0, hi=320.0)
    mu_old = seeded(seed + 3, N_CELL, MAX_HRU, 1, lo=0.05, hi=1.0)
    mu_new = seeded(seed + 4, N_CELL, MAX_HRU, 1, lo=0.05, hi=1.0)
    mu_new[:, :2] = 1.0
    mu_old[:, 2] = mu_new[:, 2]
    rng = np.random.default_rng(seed + 5)
    avg = rng.random((N_CELL, MAX_HRU, 1)) < 0.3
    redist = ~avg & (rng.random((N_CELL, MAX_HRU, 1)) < 0.6)
    return wet, dry, cap, mu_old, mu_new, avg, redist


@pytest.mark.parametrize("seed", [0, 7])
def test_storm_transfers_match(seed):
    wet, dry, cap, mu_old, mu_new, avg, redist = transfer_inputs(seed)
    T = [torch.tensor(x) for x in (wet, dry, cap, mu_old, mu_new, avg,
                                   redist)]
    J = [jnp.asarray(x) for x in (wet, dry, cap, mu_old, mu_new, avg,
                                  redist)]
    for got, ref in zip(tdist.average_for_storm(T[0], T[1], T[3]),
                        jdist.average_for_storm(J[0], J[1], J[3])):
        close(got, ref, ELEM_TOL, "average_for_storm")
    for got, ref in zip(tdist.redistribute_for_storm(*T[:5]),
                        jdist.redistribute_for_storm(*J[:5])):
        close(got, ref, ELEM_TOL, "redistribute_for_storm")
    for got, ref in zip(tdist.storm_transfer(*T), jdist.storm_transfer(*J)):
        close(got, ref, ELEM_TOL, "storm_transfer")


# ---- water table ----

def test_zwt_curves_equal_in_float64():
    ref = jhyd.build_zwt_curves(jax_synthetic_domain(
        n_cell=N_CELL, n_band=2, with_glacier=True).soil)
    got = thyd.build_zwt_curves(synthetic_domain(
        n_cell=N_CELL, n_band=2, with_glacier=True).soil)
    assert sorted(got) == sorted(ref) == ["moist", "zwt"]
    for k in ref:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_compute_zwt_matches():
    """Per-layer, lumped and whole-column lookups on the curves cast to
    float32, with moistures above the wettest and below the driest point."""
    soil = synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True).soil
    curves = thyd.zwt_curves_to(thyd.build_zwt_curves(soil), "cpu")
    cm = curves["moist"][:, None].numpy()
    cz = curves["zwt"][:, None].numpy()
    lo, hi = cm.min(-1), cm.max(-1)
    frac = seeded(3, N_CELL, MAX_HRU, NL + 2, lo=-0.2, hi=1.2)
    moist = (lo + frac * (hi - lo)).astype(np.float32)
    for sl, m in ((slice(0, NL), moist[..., :NL]), (NL, moist[..., NL]),
                  (NL + 1, moist[..., NL + 1])):
        got = thyd.compute_zwt(torch.tensor(m), torch.tensor(cz[:, :, sl]),
                               torch.tensor(cm[:, :, sl]))
        ref = jhyd.compute_zwt(jnp.asarray(m), jnp.asarray(cz[:, :, sl]),
                               jnp.asarray(cm[:, :, sl]))
        close(got, ref, ELEM_TOL, f"compute_zwt {sl}")


# ---- the surface balance of a CLOSE_ENERGY pass on frozen nodes ----

@functools.lru_cache(maxsize=None)
def affine_call():
    """(args, keyword arguments) of the first solve_surface_temperature
    call with fd_affine in the port's heavy step, record RECORD, and the
    node sweep's arguments of that step (t0, kappa, cs, moist, ice0)."""
    gp, params, stack, state, extras = build_heavy_nolakes(N_CELL,
                                                           RECORD + 1, "cpu")
    step = model.make_step(params, gp, **extras)
    for r in range(RECORD):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    calls, sweeps = [], []
    orig_solve = model.solve_surface_temperature
    orig_sweep = tfs.solve_t_profile_explicit_plain

    def solve(*a, **k):
        if k.get("fd_affine"):
            calls.append((a, k))
        return orig_solve(*a, **k)

    def sweep(*a, **k):
        sweeps.append(a)
        return orig_sweep(*a, **k)

    model.solve_surface_temperature = solve
    tfs.solve_t_profile_explicit_plain = sweep
    try:
        step(state, {k: v[RECORD] for k, v in stack.items()})
    finally:
        model.solve_surface_temperature = orig_solve
        tfs.solve_t_profile_explicit_plain = orig_sweep
    t0, _, kappa, cs, moist, ice0 = sweeps[0][:6]
    return calls[0], (t0, kappa, cs, moist, ice0)


@functools.lru_cache(maxsize=None)
def jax_setup():
    jdom = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    return jax_prepare_domain(jdom, JAX_GP), jfs.build_node_geometry(
        jdom.soil, JAX_GP)


def J(x):
    if isinstance(x, dict):
        return {k: J(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(J(v) for v in x)
    return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x


def jax_kwargs(kw):
    """vic_tpu's surf_energy_terms keywords from the port's, with its own
    node sweep on the same node inputs and its own evap precomputations of
    the wet and the dry column."""
    jparams, jgeom = jax_setup()
    t0, kappa, cs, moist, ice0 = (jnp.asarray(a.numpy())
                                  for a in affine_call()[1])

    def jfd_solve(ts):
        return jfs.solve_t_profile_explicit(
            t0, ts, kappa, cs, moist, ice0, jgeom, jparams, DT_SEC,
            noflux=False, exp_trans=False, frozen=True, max_sweeps=10,
            ice_quirk=True)

    skip = ("fd_solve", "fd_interp", "evap_pre", "evap_pre_dry")
    jkw = {k: J(v) for k, v in kw.items() if k not in skip}

    def pre(moist_l, ice_l):
        return jevap.build_evap_pre(
            moist_l, ice_l, jkw["wcr"], jkw["wpwp"], jkw["root"],
            jkw["max_moist_l"][..., 0], jkw["b_infilt"], jkw["rmin"],
            jkw["rgl"], jkw["lai"], jkw["shortwave_net_bare"], jkw["vpd"],
            jkw["tair"], jkw["elevation"])

    zeros = jnp.zeros_like(jkw["ts_old"])
    jkw.update(evap_pre=pre(jkw["moist_l"], jkw["ice_l"]),
               evap_pre_dry=pre(jkw["dist_dry"]["moist_l"],
                                jkw["dist_dry"]["ice_l"]),
               displacement_canopy=zeros, roughness_canopy=zeros,
               ref_height_canopy=zeros, fd_solve=jfd_solve)
    return jkw


def test_captured_pass_reaches_the_heavy_branches():
    """The captured pass has frozen top nodes, node ice, a dry column on a
    wet fraction mu < 1 and a blowing-snow flux in its INCLUDE_SNOW fold."""
    (a, kw), _ = affine_call()
    eb = a[0]
    assert eb["frozen_soil"] and float(eb["ice0_vol"].max()) > 0.0
    assert eb["dist_dry"] is not None and float(eb["mu_wet"].min()) < 1.0
    assert kw["fd_affine"] and eb["fd_solve"] is not None
    assert float(eb["inc_terms"]["blowing_flux"].abs().max()) > 0.0


def test_surf_energy_terms_on_the_affine_profile_with_the_dry_column():
    """The residual's terms at candidates across and beyond the bracket,
    nodes 1-2 interpolated between the same two probe profiles."""
    (a, _), _ = affine_call()
    eb, t0_old, tair = a
    mid = 0.5 * (t0_old + tair)
    lo, hi = mid - 5.0, mid + 5.0
    prof_lo, prof_hi = eb["fd_solve"](lo).temp, eb["fd_solve"](hi).temp
    kw = dict(eb, fd_solve=None, fd_interp=(lo, prof_lo, hi, prof_hi))
    jkw = dict(jax_kwargs(eb), fd_solve=None,
               fd_interp=J((lo, prof_lo, hi, prof_hi)))
    names = ("error", "t1", "grnd_flux", "delta_h", "fusion", "latent_heat",
             "sensible_heat", "evap", "layer_evap", "wdew_new", "t_nodes",
             "evap_dry", "layer_evap_dry", "canopy_evap_mm_dry",
             "throughfall_dry", "wdew_new_dry")
    for offset in (-12.0, -3.0, -0.4, 0.7, 4.0, 11.0):
        ts = (mid + offset).contiguous()
        got = tsurface.surf_energy_terms(ts, **kw)
        ref = jsurface.surf_energy_terms(jnp.asarray(ts.numpy()), **jkw)
        for name in names:
            close(getattr(got, name), getattr(ref, name), ELEM_TOL,
                  f"{name} at mid{offset:+}")
    assert float(np.abs(np.asarray(ref.fusion)).max()) > 0.0


def test_solve_surface_temperature_affine_matches():
    (a, kw), _ = affine_call()
    eb, t0_old, tair = a
    ts, fb, fdi, terms = tsurface.solve_surface_temperature(eb, t0_old,
                                                            tair, **kw)
    assert terms is None    # the caller evaluates them on the profile
    jts, jfb, jfdi = jsurface.solve_surface_temperature(
        jax_kwargs(eb), J(t0_old), J(tair), True, max_iter=kw["max_iter"],
        active=J(kw["active"]), fd_affine=True)
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jfb))
    close(ts, jts, BRENT_TOL, "ts")
    assert len(fdi) == len(jfdi) == 4
    for i, (g, r) in enumerate(zip(fdi, jfdi)):
        close(g, r, BRENT_TOL, f"fd_interp[{i}]")
