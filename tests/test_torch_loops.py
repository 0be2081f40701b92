"""The three TPU loops no step calls, and the interpolation helpers, against
vic_tpu on CPU.

- `canopy_snow.mass_release` (vic_tpu canopy_snow.py:126, 8 rounds) at
  rtol = atol = 1e-5;
- `ops.rootfind.batched_bisection` (vic_tpu ops/rootfind.py:210) on the
  x - k residual of tests/test_ops.py and on the snowpack residual (with
  and without SPATIAL_SNOW's advected sensible heat) through
  `physics.bisection.bisection_plain`, roots at 1e-5, flags equal;
- `frozen_soil.solve_t_profile_implicit` (vic_tpu frozen_soil.py:601) at
  5 and 8 nodes, linear and EXP_TRANS spacing, NOFLUX on and off, frozen
  soil on and off, at 1e-4 C with equal fallback counts; the wrapped
  kappa[0] of the NOFLUX bottom row is reproduced;
- `ops.interp` at 1e-5.

The same seeded numpy inputs go to both packages.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.config import GlobalParams as JGlobalParams
from vic_tpu.ops import interp as jinterp
from vic_tpu.ops.rootfind import batched_bisection as j_bisection
from vic_tpu.physics.canopy_snow import mass_release as j_mass_release
from vic_tpu.physics.frozen_soil import \
    build_node_geometry as j_build_node_geometry
from vic_tpu.physics.frozen_soil import \
    distribute_node_moisture as j_distribute_node_moisture
from vic_tpu.physics.frozen_soil import \
    solve_t_profile_implicit as j_implicit
from vic_tpu.physics.snow import snow_energy_terms as j_snow_energy_terms
from vic_tpu.prepare import prepare_domain as j_prepare_domain
from vic_tpu.testing import synthetic_domain as j_synthetic_domain
from vic_tpu_torch import constants as c
from vic_tpu_torch.config import GlobalParams
from vic_tpu_torch.ops import interp
from vic_tpu_torch.ops.rootfind import batched_bisection
from vic_tpu_torch.physics import frozen_soil
from vic_tpu_torch.physics.bisection import bisection, bisection_plain
from vic_tpu_torch.physics.canopy_snow import mass_release
from vic_tpu_torch.physics.frozen_soil import (build_node_geometry,
                                               solve_t_profile_implicit)
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

ELEMENTWISE_TOL = 1e-5
IMPLICIT_TOL = 1e-4      # C


def t(a):
    return torch.tensor(np.asarray(a))


def test_mass_release_matches_vic_tpu():
    rng = np.random.default_rng(11)
    shape = (6, 5)
    int_snow = rng.uniform(0.0, 0.03, shape).astype(np.float32)
    storage = rng.uniform(0.0, 0.012, shape).astype(np.float32)
    # the gate and the thresholds exactly
    int_snow[0, :3] = [0.0, c.MIN_INTERCEPTION_STORAGE, 0.02]
    storage[0, :3] = [0.001, 0.004, 0.002]
    ref = j_mass_release(jnp.asarray(int_snow), jnp.asarray(storage))
    got = mass_release(t(int_snow), t(storage))
    for name, a, b in zip(("int_snow", "temp_int_storage", "released",
                           "drip"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=ELEMENTWISE_TOL,
                                   atol=ELEMENTWISE_TOL, err_msg=name)
    released, drip = got[2].numpy(), got[3].numpy()
    assert (released > 0).any() and (drip > 0).any()


def test_bisection_matches_vic_tpu_on_a_callable():
    """tests/test_ops.py's x - k residual, on a batch with lanes that do
    not bracket (bisected all the same, converged False)."""
    k = np.array([2.0, 5.0, 12.0, -1.0], np.float32)
    lo, hi = np.zeros(4, np.float32), np.full(4, 10.0, np.float32)
    kj, kt = jnp.asarray(k), t(k)
    ref = j_bisection(lambda x: x - kj, jnp.asarray(lo), jnp.asarray(hi),
                      n_iter=40)
    got = batched_bisection(lambda x: x - kt, t(lo), t(hi), n_iter=40)
    np.testing.assert_allclose(got.root.numpy(), np.asarray(ref.root),
                               rtol=ELEMENTWISE_TOL, atol=ELEMENTWISE_TOL)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    assert got.converged.tolist() == [True, True, False, False]
    assert got.iterations == int(ref.iterations) == 40


def _snowpack_inputs(n, seed=5):
    """Plausible snowpack residual inputs on n lanes (numpy float32)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)
    tair = u(-15.0, 5.0)
    return dict(
        ra=u(40.0, 200.0), z_ref=u(2.0, 10.0), roughness=u(1e-4, 1e-2),
        air_dens=u(1.1, 1.35), vp_air=u(150.0, 600.0),
        longwave_in=u(180.0, 320.0), lv=(2.501e6 - 2361.0 * tair),
        pressure=u(80000.0, 95000.0), rain_m=u(0.0, 0.002),
        net_short=u(0.0, 250.0), vpd=u(0.0, 400.0), wind=u(0.0, 8.0),
        old_tsurf=u(-10.0, 0.0), snow_depth=u(0.0, 1.0),
        snow_density=u(150.0, 400.0), surf_water=u(0.0, 0.001),
        surface_swq=u(0.01, 0.125), tair=tair, tgrnd=u(-8.0, 2.0),
        blowing_flux=np.zeros(n, np.float32))


@pytest.mark.parametrize("spatial", [False, True],
                         ids=["plain", "spatial_snow"])
def test_bisection_matches_vic_tpu_on_the_snowpack_residual(spatial):
    n = 12
    kw = _snowpack_inputs(n)
    if spatial:
        kw["snow_cover_fract"] = np.random.default_rng(2).uniform(
            0.0, 1.0, n).astype(np.float32)
    dt = 86400.0
    lo, hi = np.full(n, -60.0, np.float32), np.full(n, 5.0, np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = j_bisection(
        lambda x: j_snow_energy_terms(x, dt=dt, displacement=0.0,
                                      **jkw).rest,
        jnp.asarray(lo), jnp.asarray(hi), n_iter=40)
    tkw = {k: t(v) for k, v in kw.items()}
    got = bisection_plain("snowpack", t(lo), t(hi), None, 40, dt=dt, **tkw)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    assert bool(got.bracketed.any())
    np.testing.assert_allclose(got.root.numpy(), np.asarray(ref.root),
                               rtol=ELEMENTWISE_TOL, atol=ELEMENTWISE_TOL)
    # the device dispatch takes the plain version for CPU tensors, and an
    # inactive lane returns the midpoint unbracketed
    active = torch.ones(n, dtype=torch.bool)
    active[0] = False
    masked = bisection("snowpack", t(lo), t(hi), active, 40, dt=dt, **tkw)
    assert torch.equal(masked.root[1:], got.root[1:])
    assert float(masked.root[0]) == 0.5 * (lo[0] + hi[0])
    assert not bool(masked.bracketed[0])


def _implicit_inputs(nnode, exp_trans, frozen, seed=3, n_cell=3, n_hru=2):
    """vic_tpu's and the port's arguments of the implicit solve on the same
    synthetic soil: node properties from vic_tpu's distribute_node_moisture
    at seeded temperatures, one lane 45 C off at the surface (a fallback)."""
    flags = dict(nlayer=3, nnode=nnode, quick_flux=False, frozen_soil=True,
                 exp_trans=exp_trans)
    jgp, tgp = JGlobalParams(**flags), GlobalParams(**flags)
    jdom = j_synthetic_domain(n_cell=n_cell)
    jgeom = j_build_node_geometry(jdom.soil, jgp)
    jparams = j_prepare_domain(jdom, jgp)
    tgeom = build_node_geometry(synthetic_domain(n_cell).soil, tgp).to("cpu")
    rng = np.random.default_rng(seed)
    sh = (n_cell, n_hru, nnode)
    t0 = rng.uniform(-8.0, 3.0, sh).astype(np.float32)
    surf = rng.uniform(-12.0, 10.0, sh[:2]).astype(np.float32)
    surf[0, 0] = t0[0, 0, 0] + 45.0
    moist = np.tile(np.asarray(jdom.soil.init_moist, np.float32)[:, None, :],
                    (1, n_hru, 1))
    nodep = j_distribute_node_moisture(jnp.asarray(moist), jnp.asarray(t0),
                                       jgeom, jparams, frozen=frozen)
    props = [np.asarray(nodep[k]) for k in ("kappa", "cs", "moist", "ice")]
    fs = np.asarray(jparams.fs_active)
    return (jgeom, SimpleNamespace(fs_active=jnp.asarray(fs)), tgeom,
            t(fs), t0, surf, props)


def _both_implicit(nnode, exp_trans, noflux, frozen, props=None,
                   relax=None):
    jgeom, jparams, tgeom, tfs, t0, surf, base = _implicit_inputs(
        nnode, exp_trans, frozen)
    kappa, cs, moist, ice = props or base
    ref = j_implicit(jnp.asarray(t0), jnp.asarray(surf), jnp.asarray(kappa),
                     jnp.asarray(cs), jnp.asarray(moist), jnp.asarray(ice),
                     jgeom, jparams, 86400.0, noflux=noflux,
                     exp_trans=exp_trans, frozen=frozen, relax=relax)
    got = solve_t_profile_implicit(
        t(t0), t(surf), t(kappa), t(cs), t(moist), t(ice), tgeom, tfs,
        dt_sec=86400.0, noflux=noflux, frozen=frozen, relax=relax)
    return ref, got, (t0, surf, kappa, cs, moist, ice, tgeom, tfs)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("noflux", [False, True], ids=["fixed", "noflux"])
@pytest.mark.parametrize("exp_trans", [False, True],
                         ids=["linear", "exp_trans"])
@pytest.mark.parametrize("nnode", [5, 8])
def test_implicit_solve_matches_vic_tpu(nnode, exp_trans, noflux, frozen):
    ref, got, (t0, surf, *_rest) = _both_implicit(nnode, exp_trans, noflux,
                                                  frozen)
    np.testing.assert_allclose(got.temp.numpy(), np.asarray(ref.temp),
                               rtol=IMPLICIT_TOL, atol=IMPLICIT_TOL)
    np.testing.assert_array_equal(got.fbcount.numpy(),
                                  np.asarray(ref.fbcount))
    assert got.iterations == int(ref.iterations) == 12
    # the lane 45 C off at the surface fell back to its old profile
    assert int(got.fbcount[0, 0, 0]) == 1
    np.testing.assert_array_equal(got.temp[0, 0, 1:].numpy(), t0[0, 0, 1:])
    # the others moved: node 1 follows the new surface temperature
    assert float((got.temp[..., 1] - torch.tensor(t0[..., 1])).abs().max()) \
        > 0.1


def test_implicit_solve_with_a_given_relaxation():
    ref, got, _ = _both_implicit(5, False, True, True, relax=0.5)
    np.testing.assert_allclose(got.temp.numpy(), np.asarray(ref.temp),
                               rtol=IMPLICIT_TOL, atol=IMPLICIT_TOL)


def test_implicit_noflux_bottom_row_reads_kappa0(monkeypatch):
    """Under NOFLUX vic_tpu's bottom row takes Bc = (kappa[0] -
    kappa[nn-2])*dt, jnp.roll wrapping kappa[nn] to kappa[0]: with a
    conductive top node the port reproduces it, and the same solve with
    the bottom row's own kappa[nn-1] in its place (what frozen_soil.c's
    B_last would read) lands elsewhere."""
    nnode = 8
    jgeom, jparams, tgeom, tfs, t0, surf, (kappa, cs, moist, ice) = \
        _implicit_inputs(nnode, False, True)
    kappa = kappa.copy()
    kappa[..., 0] *= 40.0
    props = [kappa, cs, moist, ice]
    ref, got, args = _both_implicit(nnode, False, True, True, props=props)
    np.testing.assert_allclose(got.temp.numpy(), np.asarray(ref.temp),
                               rtol=IMPLICIT_TOL, atol=IMPLICIT_TOL)
    t0_, surf_, kap, *rest = args
    roll = torch.roll

    def no_wrap(x, shifts, dims):
        out = roll(x, shifts, dims=dims)
        if x is kap_t and shifts == -1:
            out = out.clone()
            out[..., -1] = x[..., -1]
        return out

    kap_t = t(kap)
    monkeypatch.setattr(frozen_soil.torch, "roll", no_wrap)
    unwrapped = solve_t_profile_implicit(
        t(t0_), t(surf_), kap_t, *[t(a) for a in rest[:3]], rest[3], rest[4],
        dt_sec=86400.0, noflux=True, frozen=True)
    assert float((unwrapped.temp - got.temp).abs().max()) > 100 * IMPLICIT_TOL


def test_interp_matches_vic_tpu():
    rng = np.random.default_rng(8)
    n = 16
    x1 = rng.uniform(0.0, 10.0, n).astype(np.float32)
    x2 = x1 + rng.uniform(1.0, 5.0, n).astype(np.float32)
    x = x1 + rng.uniform(0.0, 1.0, n).astype(np.float32) * (x2 - x1)
    ys = [rng.uniform(-5.0, 5.0, n).astype(np.float32) for _ in range(4)]
    ly = rng.uniform(0.5, 3.0, n).astype(np.float32)
    ly[0] = 0.0
    uy = rng.uniform(0.5, 3.0, n).astype(np.float32)
    J, T = (lambda a: jnp.asarray(a)), t
    pairs = [
        (jinterp.hermite(J(x), J(x1), J(x2), *map(J, ys)),
         interp.hermite(T(x), T(x1), T(x2), *map(T, ys))),
        (jinterp.linear_interp(J(x), J(x1), J(x2), J(ly), J(uy)),
         interp.linear_interp(T(x), T(x1), T(x2), T(ly), T(uy))),
        (jinterp.exp_interp(J(x), J(x1), J(x2), J(ly), J(uy)),
         interp.exp_interp(T(x), T(x1), T(x2), T(ly), T(uy)))]
    for name, (a, b) in zip(("hermite", "linear_interp", "exp_interp"),
                            pairs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=ELEMENTWISE_TOL,
                                   atol=ELEMENTWISE_TOL, err_msg=name)
