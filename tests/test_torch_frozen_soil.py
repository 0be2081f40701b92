"""The port's frozen-soil finite-difference functions against vic_tpu's.

Inputs are made from a seed with numpy and handed to both packages as the
same float32 bits: the node geometry of the frozen configuration (3 layers,
5 linear-spaced nodes) on 4 synthetic cells x 8 HRU lanes, node moisture
and ice, the Gauss-Seidel sweep, layer ice, the freezing and thawing
fronts, the cold start and the surface energy balance with fusion on the
finite-difference ground heat. Tolerances: the geometry is exact; the
elementwise functions rtol = atol = 1e-5; the sweep and everything that
runs it 1e-4 with equal sweep and fallback counts.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.config import GlobalParams
from vic_tpu.physics import evap as jevap
from vic_tpu.physics import frozen_soil as jfs
from vic_tpu.physics import surface as jsurface
from vic_tpu.prepare import prepare_domain as jax_prepare_domain
from vic_tpu.state import initial_state as jax_initial_state
from vic_tpu.testing import synthetic_domain as jax_synthetic_domain
from vic_tpu_torch.entry import frozen_params
from vic_tpu_torch.physics import evap as tevap
from vic_tpu_torch.physics import frozen_soil as tfs
from vic_tpu_torch.physics import surface as tsurface
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.state import initial_state
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

N_CELL, MAX_HRU, NL, NN = 4, 8, 3, 5
DT_SEC = 86400.0
ELEM_TOL = 1e-5
SWEEP_TOL = 1e-4
JAX_GP = GlobalParams(nlayer=NL, nnode=NN, quick_flux=False, frozen_soil=True,
                      implicit=True, soil_sweep_maxiter=10)


def fields_of(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def setup():
    """vic_tpu's domain, params and geometry, and the port's counterparts
    (params filled field by field from vic_tpu's float32 bits)."""
    jdom = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    jparams = jax_prepare_domain(jdom, JAX_GP)
    jgeom = jfs.build_node_geometry(jdom.soil, JAX_GP)
    tdom = synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    tgeom = tfs.build_node_geometry(tdom.soil, frozen_params(1))
    tparams = device_params_from_numpy(fields_of(jparams), "cpu")
    return dict(jdom=jdom, jparams=jparams, jgeom=jgeom, tdom=tdom,
                tgeom=tgeom, geom=tgeom.to("cpu"), tparams=tparams)


def close(got, ref, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def node_inputs(setup, seed):
    """Seeded layer moisture [c,h,nl] and node temperatures [c,h,nn]."""
    rng = np.random.default_rng(seed)
    mm = np.asarray(setup["jdom"].soil.max_moist, np.float32)
    moist = (mm[:, None, :] * rng.uniform(0.3, 1.0, (N_CELL, MAX_HRU, NL))
             ).astype(np.float32)
    temp = rng.uniform(-8.0, 4.0, (N_CELL, MAX_HRU, NN)).astype(np.float32)
    return moist, temp


def test_node_geometry_is_vic_tpus(setup):
    jg, tg = setup["jgeom"], setup["tgeom"]
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(getattr(tg, f.name),
                                      np.asarray(getattr(jg, f.name)),
                                      err_msg=f.name)
    # the float64 terms the JAX package forms from its numpy geometry
    np.testing.assert_array_equal(tg.e_coef,
                                  917.0 * 3.337e5 * jg.alpha * jg.alpha)
    np.testing.assert_array_equal(tg.bubble_term_node,
                                  9.81 * jg.bubble_node / 100.0)
    g = setup["geom"]
    assert g.alpha.dtype == torch.float32 and g.node_layer.dtype == \
        torch.int64 and g.on_boundary.dtype == torch.bool


@pytest.mark.parametrize("frozen", [True, False])
def test_distribute_node_moisture(setup, frozen):
    moist, temp = node_inputs(setup, 1)
    ref = jfs.distribute_node_moisture(jnp.asarray(moist), jnp.asarray(temp),
                                       setup["jgeom"], setup["jparams"],
                                       frozen=frozen)
    got = tfs.distribute_node_moisture(torch.tensor(moist),
                                       torch.tensor(temp), setup["geom"],
                                       setup["tparams"], frozen=frozen)
    assert sorted(got) == sorted(ref)
    if frozen:
        assert float(np.asarray(ref["ice"]).max()) > 0.0
    for k in ref:
        close(got[k], ref[k], ELEM_TOL, k)


def sweep_inputs(setup, seed):
    """The sweep's inputs: seeded old temperatures and boundary condition,
    node properties from vic_tpu's distribute_node_moisture at t0."""
    rng = np.random.default_rng(seed)
    moist, t0 = node_inputs(setup, seed)
    surf = rng.uniform(-12.0, 3.0, (N_CELL, MAX_HRU)).astype(np.float32)
    nodep = jfs.distribute_node_moisture(jnp.asarray(moist), jnp.asarray(t0),
                                         setup["jgeom"], setup["jparams"],
                                         frozen=True)
    return t0, surf, {k: np.array(v) for k, v in nodep.items()}


def run_both(setup, t0, surf, nodep, noflux=False, max_sweeps=10):
    ref = jfs.solve_t_profile_explicit(
        jnp.asarray(t0), jnp.asarray(surf), jnp.asarray(nodep["kappa"]),
        jnp.asarray(nodep["cs"]), jnp.asarray(nodep["moist"]),
        jnp.asarray(nodep["ice"]), setup["jgeom"], setup["jparams"], DT_SEC,
        noflux=noflux, exp_trans=False, frozen=True, max_sweeps=max_sweeps,
        ice_quirk=True)
    got = tfs.solve_t_profile_explicit_plain(
        torch.tensor(t0), torch.tensor(surf), torch.tensor(nodep["kappa"]),
        torch.tensor(nodep["cs"]), torch.tensor(nodep["moist"]),
        torch.tensor(nodep["ice"]), setup["geom"],
        setup["tparams"].fs_active, nlayer=NL, dt_sec=DT_SEC, noflux=noflux,
        frozen=True, max_sweeps=max_sweeps)
    return ref, got


@pytest.mark.parametrize("noflux", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_node_sweep_plain(setup, seed, noflux):
    t0, surf, nodep = sweep_inputs(setup, seed)
    ref, got = run_both(setup, t0, surf, nodep, noflux=noflux)
    assert got.iterations == int(ref.iterations)
    close(got.temp, ref.temp, SWEEP_TOL, "temp")
    np.testing.assert_array_equal(got.fbcount.numpy(), np.asarray(ref.fbcount))
    # the frozen branches ran: nodes below 0 C where frozen soil is active
    assert bool(((t0[..., 1:NN - 1] < 0.0)
                 & setup["tparams"].fs_active.numpy()[:, None, None]).any())


def test_node_sweep_count_is_batch_wide(setup):
    """A lane that converges in one or two sweeps on its own keeps sweeping
    while another lane of the batch needs the cap, and both packages give
    it the same temperatures as each other, not those of its own run."""
    t0, surf, nodep = sweep_inputs(setup, 5)
    # lane (0, 0): a profile already at rest, ice-free, the boundary
    # condition 0.05 C off its surface node
    t0[0, 0] = 2.0
    surf[0, 0] = 2.05
    nodep["ice"][0, 0] = 0.0
    cap = 3
    ref, got = run_both(setup, t0, surf, nodep, max_sweeps=cap)
    assert int(ref.iterations) == got.iterations == cap
    close(got.temp, ref.temp, SWEEP_TOL, "temp")
    np.testing.assert_array_equal(got.fbcount.numpy(), np.asarray(ref.fbcount))
    # on its own, lane (0, 0) stops after at most two sweeps
    alone = {k: v[:1, :1] for k, v in nodep.items()}
    one = dataclasses.replace(
        setup["geom"], **{f: getattr(setup["geom"], f)[:1]
                          for f in ("alpha", "beta", "gamma", "e_coef",
                                    "solver_max_moist", "solver_bubble",
                                    "solver_expt")})
    solo = tfs.solve_t_profile_explicit_plain(
        torch.tensor(t0[:1, :1]), torch.tensor(surf[:1, :1]),
        torch.tensor(alone["kappa"]), torch.tensor(alone["cs"]),
        torch.tensor(alone["moist"]), torch.tensor(alone["ice"]), one,
        setup["tparams"].fs_active[:1], nlayer=NL, dt_sec=DT_SEC,
        noflux=False, frozen=True, max_sweeps=cap)
    assert 1 <= solo.iterations <= 2
    assert not torch.equal(solo.temp[0, 0], got.temp[0, 0])


def test_estimate_layer_ice_and_fronts(setup):
    moist, temp = node_inputs(setup, 7)
    jp = setup["jparams"]
    ref_t, ref_ice = jfs.estimate_layer_ice(jnp.asarray(temp),
                                            jnp.asarray(moist),
                                            setup["jgeom"], jp, frozen=True)
    tp = setup["tparams"]
    got_t, got_ice = tfs.estimate_layer_ice(
        torch.tensor(temp), torch.tensor(moist), setup["geom"],
        tfs.layer_ice_params(tp.max_moist, tp.bubble, tp.expt, tp.fs_active))
    assert float(np.asarray(ref_ice).max()) > 0.0
    close(got_t, ref_t, ELEM_TOL, "layer_t")
    close(got_ice, ref_ice, ELEM_TOL, "layer_ice")
    ref_t0, ref_ice0 = jfs.estimate_layer_ice(
        jnp.asarray(temp), jnp.asarray(moist), setup["jgeom"], jp,
        frozen=False)
    got_t0, got_ice0 = tfs.estimate_layer_ice(
        torch.tensor(temp), torch.tensor(moist), setup["geom"])
    close(got_t0, ref_t0, ELEM_TOL, "layer_t unfrozen")
    close(got_ice0, ref_ice0, 0.0, "no ice")

    ref_td, ref_fd = jfs.find_zero_fronts(jnp.asarray(temp),
                                          setup["jgeom"].zsum[:, None, :])
    got_td, got_fd = tfs.find_zero_fronts(torch.tensor(temp),
                                          setup["geom"].zsum[:, None, :])
    assert float(np.asarray(ref_td).max()) > 0.0
    assert float(np.asarray(ref_fd).max()) > 0.0
    close(got_td, ref_td, ELEM_TOL, "thaw fronts")
    close(got_fd, ref_fd, ELEM_TOL, "frost fronts")


def test_finite_difference_cold_start(setup):
    """The exponential initial profile and the layer ice it implies, from a
    first-step surface temperature below and above 0 C."""
    surf0 = np.array([-6.0, -1.5, 3.0, 0.5], np.float32)
    ref = jax_initial_state(setup["jdom"], JAX_GP, surf_temp_init=surf0,
                            geom=setup["jgeom"])
    got = initial_state(setup["tdom"], frozen_params(1), "cpu",
                        surf_temp_init=surf0, geom=setup["geom"])
    assert float(np.asarray(ref.ice).max()) > 0.0
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        close(b, a, ELEM_TOL, f.name)


def test_canopy_and_arno_evap_with_soil_ice():
    """canopy_evap and arno_evap with ice in every layer (the frozen path's
    first)."""
    rng = np.random.default_rng(11)
    sh = (N_CELL, MAX_HRU)

    def u(lo, hi, shape=sh):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    moist = u(60.0, 300.0, sh + (NL,))
    ice = moist * u(0.0, 0.9, sh + (NL,))
    root = u(0.0, 1.0, sh + (NL,))
    root /= root.sum(-1, keepdims=True)
    args = dict(moist=moist, soil_ice=ice, wcr=u(40.0, 150.0, sh + (NL,)),
                wpwp=u(20.0, 60.0, sh + (NL,)), root=root,
                wdew=u(0.0, 0.5), prec=u(0.0, 4.0), wdmax=u(0.1, 0.6),
                rmin=u(50.0, 200.0), rgl=u(30.0, 100.0), lai=u(0.5, 5.0),
                rarc=u(2.0, 60.0), rad=u(-50.0, 300.0),
                net_short=u(0.0, 250.0), vpd=u(0.0, 1500.0),
                air_temp=u(-5.0, 25.0), elevation=u(0.0, 2500.0),
                ra=u(20.0, 200.0))
    ref = jevap.canopy_evap(**{k: jnp.asarray(v) for k, v in args.items()},
                            depth=jnp.asarray(u(0.1, 1.5, sh + (NL,))),
                            delta_t=DT_SEC)
    got = tevap.canopy_evap(**{k: torch.tensor(v) for k, v in args.items()},
                            delta_t=DT_SEC)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        close(g, r, ELEM_TOL, "canopy_evap")
    arno = dict(moist0=moist[..., 0], soil_ice0=ice[..., 0],
                max_moist0=moist[..., 0] + u(0.0, 50.0), depth0=u(0.1, 0.3),
                resid_moist0=u(0.0, 0.05), b_infilt=u(0.05, 0.4),
                rad=args["rad"], air_temp=args["air_temp"], vpd=args["vpd"],
                elevation=args["elevation"], ra=args["ra"])
    close(tevap.arno_evap(**{k: torch.tensor(v) for k, v in arno.items()},
                          delta_t=DT_SEC),
          jevap.arno_evap(**{k: jnp.asarray(v) for k, v in arno.items()},
                          delta_t=DT_SEC), ELEM_TOL, "arno_evap")


def test_finite_difference_surface_energy_terms_with_fusion(setup):
    """surf_energy_terms on the finite-difference path: ground heat from the
    node profile solved at each candidate Ts and the fusion of the top node
    pair, at the keyword arguments of the port's third frozen record (nodes
    below 0 C, layer ice), for candidates across the bracket."""
    from vic_tpu.model import make_forcing_stack as jax_forcing_stack
    from vic_tpu.testing import synthetic_forcing as jax_synthetic_forcing
    from vic_tpu.timeaxis import make_time_axis
    from vic_tpu_torch import model
    from vic_tpu_torch.state import state_from_numpy

    gp = frozen_params(3)
    stack = jax_forcing_stack(jax_synthetic_forcing(3, N_CELL, dt_hours=24),
                              make_time_axis(1995, 1, 1, 0, 3, 24))
    jstate = jax_initial_state(setup["jdom"], JAX_GP, geom=setup["jgeom"])
    state = state_from_numpy(fields_of(jstate), "cpu")
    step = model.make_step(setup["tparams"], gp, geom=setup["geom"])
    eb_calls, sweep_calls = [], []
    orig_eb, orig_sweep = model.surf_energy_terms, \
        tfs.solve_t_profile_explicit_plain
    for r in range(3):
        if r == 2:
            model.surf_energy_terms = lambda *a, **k: (
                eb_calls.append(k), orig_eb(*a, **k))[1]
            tfs.solve_t_profile_explicit_plain = lambda *a, **k: (
                sweep_calls.append(a), orig_sweep(*a, **k))[1]
        try:
            state, _ = step(state, {k: (torch.tensor(np.asarray(v[r]))
                                        if k not in ("month", "day_in_year")
                                        else int(v[r]))
                                    for k, v in stack.items()})
        finally:
            model.surf_energy_terms = orig_eb
            tfs.solve_t_profile_explicit_plain = orig_sweep
    kw = eb_calls[0]
    t0, _, kappa, cs, moist, ice0 = (np.asarray(a) for a in sweep_calls[0][:6])
    assert kw["frozen_soil"] and float(kw["ice0_vol"].max()) > 0.0
    assert bool((t0[..., 1:NN - 1] < 0.0).any())

    def jfd_solve(ts):
        return jfs.solve_t_profile_explicit(
            jnp.asarray(t0), ts, jnp.asarray(kappa), jnp.asarray(cs),
            jnp.asarray(moist), jnp.asarray(ice0), setup["jgeom"],
            setup["jparams"], DT_SEC, noflux=False, exp_trans=False,
            frozen=True, max_sweeps=10, ice_quirk=True)

    def J(x):
        if isinstance(x, dict):
            return {k: J(v) for k, v in x.items()}
        return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x

    jkw = {k: J(v) for k, v in kw.items()
           if k not in ("fd_solve", "evap_pre", "inc_terms")}
    jkw["inc_terms"] = dict(J(kw["inc_terms"]),
                            blowing_flux=jnp.zeros_like(jkw["ts_old"]))
    jkw["evap_pre"] = jevap.build_evap_pre(
        jkw["moist_l"], jkw["ice_l"], jkw["wcr"], jkw["wpwp"], jkw["root"],
        jkw["max_moist_l"][..., 0], jkw["b_infilt"], jkw["rmin"],
        jkw["rgl"], jkw["lai"], jkw["shortwave_net_bare"], jkw["vpd"],
        jkw["tair"], jkw["elevation"])
    zeros = jnp.zeros_like(jkw["ts_old"])
    jkw.update(displacement_canopy=zeros, roughness_canopy=zeros,
               ref_height_canopy=zeros, fd_solve=jfd_solve)
    mid = 0.5 * (kw["ts_old"] + kw["tair"])
    for offset in (-1.0, -0.3, 0.4, 1.0):
        ts = (mid + offset).contiguous()
        got = tsurface.surf_energy_terms(ts, **kw)
        ref = jsurface.surf_energy_terms(jnp.asarray(ts.numpy()), **jkw)
        assert float(np.abs(np.asarray(ref.fusion)).max()) > 0.0
        for name in ("error", "t1", "grnd_flux", "delta_h", "fusion",
                     "latent_heat", "sensible_heat", "evap", "t_nodes"):
            close(getattr(got, name), getattr(ref, name), SWEEP_TOL, name)
        np.testing.assert_array_equal(got.node_fbcount.numpy(),
                                      np.asarray(ref.node_fbcount))
