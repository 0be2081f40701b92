"""The port's frozen-soil options as cold-region users set them up, against
vic_tpu's: EXP_TRANS node spacing, node counts other than 5, and
SPATIAL_FROST's frost subareas.

Inputs are made from a seed with numpy and handed to both packages as the
same float32 bits on 4 synthetic cells x 8 HRU lanes (3 soil layers). The
geometry is held exact (float64) at 3, 10 and 18 nodes, linear and
EXP_TRANS; the Gauss-Seidel sweep on 10 EXP_TRANS nodes at 1e-4 with equal
sweep and fallback counts; the layer ice over 10 frost subareas and the
cold start with both options at 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.config import GlobalParams
from vic_tpu.physics import frozen_soil as jfs
from vic_tpu.prepare import prepare_domain as jax_prepare_domain
from vic_tpu.state import initial_state as jax_initial_state
from vic_tpu.testing import synthetic_domain as jax_synthetic_domain
from vic_tpu_torch.entry import frozen_exp_params, frozen_params
from vic_tpu_torch.physics import frozen_soil as tfs
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.state import initial_state
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

N_CELL, MAX_HRU, NL, NN = 4, 8, 3, 10
DT_SEC = 86400.0
ELEM_TOL = 1e-5
SWEEP_TOL = 1e-4
FROST = dict(spatial_frost=True, frost_subareas=10, frost_slope=2.0)
JAX_GP = GlobalParams(nlayer=NL, nnode=NN, quick_flux=False, frozen_soil=True,
                      implicit=True, soil_sweep_maxiter=10, exp_trans=True,
                      **FROST)


def fields_of(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def setup():
    """vic_tpu's domain, params and 10-node EXP_TRANS geometry, and the
    port's counterparts (params filled from vic_tpu's float32 bits)."""
    jdom = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    jparams = jax_prepare_domain(jdom, JAX_GP)
    jgeom = jfs.build_node_geometry(jdom.soil, JAX_GP)
    tdom = synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    tgeom = tfs.build_node_geometry(tdom.soil, frozen_exp_params(1))
    tparams = device_params_from_numpy(fields_of(jparams), "cpu")
    return dict(jdom=jdom, jparams=jparams, jgeom=jgeom, tdom=tdom,
                tgeom=tgeom, geom=tgeom.to("cpu"), tparams=tparams)


def close(got, ref, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("exp_trans", [True, False],
                         ids=["exp_trans", "linear"])
@pytest.mark.parametrize("nnode", [3, 10, 18])
def test_node_geometry_is_vic_tpus(nnode, exp_trans):
    """Every array of vic_tpu's geometry, the solver_* aliasing of nodes
    j >= 3 onto node j-3 included, and the float64 terms its sweep forms
    from them, exactly."""
    jgp = GlobalParams(nlayer=NL, nnode=nnode, quick_flux=False,
                       frozen_soil=True, exp_trans=exp_trans)
    jdom = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    jg = jfs.build_node_geometry(jdom.soil, jgp)
    tg = tfs.build_node_geometry(
        synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True).soil,
        frozen_params(1).replace(nnode=nnode, exp_trans=exp_trans))
    assert tg.n_node == nnode
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(getattr(tg, f.name),
                                      np.asarray(getattr(jg, f.name)),
                                      err_msg=f.name)
    for j in range(3, nnode):
        np.testing.assert_array_equal(tg.solver_expt[:, j],
                                      tg.expt_node[:, j - 3])
    b3, zp1 = jg.bexp[:, None], jg.zsum + 1.0
    if exp_trans:
        assert (jg.bexp > 0).all()
        np.testing.assert_array_equal(
            tg.e_coef, 4.0 * b3 * b3 * 917.0 * 3.337e5 * zp1 * zp1)
        np.testing.assert_array_equal(tg.exp_a, 4.0 * jg.bexp * jg.bexp)
    else:
        np.testing.assert_array_equal(tg.e_coef,
                                      917.0 * 3.337e5 * jg.alpha * jg.alpha)
    np.testing.assert_array_equal(tg.zp1, zp1)


def sweep_inputs(setup, seed):
    """Seeded old temperatures, boundary condition and layer moisture, the
    node properties from vic_tpu's distribute_node_moisture at t0."""
    rng = np.random.default_rng(seed)
    mm = np.asarray(setup["jdom"].soil.max_moist, np.float32)
    moist = (mm[:, None, :] * rng.uniform(0.3, 1.0, (N_CELL, MAX_HRU, NL))
             ).astype(np.float32)
    t0 = rng.uniform(-8.0, 4.0, (N_CELL, MAX_HRU, NN)).astype(np.float32)
    surf = rng.uniform(-12.0, 3.0, (N_CELL, MAX_HRU)).astype(np.float32)
    nodep = jfs.distribute_node_moisture(jnp.asarray(moist), jnp.asarray(t0),
                                         setup["jgeom"], setup["jparams"],
                                         frozen=True)
    return t0, surf, {k: np.array(v) for k, v in nodep.items()}


@pytest.mark.parametrize("noflux", [False, True])
def test_exp_trans_node_sweep_plain(setup, noflux):
    t0, surf, nodep = sweep_inputs(setup, 3)
    ref = jfs.solve_t_profile_explicit(
        jnp.asarray(t0), jnp.asarray(surf), jnp.asarray(nodep["kappa"]),
        jnp.asarray(nodep["cs"]), jnp.asarray(nodep["moist"]),
        jnp.asarray(nodep["ice"]), setup["jgeom"], setup["jparams"], DT_SEC,
        noflux=noflux, exp_trans=True, frozen=True, max_sweeps=10,
        ice_quirk=True)
    got = tfs.solve_t_profile_explicit_plain(
        torch.tensor(t0), torch.tensor(surf), torch.tensor(nodep["kappa"]),
        torch.tensor(nodep["cs"]), torch.tensor(nodep["moist"]),
        torch.tensor(nodep["ice"]), setup["geom"],
        setup["tparams"].fs_active, nlayer=NL, dt_sec=DT_SEC, noflux=noflux,
        frozen=True, max_sweeps=10, exp_trans=True)
    assert got.iterations == int(ref.iterations)
    close(got.temp, ref.temp, SWEEP_TOL, "temp")
    np.testing.assert_array_equal(got.fbcount.numpy(), np.asarray(ref.fbcount))
    # the frozen branches ran on both the closed-form and the bisected nodes
    cold = t0 < 0.0
    assert bool(cold[..., 1:NL].any()) and bool(cold[..., NL:NN - 1].any())
    assert int(got.fbcount.sum()) > 0


def test_frost_offsets_are_jnp_linspace():
    """jnp.linspace's formula; XLA's compiled evaluation of it puts the
    point nearest 0 (0.111 C) 3 float32 ulps (2e-8 C) off the formula's
    float32 rounding."""
    got = tfs.frost_offsets(10, 2.0).numpy()
    ref = np.asarray(jnp.linspace(-0.5, 0.5, 10) * 2.0)
    assert got.dtype == ref.dtype
    np.testing.assert_array_max_ulp(got, ref, maxulp=3)


def test_estimate_layer_ice_over_frost_subareas(setup):
    rng = np.random.default_rng(7)
    mm = np.asarray(setup["jdom"].soil.max_moist, np.float32)
    moist = (mm[:, None, :] * rng.uniform(0.3, 1.0, (N_CELL, MAX_HRU, NL))
             ).astype(np.float32)
    temp = rng.uniform(-3.0, 2.0, (N_CELL, MAX_HRU, NN)).astype(np.float32)
    jp, tp = setup["jparams"], setup["tparams"]
    kw = dict(frost_subareas=10, frost_slope=2.0)
    ref_t, ref_ice = jfs.estimate_layer_ice(
        jnp.asarray(temp), jnp.asarray(moist), setup["jgeom"], jp,
        frozen=True, **kw)
    got_t, got_ice = tfs.estimate_layer_ice(
        torch.tensor(temp), torch.tensor(moist), setup["geom"],
        tfs.layer_ice_params(tp.max_moist, tp.bubble, tp.expt, tp.fs_active),
        **kw)
    close(got_t, ref_t, ELEM_TOL, "layer_t")
    close(got_ice, ref_ice, ELEM_TOL, "layer_ice")
    # the subareas change the ice: one subarea gives another answer
    one = jfs.estimate_layer_ice(jnp.asarray(temp), jnp.asarray(moist),
                                 setup["jgeom"], jp, frozen=True)[1]
    assert float(np.abs(np.asarray(one) - np.asarray(ref_ice)).max()) > 1.0


def test_cold_start_with_exp_trans_and_spatial_frost(setup):
    """The exponential initial profile on EXP_TRANS nodes and the layer ice
    it implies over the frost subareas, from first-step surface
    temperatures below and above 0 C."""
    surf0 = np.array([-6.0, -1.5, 3.0, 0.5], np.float32)
    ref = jax_initial_state(setup["jdom"], JAX_GP, surf_temp_init=surf0,
                            geom=setup["jgeom"])
    got = initial_state(setup["tdom"], frozen_exp_params(1), "cpu",
                        surf_temp_init=surf0, geom=setup["geom"])
    assert float(np.asarray(ref.ice).max()) > 0.0
    assert got.node_temp.shape[-1] == NN
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        close(b, a, ELEM_TOL, f.name)
