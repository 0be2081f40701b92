"""The node sweep's batch-wide stop under a NaN lane, against vic_tpu.

Under CONTINUEONERROR a cell whose forcing went NaN carries NaN node
temperatures into the next step's sweep. vic_tpu's sweep loop runs while
jnp.max(maxdiff) > 1e-2, which is False once any lane's change is NaN
(vic_tpu/physics/frozen_soil.py:560-562), so one NaN lane stops the sweeps
of every lane. The port's kernels (K6, and K6 inside K7) reproduce that
with a NaN flag of their own; this holds the port's plain version to
vic_tpu on it. Inputs are made from a seed with numpy and handed to both
packages as the same float32 bits: the frozen configuration's node
geometry (3 layers, 5 linear nodes) on 4 cells x 2 HRU lanes, one lane's
old temperatures and boundary condition NaN. Tolerance: equal sweep and
fallback counts, the other lanes' profiles within 1e-5 C.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.config import GlobalParams
from vic_tpu.physics import frozen_soil as jfs
from vic_tpu.prepare import prepare_domain as jax_prepare_domain
from vic_tpu.testing import synthetic_domain as jax_synthetic_domain
from vic_tpu_torch.entry import frozen_params
from vic_tpu_torch.physics import frozen_soil as tfs
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.testing import synthetic_domain

torch.set_num_threads(1)

N_CELL, MAX_HRU, NL, NN = 4, 2, 3, 5
DT_SEC = 86400.0
TOL = 1e-5
MAX_SWEEPS = 10
NAN_LANE = (1, 0)
JAX_GP = GlobalParams(nlayer=NL, nnode=NN, quick_flux=False, frozen_soil=True,
                      implicit=True, soil_sweep_maxiter=MAX_SWEEPS)


@pytest.fixture(scope="module")
def setup():
    """vic_tpu's params and geometry, the port's counterparts (params from
    vic_tpu's float32 bits, field by field)."""
    jdom = jax_synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    jparams = jax_prepare_domain(jdom, JAX_GP)
    tdom = synthetic_domain(n_cell=N_CELL, n_band=2, with_glacier=True)
    fields = {f.name: np.asarray(getattr(jparams, f.name))
              for f in dataclasses.fields(jparams)}
    return dict(jdom=jdom, jparams=jparams,
                jgeom=jfs.build_node_geometry(jdom.soil, JAX_GP),
                geom=tfs.build_node_geometry(tdom.soil,
                                             frozen_params(1)).to("cpu"),
                tparams=device_params_from_numpy(fields, "cpu"))


def sweep_inputs(setup, seed, nan_lane):
    """Seeded old temperatures, boundary condition and node properties
    (vic_tpu's distribute_node_moisture at the old temperatures); the lane
    nan_lane's temperatures and boundary condition NaN, if given."""
    rng = np.random.default_rng(seed)
    mm = np.asarray(setup["jdom"].soil.max_moist, np.float32)
    moist = (mm[:, None, :] * rng.uniform(0.3, 1.0, (N_CELL, MAX_HRU, NL))
             ).astype(np.float32)
    t0 = rng.uniform(-8.0, 4.0, (N_CELL, MAX_HRU, NN)).astype(np.float32)
    surf = rng.uniform(-12.0, 3.0, (N_CELL, MAX_HRU)).astype(np.float32)
    if nan_lane is not None:
        t0[nan_lane] = np.nan
        surf[nan_lane] = np.nan
    nodep = jfs.distribute_node_moisture(jnp.asarray(moist), jnp.asarray(t0),
                                         setup["jgeom"], setup["jparams"],
                                         frozen=True)
    return t0, surf, {k: np.array(v) for k, v in nodep.items()}


def run_both(setup, t0, surf, nodep, noflux):
    ref = jfs.solve_t_profile_explicit(
        jnp.asarray(t0), jnp.asarray(surf), jnp.asarray(nodep["kappa"]),
        jnp.asarray(nodep["cs"]), jnp.asarray(nodep["moist"]),
        jnp.asarray(nodep["ice"]), setup["jgeom"], setup["jparams"], DT_SEC,
        noflux=noflux, exp_trans=False, frozen=True, max_sweeps=MAX_SWEEPS,
        ice_quirk=True)
    got = tfs.solve_t_profile_explicit_plain(
        torch.tensor(t0), torch.tensor(surf), torch.tensor(nodep["kappa"]),
        torch.tensor(nodep["cs"]), torch.tensor(nodep["moist"]),
        torch.tensor(nodep["ice"]), setup["geom"],
        setup["tparams"].fs_active, nlayer=NL, dt_sec=DT_SEC, noflux=noflux,
        frozen=True, max_sweeps=MAX_SWEEPS)
    return ref, got


@pytest.mark.parametrize("noflux", [False, True])
def test_nan_lane_stops_every_lanes_sweeps(setup, noflux):
    """With the batch's other lanes needing more than one sweep, one NaN
    lane stops the sweeps of all after the first, in both packages; the
    other lanes' profiles and every fallback count agree."""
    clean = run_both(setup, *sweep_inputs(setup, 11, None), noflux)
    assert clean[1].iterations == int(clean[0].iterations) > 1
    ref, got = run_both(setup, *sweep_inputs(setup, 11, NAN_LANE), noflux)
    assert got.iterations == int(ref.iterations) == 1
    ref_t, got_t = np.asarray(ref.temp), got.temp.numpy()
    assert np.isnan(ref_t[NAN_LANE][1:]).all()
    np.testing.assert_array_equal(np.isnan(got_t), np.isnan(ref_t))
    others = np.ones((N_CELL, MAX_HRU), bool)
    others[NAN_LANE] = False
    np.testing.assert_allclose(got_t[others], ref_t[others], rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.fbcount.numpy(), np.asarray(ref.fbcount))
