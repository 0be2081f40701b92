"""STATE_FORMAT NETCDF in the port (vic_tpu_torch/io/state_io.py,
io/state_netcdf_ref.py) against vic_tpu's (vic_tpu/io/state_io.py,
io/state_netcdf_ref.py): the reference's StateIONetCDF.c schema and
vic_tpu's own, written by each package from one seeded state, equal
variable by variable and attribute by attribute (both read with the port's
NetCDFFile); each package reads the other's files; the npz fallback and
its path rule; and a driver run split by a NETCDF state file against its
continuous run at tests/test_torch_driver_warm.py's bounds.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig

torch.set_num_threads(1)

N_CELL = 7
DATE = (1995, 3, 14)
# light, and lakes with DIST_PRCP (the lake block, a dist dimension of 2)
CONFIGS = {
    "light": dict(),
    "lakes_dist": dict(lakes=True, dist_prcp=True),
}


def gp_of(cfg, config):
    return cfg.GlobalParams(dt=24, snow_step=24, nlayer=3, startyear=1995,
                            startmonth=1, startday=1, nrecs=4,
                            full_energy=True, glacier_id=99, snow_band=2,
                            **CONFIGS[config])


def seeded_arrays(template: dict, seed=11) -> dict:
    """The template's fields with seeded values: floats moved by up to
    +-1, flags drawn, counters drawn in 0..5."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in template.items():
        if a.dtype == bool:
            out[k] = rng.random(a.shape) < 0.5
        elif a.dtype.kind in "iu":
            out[k] = rng.integers(0, 6, a.shape).astype(a.dtype)
        else:
            out[k] = (a + rng.uniform(-1, 1, a.shape)).astype(a.dtype)
    return out


class Case:
    """One state and domain in both packages."""

    def __init__(self, config):
        from vic_tpu.physics.frozen_soil import build_node_geometry as jgeom
        from vic_tpu.physics.lake import make_lake_params as jlake
        from vic_tpu.state import ModelState as JState
        from vic_tpu.testing import synthetic_domain as jdomain
        from vic_tpu_torch.physics.frozen_soil import build_node_geometry
        from vic_tpu_torch.physics.lake import make_lake_params
        from vic_tpu_torch.prepare import lake_params_from_numpy
        from vic_tpu_torch.state import initial_state, state_from_numpy
        from vic_tpu_torch.testing import synthetic_domain
        self.jgp, self.gp = gp_of(jconfig, config), gp_of(tconfig, config)
        self.jdomain = jdomain(n_cell=N_CELL, n_band=2, with_glacier=True)
        self.domain = synthetic_domain(n_cell=N_CELL, n_band=2,
                                       with_glacier=True)
        self.lake = self.jlake = None
        if self.gp.lakes:
            self.jlake = jlake(self.jdomain.soil, self.jgp)
            self.lake = lake_params_from_numpy(
                make_lake_params(self.domain.soil, self.gp), "cpu")
        self.geom = build_node_geometry(self.domain.soil, self.gp)
        self.jgeom = jgeom(self.jdomain.soil, self.jgp)
        cold = initial_state(self.domain, self.gp, "cpu",
                             lake_params=self.lake)
        self.template = cold
        self.jtemplate = JState(**{k: jnp.asarray(v)
                                   for k, v in cold.numpy().items()})
        self.arrays = seeded_arrays(cold.numpy())
        self.state = state_from_numpy(self.arrays, "cpu")
        self.jstate = JState(**{k: jnp.asarray(v)
                                for k, v in self.arrays.items()})
        self.gmb = np.random.default_rng(5).normal(size=(N_CELL, 4))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    return Case(request.param)


def read_all(path):
    """Every dimension, variable (dtype, dims, attributes, values) and
    global attribute of a NetCDF file, read with the port's NetCDFFile."""
    from vic_tpu_torch.io.native import NetCDFFile
    with NetCDFFile(path) as f:
        out = {"__global__": f.attributes()}
        for name in f.var_names():
            dtype, dims = f.var_info(name)
            shape = [f.dim_len(d) for d in dims]
            out[name] = (dtype, dims, shape, f.attributes(name),
                         f.get(name, [0] * len(shape), shape, np.float64))
        return out


def assert_files_equal(a_path, b_path):
    a, b = read_all(a_path), read_all(b_path)
    assert list(a) == list(b)
    for name in a:
        if name == "__global__":
            assert a[name].keys() == b[name].keys()
            for k in a[name]:
                x, y = a[name][k], b[name][k]
                if isinstance(x, str):
                    assert x == y, k
                else:
                    assert x[0] == y[0], k
                    np.testing.assert_array_equal(x[1], y[1], err_msg=k)
            continue
        assert a[name][:4] == b[name][:4], name
        np.testing.assert_array_equal(a[name][4], b[name][4], err_msg=name)


def jarrays(state) -> dict:
    """A vic_tpu ModelState as numpy arrays."""
    return {k: np.asarray(getattr(state, k))
            for k in state.__dataclass_fields__}


def assert_states_equal(got, want: dict):
    """A ModelState of either package against numpy arrays, exactly."""
    for k, a in want.items():
        b = np.asarray(getattr(got, k))
        assert b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def write_both(case, jpath, tpath, lakes=False):
    """Each package's reference-schema file of the case's state. vic_tpu's
    writer raises when given lake_params (it reads a `basin_depth` its
    LakeParams lacks), so both are written without them unless `lakes`
    (the port's alone)."""
    from vic_tpu.io.state_netcdf_ref import write_state_netcdf_ref as jwrite
    from vic_tpu_torch.io.state_netcdf_ref import write_state_netcdf_ref
    jwrite(jpath, case.jstate, case.jgp, case.jdomain, date=DATE,
           geom=case.jgeom, gmb=case.gmb)
    write_state_netcdf_ref(tpath, case.state, case.gp, case.domain,
                           date=DATE, geom=case.geom, gmb=case.gmb,
                           lake_params=case.lake if lakes else None)


def test_reference_schema_files_equal(case, tmp_path):
    from vic_tpu_torch.io.state_netcdf_ref import is_ref_netcdf_state
    jpath, tpath = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    write_both(case, jpath, tpath)
    assert is_ref_netcdf_state(tpath) and is_ref_netcdf_state(jpath)
    assert_files_equal(jpath, tpath)
    names = read_all(tpath)
    assert ("LAKE_VOLUME" in names) == case.gp.lakes
    assert names["LAYER_MOIST"][2][3] == (2 if case.gp.dist_prcp else 1)


def test_reference_schema_lake_depth(tmp_path):
    """With lake_params the port writes each lake's depth at its volume
    (LAKE_LDEPTH, and LAKE_DZ over the lake nodes), where vic_tpu's
    writer raises."""
    from vic_tpu.io.state_netcdf_ref import write_state_netcdf_ref as jwrite
    from vic_tpu_torch.io.state_netcdf_ref import _grid
    from vic_tpu_torch.physics.lake import depth_from_volume
    case = Case("lakes_dist")
    with pytest.raises(AttributeError, match="basin_depth"):
        jwrite(str(tmp_path / "raised.nc"), case.jstate, case.jgp,
               case.jdomain, date=DATE, lake_params=case.jlake)
    jpath, tpath = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    write_both(case, jpath, tpath, lakes=True)
    a, b = read_all(jpath), read_all(tpath)
    want = depth_from_volume(case.lake, case.state.lake_volume).numpy()
    assert float(want.min()) > 0.0
    n_lnode = case.arrays["lake_temp"].shape[-1]
    _, _, li, lo = _grid(case.domain.soil)
    for name in a:
        if name == "LAKE_LDEPTH":
            np.testing.assert_array_equal(b[name][4][li, lo], want)
        elif name == "LAKE_DZ":
            np.testing.assert_array_equal(b[name][4][li, lo],
                                          want.astype(float) / n_lnode)
        elif name != "__global__":
            np.testing.assert_array_equal(b[name][4], a[name][4], name)


def test_reference_schema_read_by_both(case, tmp_path):
    """Each package reads the other's file into the same state."""
    from vic_tpu.io.state_netcdf_ref import load_state_netcdf_ref as jload
    from vic_tpu_torch.io.state_netcdf_ref import load_state_netcdf_ref
    jpath, tpath = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    write_both(case, jpath, tpath, lakes=True)
    ref = jarrays(jload(tpath, case.jgp, case.jdomain, case.jtemplate))
    got = load_state_netcdf_ref(jpath, case.gp, case.domain, case.template)
    assert all(getattr(got, k).device.type == "cpu" for k in ref)
    assert_states_equal(got, ref)
    # the schema carries the moisture, snow and node temperatures it names
    for k in ("moist", "swq", "node_temp", "surf_temp_fbcount"):
        mask = case.domain.hru.mask
        np.testing.assert_array_equal(ref[k][mask], case.arrays[k][mask],
                                      err_msg=k)


def test_own_schema_files_equal_and_read_by_both(case, tmp_path):
    from vic_tpu.io.state_io import load_state_netcdf as jload
    from vic_tpu.io.state_io import save_state_netcdf as jsave
    from vic_tpu_torch.io.state_io import (load_state_netcdf,
                                           save_state_netcdf)
    jpath, tpath = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jsave(jpath, case.jstate, case.jgp, DATE)
    save_state_netcdf(tpath, case.state, case.gp, DATE)
    assert_files_equal(jpath, tpath)
    # the carried state, exactly, whichever package wrote or reads it
    assert_states_equal(load_state_netcdf(jpath, case.gp, case.template),
                        case.arrays)
    assert_states_equal(jload(tpath, case.jgp, case.jtemplate), case.arrays)


def test_own_schema_refuses_another_domain(case, tmp_path):
    from vic_tpu_torch.io.state_io import (load_state_netcdf,
                                           save_state_netcdf)
    from vic_tpu_torch.state import initial_state
    from vic_tpu_torch.testing import synthetic_domain
    path = str(tmp_path / "t.nc")
    save_state_netcdf(path, case.state, case.gp, DATE)
    other = initial_state(synthetic_domain(n_cell=N_CELL + 1, n_band=2,
                                           with_glacier=True), case.gp,
                          "cpu", lake_params=None)
    with pytest.raises(ValueError, match="cells"):
        load_state_netcdf(path, case.gp, other)


def test_npz_round_trip_and_read_by_both(case, tmp_path):
    from vic_tpu.io.state_io import load_state_npz as jload
    from vic_tpu.io.state_io import save_state_npz as jsave
    from vic_tpu_torch.io.state_io import load_state_npz, save_state_npz
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jsave(jpath, case.jstate, case.jgp, DATE)
    save_state_npz(tpath, case.state, case.gp, DATE)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_states_equal(load_state_npz(jpath, case.gp, case.template),
                        case.arrays)
    assert_states_equal(jload(tpath, case.jgp, case.jtemplate), case.arrays)


@pytest.mark.parametrize("fmt,with_domain,netcdf", [
    ("NETCDF", True, True), ("NETCDF", False, True),
    ("NETCDF", True, False), ("ASCII", False, True)])
def test_save_and_load_dispatch_as_vic_tpu(case, tmp_path, monkeypatch, fmt,
                                           with_domain, netcdf):
    """save_state writes where and what vic_tpu's writes (the reference
    schema with a domain, the own schema without, `path + ".npz"` without
    libnetcdf or for a legacy format without a domain), and load_state
    finds each: the port's file read by both packages' load_state."""
    from vic_tpu.io import native as jnative
    from vic_tpu.io.state_io import load_state as jload
    from vic_tpu.io.state_io import save_state as jsave
    from vic_tpu_torch.io import native
    from vic_tpu_torch.io.state_io import load_state, save_state
    if not netcdf:
        monkeypatch.setattr(native, "netcdf_found", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    # without lake_params: vic_tpu's reference-schema writer raises with
    # them (test_reference_schema_lake_depth)
    jsave(jpath, case.jstate, case.jgp, date=DATE, fmt=fmt,
          domain=case.jdomain if with_domain else None, geom=case.jgeom,
          gmb=case.gmb)
    save_state(tpath, case.state, case.gp,
               case.domain if with_domain else None, date=DATE, fmt=fmt,
               geom=case.geom, gmb=case.gmb)
    npz = not netcdf or fmt == "ASCII"
    made = sorted(os.listdir(tmp_path))
    assert made == (["j.npz", "t.npz"] if npz else ["j", "t"])
    if not npz:
        assert_files_equal(jpath, tpath)
    got = load_state(tpath, case.gp, case.template,
                     case.domain if with_domain else None)
    ref = jload(tpath, case.jgp, case.jtemplate,
                domain=case.jdomain if with_domain else None)
    assert_states_equal(got, jarrays(ref))
    if not with_domain or not netcdf:
        assert_states_equal(got, case.arrays)


@pytest.mark.parametrize("netcdf", [True, False])
def test_warm_start_from_netcdf_state_equals_continuous_run(
        tmp_path, monkeypatch, netcdf):
    """tests/test_driver.py's fixture (2 cells x 40 daily records through
    MTCLIM) run whole, and run as 20 records that save a NETCDF state and
    20 that start from it: the reference schema, or without libnetcdf the
    npz that `path + ".npz"` holds."""
    from test_driver import write_fixture
    from test_torch_driver_warm import ROOT_RESIDUAL_TOL, TOL
    from vic_tpu_torch import driver
    from vic_tpu_torch.io import native
    if not netcdf:
        monkeypatch.setattr(native, "netcdf_found", lambda: False)
    gp = tconfig.parse_global_param_file(str(write_fixture(tmp_path,
                                                           fmt="ASCII")))
    whole = driver.run_simulation(gp, progress=False, device="cpu",
                                  write_output=False)
    ax, n = whole.timeaxis, 20
    state_name = str(tmp_path / "state")
    first = gp.replace(endyear=int(ax.year[n - 1]),
                       endmonth=int(ax.month[n - 1]),
                       endday=int(ax.day[n - 1]), save_state=True,
                       state_name=state_name, state_format="NETCDF")
    part = driver.run_simulation(
        first, forcing={k: v[:n] for k, v in whole.forcing.items()},
        progress=False, device="cpu", write_output=False)
    path = driver._state_path(first, (int(ax.year[n - 1]),
                                      int(ax.month[n - 1]),
                                      int(ax.day[n - 1])))
    assert path.endswith("_19950620.nc")
    assert os.path.exists(path) == netcdf
    assert os.path.exists(path + ".npz") != netcdf
    second = gp.replace(startyear=int(ax.year[n]),
                        startmonth=int(ax.month[n]),
                        startday=int(ax.day[n]), init_state=True)
    warm = driver.run_simulation(
        second, forcing={k: v[n:] for k, v in whole.forcing.items()},
        init_state_path=path, progress=False, device="cpu",
        write_output=False)
    assert list(warm.outputs) == list(whole.outputs)
    for k, a in whole.outputs.items():
        np.testing.assert_allclose(warm.outputs[k], a[n:], rtol=TOL,
                                   atol=ROOT_RESIDUAL_TOL.get(k, TOL),
                                   err_msg=k)
    # every field but, in the reference schema without DIST_PRCP, the
    # dry columns it does not carry (inert without DIST_PRCP: the warm run
    # keeps the template's)
    skip = {"moist_dry", "ice_dry", "wdew_dry"} if netcdf else set()
    for f in dataclasses.fields(whole.final_state):
        if f.name in skip:
            continue
        np.testing.assert_allclose(getattr(warm.final_state, f.name).numpy(),
                                   getattr(whole.final_state, f.name).numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f.name)
    # the warm run started from the saved state, not a cold start
    assert not np.array_equal(part.final_state.moist.numpy(),
                              whole.final_state.moist.numpy())
