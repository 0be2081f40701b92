"""The pieces of the port's run driver against vic_tpu's, on the same files
and arrays: the global-file parser, the parameter readers and load_domain,
prepare_domain's treeline exclusion, the forcing ingest (MTCLIM at daily
and 3-hourly steps, the fully supplied 3-hourly set), the output
aggregation and writers, the packed binary reader, the legacy state files,
the GMB fit and the cell blocks.

Host numpy work is held at rtol = atol = 1e-5; readers, writers and the
parser exactly.
"""
import dataclasses
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig
from vic_tpu_torch.testing import write_driver_run

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_STATE = os.path.join(ROOT, "tests", "fixtures", "ref_state")
REF_BINARY = os.path.join(ROOT, "tests", "fixtures", "ref_binary")
HOST_TOL = 1e-5


def plain(value):
    """Dataclasses, enums, arrays and tensors of either package as plain
    data."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return plain(value.numpy())
    if isinstance(value, np.ndarray):
        # bytes: bit for bit, NaN included
        return (value.dtype.str, value.shape,
                np.ascontiguousarray(value).tobytes())
    if hasattr(value, "name") and hasattr(value, "value"):
        return (type(value).__name__, value.name, value.value)
    return value


def assert_fields_equal(got, ref, what):
    a, b = plain(ref), plain(got)
    if isinstance(a, dict):
        assert sorted(b) == sorted(a), what
        for k in a:
            assert b[k] == a[k], f"{what}: {k}"
    else:
        assert b == a, what


def ref_state_global(tmp_path):
    """tests/fixtures/ref_state relocated, @FIXDIR@ substituted."""
    for name in ("soil.txt", "veglib.txt", "vegparam.txt"):
        shutil.copy(os.path.join(REF_STATE, name), tmp_path / name)
    shutil.copytree(os.path.join(REF_STATE, "forcing"), tmp_path / "forcing")
    (tmp_path / "results").mkdir()
    text = open(os.path.join(REF_STATE, "global.txt")).read()
    path = tmp_path / "global.txt"
    path.write_text(text.replace("@FIXDIR@", str(tmp_path)))
    return str(path)


def driver_global(tmp_path, **kw):
    args = dict(n_cell=5, start=(1995, 9, 25), n_day=12,
                accum_start=(1994, 10, 1), july_tavg=(6.0, 16.0))
    args.update(kw)
    return write_driver_run(tmp_path, **args)


@pytest.fixture(params=["ref_state", "driver", "driver_substep",
                        "test_driver"])
def global_file(request, tmp_path):
    if request.param == "ref_state":
        return ref_state_global(tmp_path)
    if request.param == "driver":
        return driver_global(tmp_path)
    if request.param == "driver_substep":
        return driver_global(tmp_path, snow_step=3, output_format="ASCII",
                             july_tavg=None, n_day=40, start=(1996, 6, 20))
    from test_driver import write_fixture
    return str(write_fixture(tmp_path, fmt="ASCII"))


def test_parse_global_param_file_field_for_field(global_file):
    ref = jconfig.parse_global_param_file(global_file)
    got = tconfig.parse_global_param_file(global_file)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert_fields_equal(got, ref, "GlobalParams")


def test_load_domain_field_for_field(global_file):
    from vic_tpu.driver import load_domain as jload
    from vic_tpu_torch.driver import load_domain as tload
    ref = jload(jconfig.parse_global_param_file(global_file))
    got = tload(tconfig.parse_global_param_file(global_file))
    for part in ("soil", "veglib", "hru", "bands"):
        assert_fields_equal(getattr(got, part), getattr(ref, part), part)
    assert_fields_equal(got.cell_valid, ref.cell_valid, "cell_valid")


def test_readers_one_by_one(tmp_path):
    from vic_tpu.io import snowband as jband, soil as jsoil, veg as jveg
    from vic_tpu_torch.io import snowband as tband, soil as tsoil, veg as tveg
    g = driver_global(tmp_path)
    jgp, tgp = jconfig.parse_global_param_file(g), \
        tconfig.parse_global_param_file(g)
    js, ts = (jsoil.read_soil_file(jgp.soil_file, jgp),
              tsoil.read_soil_file(tgp.soil_file, tgp))
    assert_fields_equal(ts, js, "read_soil_file")
    assert jsoil.cell_area_m2(50.03, -118.2, 0.0625) == \
        tsoil.cell_area_m2(50.03, -118.2, 0.0625)
    jlib, tlib = (jveg.read_veglib(jgp.veglib_file),
                  tveg.read_veglib(tgp.veglib_file))
    assert_fields_equal(tlib, jlib, "read_veglib")
    jt = jveg.read_vegparam_cell_tiles(jgp.veg_file, jgp)
    tt = tveg.read_vegparam_cell_tiles(tgp.veg_file, tgp)
    assert_fields_equal(tt, jt, "read_vegparam_cell_tiles")
    jh = jveg.build_hru_params(jt, js.gridcel, jlib, jgp, js.depth)
    th = tveg.build_hru_params(tt, ts.gridcel, tlib, tgp, ts.depth)
    assert_fields_equal(th, jh, "build_hru_params")
    assert th.is_glacier.any() and th.is_bare.any()
    jb = jband.read_snowband_file(jgp.snowband_file, js, 2)
    tb = tband.read_snowband_file(tgp.snowband_file, ts, 2)
    assert_fields_equal(tb, jb, "read_snowband_file")
    assert_fields_equal(tband.default_bands(ts, 3), jband.default_bands(js, 3),
                        "default_bands")


@pytest.mark.parametrize("profile", [False, True])
def test_read_lakeparam_file(tmp_path, profile):
    from vic_tpu.io.lakeparam import read_lakeparam_file as jread
    from vic_tpu.io.soil import read_soil_file
    from vic_tpu_torch.io.lakeparam import read_lakeparam_file as tread
    g = driver_global(tmp_path)
    gp = jconfig.parse_global_param_file(g).replace(lake_profile=profile)
    soil = read_soil_file(gp.soil_file, gp)
    lines = []
    for i, cell in enumerate(soil.gridcel):
        if i == 2:
            continue                      # a cell without a lake
        pairs = ("8.0 0.05 5.0 0.03 2.0 0.01" if profile
                 else "6.5 0.04")
        lines.append(f"{cell} 0 {3 if profile else 10} 1.5 0.01 4.0 0.3 "
                     f"{pairs}")
    lines.append("999 0 3 1 0.01 4 0.3 " + ("1 0.1 " * 3 if profile
                                              else "1 0.1"))
    path = tmp_path / "lakes.txt"
    path.write_text("\n".join(lines) + "\n")
    ref = jread(str(path), soil, gp)
    got = tread(str(path), soil, gp)
    assert list(got) == [f.name for f in dataclasses.fields(ref)]
    for k, v in got.items():
        a = np.asarray(getattr(ref, k))
        np.testing.assert_allclose(np.asarray(v, a.dtype), a, rtol=HOST_TOL,
                                   atol=HOST_TOL, err_msg=k)
    assert got["has_lake"].sum() == soil.n_cell - 1


def test_prepare_domain_with_above_treeline(tmp_path):
    from vic_tpu.driver import load_domain as jload
    from vic_tpu.prepare import prepare_domain as jprep
    from vic_tpu_torch.driver import load_domain as tload
    from vic_tpu_torch.physics.hydrology_misc import compute_treeline
    from vic_tpu_torch.prepare import prepare_domain as tprep
    g = driver_global(tmp_path, n_cell=12)
    jd = jload(jconfig.parse_global_param_file(g))
    td = tload(tconfig.parse_global_param_file(g))
    above = compute_treeline(td.soil.avg_july_air_temp, td.bands.tfactor)
    assert above.any() and not above.all()
    ref = jprep(jd, jconfig.parse_global_param_file(g), above_treeline=above)
    got = tprep(td, tconfig.parse_global_param_file(g), "cpu",
                above_treeline=above).numpy()
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
    plain_mask = tprep(td, tconfig.parse_global_param_file(g), "cpu").mask
    assert int(plain_mask.sum()) > int(got["mask"].sum())


def test_treeline_functions():
    from vic_tpu.physics import hydrology_misc as jh
    from vic_tpu_torch.physics import hydrology_misc as th
    rng = np.random.default_rng(3)
    air = rng.normal(10.0, 6.0, (400, 7))
    months = (np.arange(400) // 30) % 12 + 1
    np.testing.assert_array_equal(th.july_avg_temperature(air, months),
                                  jh.july_avg_temperature(air, months))
    assert np.isnan(th.july_avg_temperature(air, np.ones(400))).all()
    tf = rng.normal(0.0, 2.0, (7, 3))
    july = th.july_avg_temperature(air, months)
    np.testing.assert_array_equal(th.compute_treeline(july, tf),
                                  jh.compute_treeline(july, tf))


def _ingest_pair(g, nf_substep=True):
    """Both packages' ingest_forcing on global file `g`, with the driver's
    NF sub-stepping applied first."""
    from vic_tpu.driver import load_domain as jload
    from vic_tpu.forcing.ingest import ingest_forcing as jingest
    from vic_tpu.timeaxis import time_axis_from_params as jaxis
    from vic_tpu_torch.driver import load_domain as tload
    from vic_tpu_torch.forcing.ingest import ingest_forcing as tingest
    from vic_tpu_torch.timeaxis import time_axis_from_params as taxis
    out = []
    for cfg, load, axis, ingest in ((jconfig, jload, jaxis, jingest),
                                    (tconfig, tload, taxis, tingest)):
        gp = cfg.parse_global_param_file(g)
        if nf_substep and gp.snow_step < gp.dt:
            gp = gp.replace(dt=gp.snow_step)
        ax = axis(gp)
        out.append(ingest(gp, load(gp), ax))
    return out


@pytest.mark.parametrize("snow_step", [24, 3])
def test_ingest_forcing_mtclim(tmp_path, snow_step):
    g = driver_global(tmp_path, snow_step=snow_step, n_day=20)
    ref, got = _ingest_pair(g)
    assert sorted(got) == sorted(ref)
    n_rec = 20 * 24 // snow_step
    for k, a in ref.items():
        assert got[k].shape == a.shape == (n_rec, 5), k
        assert got[k].dtype == np.float64, k
        np.testing.assert_allclose(got[k], a, rtol=HOST_TOL, atol=HOST_TOL,
                                   err_msg=k)


def test_ingest_forcing_supplied_subdaily(tmp_path):
    ref, got = _ingest_pair(ref_state_global(tmp_path))
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=HOST_TOL, atol=HOST_TOL,
                                   err_msg=k)


def test_mtclim_solar_geometry():
    from vic_tpu.forcing.mtclim import solar_geometry as jgeo
    from vic_tpu_torch.forcing.mtclim import solar_geometry as tgeo
    lat = np.array([-33.0, 0.5, 49.03125, 66.0, 78.0])
    elev = np.array([10.0, 1500.0, 900.0, 2600.0, 300.0])
    ref, got = jgeo(lat, elev, 8), tgeo(lat, elev, 8)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_forcing_helpers():
    from vic_tpu.forcing import ingest as ji
    from vic_tpu_torch.forcing import ingest as ti
    assert ti.cell_forcing_path("a/b_", 49.03125, -120.96875, 5) == \
        ji.cell_forcing_path("a/b_", 49.03125, -120.96875, 5)
    f = {"prec": np.arange(12.0).reshape(4, 3), "wind": np.ones((4, 3))}
    assert ti.forcing_stats(f) == ji.forcing_stats(f)


def random_outputs(n_rec, n_cell, seed=0):
    """Per-record outputs of every aggregation type and extra dimension."""
    rng = np.random.default_rng(seed)
    names = {"OUT_PREC": (), "OUT_EVAP": (), "OUT_SWE": (),
             "OUT_SOIL_MOIST": (3,), "OUT_SURF_TEMP": (), "OUT_SWE_BAND": (2,),
             "OUT_AERO_COND": (), "OUT_AERO_RESIST": (),
             "OUT_WATER_ERROR": (), "OUT_SOIL_TNODE": (3,), "OUT_ZWT": ()}
    return {k: rng.normal(5.0, 20.0, (n_rec, n_cell) + s).astype(np.float32)
            for k, s in names.items()}


@pytest.mark.parametrize("steps,alma", [(1, False), (1, True), (4, False),
                                        (3, True)])
def test_aggregate_outputs(steps, alma):
    from vic_tpu.output import aggregate_outputs as jagg
    from vic_tpu_torch.output import aggregate_outputs as tagg
    outs = random_outputs(12, 4)
    ref = jagg(outs, steps, alma=alma, out_dt_sec=steps * 3 * 3600.0)
    got = tagg(outs, steps, alma=alma, out_dt_sec=steps * 3 * 3600.0)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _axis(n, dt):
    from vic_tpu_torch.timeaxis import make_time_axis
    return make_time_axis(1996, 2, 27, 0, n, dt)


@pytest.mark.parametrize("out_dt", [24, 3])
def test_binary_writers_write_identical_bytes(tmp_path, out_dt):
    from vic_tpu.config import OutVarSpec
    from vic_tpu.output import BinaryOutputWriter as J
    from vic_tpu_torch.output import BinaryOutputWriter as T
    from vic_tpu_torch.output import read_binary_output
    outs = random_outputs(6, 3, seed=1)
    names = list(outs)
    specs = {"OUT_SURF_TEMP": OutVarSpec("OUT_SURF_TEMP", "%.4f",
                                         "OUT_TYPE_SINT", 100.0),
             "OUT_WATER_ERROR": OutVarSpec("OUT_WATER_ERROR", "*",
                                           "OUT_TYPE_DOUBLE", 1.0),
             "OUT_SWE": OutVarSpec("OUT_SWE", "*", "OUT_TYPE_USINT", 0.0)}
    lats, lons = [49.03125, 49.09375, 49.15625], [-120.5] * 3
    ax = _axis(6, out_dt)
    for cls, sub in ((J, "j"), (T, "t")):
        w = cls(str(tmp_path / sub), "fluxes", lats, lons, names,
                grid_decimal=5, nrecs=6, out_dt=out_dt,
                start_date=(1996, 2, 27, 0), outvar_specs=specs)
        w.write_all(outs, ax)
        w.close()
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) and len(files) == 3
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    meta, dates, cols = read_binary_output(str(tmp_path / "t" / files[1]))
    assert meta["nrecs"] == 6 and len(cols) == 1 + 1 + 1 + 3 + 1 + 2 + 1 \
        + 1 + 1 + 3 + 1
    np.testing.assert_array_equal(cols[0], outs["OUT_PREC"][:, 1])


@pytest.mark.parametrize("compress", [False, True])
def test_ascii_writers_write_identical_text(tmp_path, compress):
    from vic_tpu.output import AsciiOutputWriter as J
    from vic_tpu_torch.output import AsciiOutputWriter as T
    outs = random_outputs(5, 3, seed=2)
    outs["OUT_PREC"][0, 0] = -0.0
    lats, lons = [49.03125, 49.09375, 49.15625], [-120.5] * 3
    for cls, sub in ((J, "j"), (T, "t")):
        w = cls(str(tmp_path / sub), "fluxes", lats, lons, list(outs),
                grid_decimal=5, compress=compress)
        w.write_all(outs, _axis(5, 24))
        w.close()
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) and len(files) == 3
    for f in files:
        read = (lambda p: gzip.open(p).read()) if compress else \
            (lambda p: open(p, "rb").read())
        assert read(tmp_path / "t" / f) == read(tmp_path / "j" / f), f


def test_netcdf_writers_write_the_same_values(tmp_path):
    from vic_tpu.io.native import NetCDFFile
    from vic_tpu.output import NetCDFOutputWriter as J
    from vic_tpu_torch.io import native as tnative
    from vic_tpu_torch.output import NetCDFOutputWriter as T
    assert tnative.netcdf_found()
    outs = random_outputs(4, 3, seed=3)
    lats, lons = [49.0, 49.0, 49.0625], [-120.5, -120.4375, -120.5]
    tvals = np.arange(4.0)
    for cls, name in ((J, "j.nc"), (T, "t.nc")):
        w = cls(str(tmp_path / name), np.array(lats), np.array(lons),
                list(outs), nlayer=3, nnode=3, nband=2,
                global_attrs={"title": "x"})
        w.write_all(outs, tvals)
        w.close()
    with NetCDFFile(str(tmp_path / "j.nc")) as fj, \
            tnative.NetCDFFile(str(tmp_path / "t.nc")) as ft:
        assert ft.var_names() == fj.var_names()
        for dim in ("time", "depth", "node", "band", "lat", "lon"):
            assert ft.dim_len(dim) == fj.dim_len(dim), dim
        for v in fj.var_names():
            nd = {"time": 1, "lat": 1, "lon": 1}.get(v, None)
            if nd:
                shape = (fj.dim_len(v),)
            else:
                n3 = {"SOIL_MOIST": 3, "SOIL_TNODE": 3, "SWE_BAND": 2}
                shape = (4,) + ((n3[v],) if v in n3 else ()) + (2, 2)
            a = fj.get(v, (0,) * len(shape), shape)
            b = ft.get(v, (0,) * len(shape), shape)
            np.testing.assert_array_equal(b, a, err_msg=v)


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(REF_BINARY) if not f.startswith("fluxes_ascii")))
def test_read_binary_output_on_the_reference_files(name):
    from vic_tpu.output import read_binary_output as jread
    from vic_tpu_torch.output import read_binary_output as tread
    path = os.path.join(REF_BINARY, name)
    (mj, dj, cj), (mt, dt, ct) = jread(path), tread(path)
    assert mt == mj
    np.testing.assert_array_equal(dt, dj)
    assert len(ct) == len(cj) > 0
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("fmt", ["ASCII", "BINARY"])
def test_legacy_state_writer_and_reader(tmp_path, fmt):
    """From the same state values both packages write the same bytes, and
    both readers read them back alike."""
    from vic_tpu.driver import load_domain as jload
    from vic_tpu.io.state_legacy import (load_state_legacy as jloadst,
                                         write_state_legacy as jwrite)
    from vic_tpu.state import initial_state as jinit
    from vic_tpu_torch.driver import load_domain as tload
    from vic_tpu_torch.io.state_io import load_state, save_state
    from vic_tpu_torch.state import ModelState, initial_state as tinit
    g = driver_global(tmp_path)
    jgp, tgp = jconfig.parse_global_param_file(g), \
        tconfig.parse_global_param_file(g)
    jd, td = jload(jgp), tload(tgp)
    rng = np.random.default_rng(4)
    tmpl = tinit(td, tgp, "cpu").numpy()
    values = {}
    for k, v in tmpl.items():
        if v.dtype.kind == "f":
            values[k] = (v + rng.normal(0.0, 3.0, v.shape)).astype(v.dtype)
        elif v.dtype.kind == "i":
            values[k] = rng.integers(-2, 9, v.shape).astype(v.dtype)
        else:
            values[k] = rng.random(v.shape) < 0.5
    tstate = ModelState(**{k: torch.as_tensor(v) for k, v in values.items()})
    import jax.numpy as jnp
    from vic_tpu.state import ModelState as JState
    jstate = JState(**{k: jnp.asarray(v) for k, v in values.items()})
    jwrite(str(tmp_path / "j"), jstate, jgp, jd, date=(1995, 10, 6), fmt=fmt)
    save_state(str(tmp_path / "t"), tstate, tgp, td, date=(1995, 10, 6),
               fmt=fmt)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    ref = jloadst(str(tmp_path / "j"), jgp, jd, jinit(jd, jgp), fmt=fmt)
    got = load_state(str(tmp_path / "t"), tgp, tinit(td, tgp, "cpu"), td)
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def test_gmb_fit_and_accumulator():
    from vic_tpu.physics.gmb import fit_gmb_polynomials as jfit
    from vic_tpu_torch.physics.gmb import fit_gmb_polynomials as tfit
    from vic_tpu_torch.physics.gmb import GmbAccumulator
    rng = np.random.default_rng(5)
    cum = rng.normal(0.0, 1.0, (6, 8)).astype(np.float32)
    elev = rng.choice([1000.0, 1200.0, 1500.0, 1900.0], (6, 8))
    glac = rng.random((6, 8)) < 0.6
    glac[0] = False
    glac[1] = [True] + [False] * 7
    ref, got = jfit(cum, elev, glac, (1996, 9, 30)), \
        tfit(cum, elev, glac, (1996, 9, 30))
    assert_fields_equal(got, ref, "fit_gmb_polynomials")
    acc = GmbAccumulator(tconfig.GlobalParams(glacier_accum_start_year=1994,
                                              glacier_accum_start_month=10,
                                              glacier_accum_interval=2))
    assert acc.boundary(1996, 10, 1) and not acc.boundary(1995, 10, 1)


def test_cell_blocks_match_vic_tpu():
    from vic_tpu.parallel.sharding import (pad_cell_tree as jpad,
                                           slice_cell_tree as jslice,
                                           unpad_cell_tree as junpad)
    from vic_tpu.parallel.sharding import pad_cells as jpad_cells
    from vic_tpu_torch.cells import (pad_cell_tree, slice_cell_tree,
                                     tree_map, unpad_cell_tree)
    from vic_tpu_torch.parallel.sharding import pad_cells
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(7, 3)), "b": rng.normal(size=(7,)),
            "c": rng.normal(size=(2, 7)), "d": np.arange(4.0)}
    ttree = tree_map(torch.as_tensor, tree)
    for axis in (0, 1):
        ref = jpad(jslice(tree, 2, 6, 7, axis=axis), 4, 3, axis=axis)
        got = pad_cell_tree(slice_cell_tree(ttree, 2, 6, 7, axis=axis), 4, 3,
                            axis=axis)
        gotn = pad_cell_tree(slice_cell_tree(tree, 2, 6, 7, axis=axis), 4, 3,
                             axis=axis)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
            np.testing.assert_array_equal(gotn[k], ref[k], err_msg=k)
        back = unpad_cell_tree(got, 7, 4, axis=axis)
        jback = junpad(ref, 7, 4, axis=axis)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), jback[k])
    assert pad_cells(10, 4) == 12 and pad_cells(8, 4) == 8
    for n, d in ((10, 4), (8, 4), (7, 3), (1, 8)):
        assert pad_cells(n, d) == jpad_cells(n, d)


def test_native_readers_match(tmp_path):
    from vic_tpu.io import native as jn
    from vic_tpu_torch.io import native as tn
    g = driver_global(tmp_path)
    path = next(str(p) for p in (tmp_path / "forcing").iterdir())
    args = ([False, True, True, False], [40.0, 100.0, 100.0, 100.0], 12)
    np.testing.assert_array_equal(tn.read_vic_binary(path, *args),
                                  jn.read_vic_binary(path, *args))
    table = tmp_path / "table.txt"
    table.write_text("# c\n1 2 3\n4.5 -6 7e3\n")
    np.testing.assert_array_equal(tn.read_ascii_table(str(table), 3),
                                  jn.read_ascii_table(str(table), 3))
    assert os.path.exists(g)


@pytest.mark.parametrize("fmt", ["ASCII", "NETCDF"])
def test_output_force_writes_the_disaggregated_forcing(tmp_path, fmt):
    """OUTPUT_FORCE: the forcing pipeline only, its files as vic_tpu's."""
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_simulation as trun
    res = []
    for cfg, run, sub, kw in ((jconfig, jrun, "j", {}),
                              (tconfig, trun, "t", {"device": "cpu"})):
        g = driver_global(tmp_path / sub, n_day=6, output_format=fmt)
        gp = cfg.parse_global_param_file(g).replace(output_force=True)
        res.append(run(gp, progress=False, **kw))
    assert res[1].final_state is None
    assert list(res[1].outputs) == list(res[0].outputs)
    for k, a in res[0].outputs.items():
        np.testing.assert_allclose(res[1].outputs[k], a, rtol=HOST_TOL,
                                   atol=HOST_TOL, err_msg=k)
    if fmt == "ASCII":
        files = sorted(f for f in os.listdir(tmp_path / "j" / "results")
                       if f.startswith("full_data_"))
        assert len(files) == 5
        for f in files:
            a = np.loadtxt(tmp_path / "j" / "results" / f)
            b = np.loadtxt(tmp_path / "t" / "results" / f)
            np.testing.assert_allclose(b, a, rtol=HOST_TOL, atol=2e-6)
    else:
        assert (tmp_path / "t" / "results" / "results.nc").exists()


def test_memory_budget_estimate_and_warning(tmp_path, capsys):
    from vic_tpu.driver import check_memory_budget as jcheck
    from vic_tpu.driver import load_domain as jload
    from vic_tpu_torch.driver import check_memory_budget as tcheck
    from vic_tpu_torch.driver import load_domain as tload
    g = driver_global(tmp_path)
    jgp = jconfig.parse_global_param_file(g).replace(max_memory=1e-6)
    tgp = tconfig.parse_global_param_file(g).replace(max_memory=1e-6)
    ref = jcheck(jgp, jload(jgp), 12, n_cell=3)
    jwarn = capsys.readouterr().err
    got = tcheck(tgp, tload(tgp), 12, n_cell=3)
    assert got == ref
    assert "consider --chunk" in capsys.readouterr().err == jwarn != ""


def test_water_closure_rule():
    """|OUT_WATER_ERROR| <= tol, or on records where snow melts tol + the
    liquid-water capacity (0.035) of the previous record's OUT_SWE."""
    from vic_tpu_torch.testing import water_closure
    werr = np.array([[0.001, 0.0], [-0.314, 0.0255], [0.02, 0.0]])
    swe = np.array([[61.0, 87.7], [0.0, 48.1], [0.0, 40.0]])
    melt = np.array([[0.0, 5.0], [63.1, 41.2], [0.0, 8.1]])
    out = {"OUT_WATER_ERROR": werr, "OUT_SWE": swe, "OUT_SNOW_MELT": melt}
    excess, n_melt, werr_melt, werr_off = water_closure(out, 1e-2)
    assert n_melt == 2 and werr_melt == 0.314 and werr_off == 0.02
    assert excess == pytest.approx(0.01)       # no melt on the last record
    out["OUT_WATER_ERROR"][2, 0] = 0.005
    assert water_closure(out, 1e-2)[0] < 0
    out["OUT_WATER_ERROR"][1, 1] = 4.0         # beyond 0.035 x 87.7 mm
    assert water_closure(out, 1e-2)[0] == pytest.approx(
        4.0 - 0.01 - 0.035 * 87.7)


def test_ingest_forcing_netcdf(tmp_path):
    """One all-cells NetCDF forcing file (tools/make_production_domain.py),
    read through the port's native library as vic_tpu reads it."""
    import sys
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_production_domain import write_domain
    write_domain(str(tmp_path), 6, 10)
    ref, got = _ingest_pair(str(tmp_path / "global.txt"))
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        assert got[k].shape == a.shape == (10, 6), k
        np.testing.assert_allclose(got[k], a, rtol=HOST_TOL, atol=HOST_TOL,
                                   err_msg=k)
