"""The port's run driver against vic_tpu's on the same reference-format
files: 8 cells x 12 daily records of the main path (a glacier tile, 2 snow
bands, COMPUTE_TREELINE with the July mean supplied in the soil file, daily
BINARY forcing through MTCLIM, an OUTFILE section, BINARY output, an ASCII
state file), from 1995-09-25 with the glacier mass-balance interval
starting 1994-10-01, so a GMB fit falls inside the run.

Both packages run with equal chunk_recs and chunk_cells (the batch-wide
stops run over each cell block). Every aggregated OUT_* and state field is
held at rtol = atol = 1e-4.
"""
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig
from vic_tpu_torch.testing import write_driver_run

torch.set_num_threads(1)

TOL = 1e-4
N_CELL = 8
RUN = dict(n_cell=N_CELL, start=(1995, 9, 25), n_day=12,
           accum_start=(1994, 10, 1), july_tavg=(6.0, 16.0))


def both_runs(root, **chunks):
    """(vic_tpu's RunResult, the port's, their directories) on one set of
    files written twice."""
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_simulation as trun
    jdir, tdir = root / "j", root / "t"
    jg, tg = write_driver_run(jdir, **RUN), write_driver_run(tdir, **RUN)
    jres = jrun(jconfig.parse_global_param_file(jg), progress=False,
                **chunks)
    tres = trun(tconfig.parse_global_param_file(tg), progress=False,
                device="cpu", **chunks)
    return jres, tres, jdir, tdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return both_runs(tmp_path_factory.mktemp("driver"))


@pytest.fixture(scope="module")
def chunked_runs(tmp_path_factory):
    # record chunks of 3 (the GMB boundary at record 6 is one of them) and
    # cell blocks of 3, the last padded with a clone of cell 7
    return both_runs(tmp_path_factory.mktemp("chunked"), chunk_recs=3,
                     chunk_cells=3)


def assert_runs_match(jres, tres):
    assert sorted(tres.outputs) == sorted(jres.outputs)
    for k, a in jres.outputs.items():
        b = tres.outputs[k]
        assert b.shape == np.shape(a) and b.dtype == np.asarray(a).dtype, k
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)
    for f in dataclasses.fields(jres.final_state):
        a = np.asarray(getattr(jres.final_state, f.name))
        b = getattr(tres.final_state, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert len(tres.gmb_results) == len(jres.gmb_results) > 0
    for r, g in zip(jres.gmb_results, tres.gmb_results):
        assert g.date == r.date
        np.testing.assert_array_equal(g.n_points, r.n_points)
        np.testing.assert_allclose(g.b0, r.b0, rtol=TOL, atol=TOL)
        for k in ("b1", "b2"):
            np.testing.assert_allclose(getattr(g, k), getattr(r, k),
                                       rtol=TOL, atol=1e-7, err_msg=k)


def test_run_matches_vic_tpu(runs):
    jres, tres, _, _ = runs
    assert_runs_match(jres, tres)
    assert list(tres.outputs) == list(jres.outputs)      # the files' order
    assert tres.timeaxis.nrecs == 12
    assert [r.date for r in tres.gmb_results] == [(1995, 9, 30)]
    assert np.abs(tres.outputs["OUT_WATER_ERROR"]).max() <= 1e-2
    assert set(tres.stage_s) == {"params", "forcing", "run", "write"}


def test_chunked_run_matches_vic_tpu(chunked_runs, runs):
    jres, tres, _, _ = chunked_runs
    assert_runs_match(jres, tres)
    # three blocks, one fit each, for the same date
    assert [r.date for r in tres.gmb_results] == [(1995, 9, 30)] * 3
    for k, a in runs[1].outputs.items():
        np.testing.assert_allclose(tres.outputs[k], a, rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_written_flux_files_match(runs):
    """Each run's packed BINARY files hold its own outputs exactly (packed
    as the writer packs them), and agree with each other's at 1e-4 (one
    unit where the packing truncates to an integer)."""
    from vic_tpu_torch.output import read_binary_output
    from vic_tpu_torch.testing import binary_readback_error
    jres, tres, jdir, tdir = runs
    files = sorted(f for f in os.listdir(tdir / "results")
                   if f.startswith("fluxes_"))
    assert files == sorted(f for f in os.listdir(jdir / "results")
                           if f.startswith("fluxes_"))
    assert len(files) == N_CELL
    gp = tconfig.parse_global_param_file(str(tdir / "global.txt"))
    names = [v for of in gp.outfiles for v in of.varnames]
    from vic_tpu_torch.driver import load_domain
    soil = load_domain(gp).soil
    for ci, (lat, lng) in enumerate(zip(soil.lat, soil.lng)):
        f = f"fluxes_{lat:.5f}_{lng:.5f}"
        assert binary_readback_error(str(tdir / "results" / f),
                                     tres.outputs, ci, names) == 0.0, f
        assert binary_readback_error(str(jdir / "results" / f),
                                     jres.outputs, ci, names) == 0.0, f
        (mj, dj, cj) = read_binary_output(str(jdir / "results" / f))
        (mt, dt, ct) = read_binary_output(str(tdir / "results" / f))
        assert mt == mj and len(ct) == 15     # 3 layers, 2 bands
        np.testing.assert_array_equal(dt, dj)
        for a, b in zip(cj, ct):
            np.testing.assert_allclose(
                b, a, rtol=TOL, atol=1.0 if a.dtype.kind in "iu" else TOL)


@pytest.mark.parametrize("fmt", ["ASCII", "BINARY"])
def test_state_files_match(runs, tmp_path, fmt):
    """The ASCII state file each run wrote, and each run's final state
    written as BINARY by its own package, read back alike."""
    from vic_tpu.driver import load_domain as jload
    from vic_tpu.io.state_legacy import write_state_legacy
    from vic_tpu_torch.driver import load_domain as tload
    from vic_tpu_torch.io.state_io import load_state, save_state
    from vic_tpu_torch.state import initial_state
    jres, tres, jdir, tdir = runs
    gp = tconfig.parse_global_param_file(str(tdir / "global.txt"))
    domain = tload(gp)
    if fmt == "ASCII":
        jpath = jdir / "results" / "state_19951006"
        tpath = tdir / "results" / "state_19951006"
    else:
        jgp = jconfig.parse_global_param_file(str(jdir / "global.txt"))
        jpath, tpath = tmp_path / "j", tmp_path / "t"
        write_state_legacy(str(jpath), jres.final_state, jgp, jload(jgp),
                           date=(1995, 10, 6), fmt="BINARY")
        save_state(str(tpath), tres.final_state, gp, domain,
                   date=(1995, 10, 6), fmt="BINARY")
    template = initial_state(domain, gp, "cpu")
    a = load_state(str(jpath), gp, template, domain).numpy()
    b = load_state(str(tpath), gp, template, domain).numpy()
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["moist"], tres.final_state.moist.numpy(),
                               rtol=1e-6)


def test_refusals_name_what_is_not_ported(tmp_path):
    """No refusal of a split run is left: where the step stops a loop on a
    test over the whole batch (CLOSE_ENERGY, QUICK_FLUX off:
    driver.batch_wide_stops) the shares vote each such test, and the run
    split over two devices equals the one-device run (2 records). NETCDF
    state, output in shards and a split run of the main path run."""
    from vic_tpu_torch.driver import batch_wide_stops, run_simulation
    from vic_tpu_torch.io.state_io import is_netcdf
    gp = tconfig.parse_global_param_file(write_driver_run(tmp_path, **RUN))
    assert inspect.signature(run_simulation).parameters["device"].default \
        == "cuda"
    assert not batch_wide_stops(gp)
    for flags in (dict(close_energy=True), dict(quick_flux=False)):
        stops = gp.replace(nrecs=2, save_state=False, **flags)
        assert batch_wide_stops(stops)
        one, split = (run_simulation(stops, write_output=False,
                                     progress=False, **kw)
                      for kw in (dict(device="cpu"),
                                 dict(devices=["cpu", "cpu"])))
        for k, v in one.outputs.items():
            np.testing.assert_allclose(
                split.outputs[k], v, rtol=1e-5,
                atol=1e-3 if k.endswith("_ERROR") else 1e-5, err_msg=k)
    res = run_simulation(gp.replace(state_format="NETCDF",
                                    output_format="NETCDF", output_shards=2),
                         devices=["cpu", "cpu"], progress=False)
    made = sorted(os.listdir(gp.result_dir))
    assert [f for f in made if ".shard" in f] == [
        "results.shard0of2.nc", "results.shard1of2.nc"]
    state = [f for f in made if f.startswith("state_")]
    assert state == ["state_19951006.nc"]
    assert is_netcdf(os.path.join(gp.result_dir, state[0]))
    assert res.final_state.moist.shape[0] == N_CELL
