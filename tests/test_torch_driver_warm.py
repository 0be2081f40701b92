"""The port's run driver against vic_tpu's on the repo's other driver
inputs: a warm start from the reference-written state files of
tests/fixtures/ref_state (2 cells x 40 3-hourly records of supplied
forcing, no OUTFILE section, so every OUT_* the step makes), and
tests/test_driver.py's fixture (2 cells x 40 daily records through MTCLIM)
through `python -m vic_tpu_torch ... --device cpu` with ASCII output and
through run_simulation with NETCDF output. Every aggregated OUT_* and
state field at rtol = atol = 1e-4, but OUT_ENERGY_ERROR: the residual of
the surface balance at a root held to the Brent tolerance (1e-4 C) on a
slope of up to ~100 W/m^2/C, at 1e-2 W/m^2 (1.3e-3 measured on the
40-day fixture; ROADMAP.md queue 3, residual-at-root leaves).
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_STATE = os.path.join(ROOT, "tests", "fixtures", "ref_state")
TOL = 1e-4
ROOT_RESIDUAL_TOL = {"OUT_ENERGY_ERROR": 1e-2}     # W/m^2


def ref_state_global(root):
    for name in ("soil.txt", "veglib.txt", "vegparam.txt"):
        shutil.copy(os.path.join(REF_STATE, name), root / name)
    shutil.copytree(os.path.join(REF_STATE, "forcing"), root / "forcing")
    (root / "results").mkdir()
    text = open(os.path.join(REF_STATE, "global.txt")).read()
    path = root / "global.txt"
    path.write_text(text.replace("@FIXDIR@", str(root)))
    return str(path)


def assert_match(jres, tres):
    assert list(tres.outputs) == list(jres.outputs)
    for k, a in jres.outputs.items():
        np.testing.assert_allclose(tres.outputs[k], a, rtol=TOL,
                                   atol=ROOT_RESIDUAL_TOL.get(k, TOL),
                                   err_msg=k)
    for f in dataclasses.fields(jres.final_state):
        a = np.asarray(getattr(jres.final_state, f.name))
        b = getattr(tres.final_state, f.name).numpy()
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=f.name)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_warm_start_from_reference_state(tmp_path, fmt):
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_simulation as trun
    state = os.path.join(REF_STATE, f"state_{fmt}")
    res = []
    for cfg, run, sub, kw in ((jconfig, jrun, "j", {}),
                              (tconfig, trun, "t", {"device": "cpu"})):
        (tmp_path / sub).mkdir()
        gp = cfg.parse_global_param_file(ref_state_global(tmp_path / sub))
        res.append(run(gp.replace(init_state=True), init_state_path=state,
                       progress=False, **kw))
    jres, tres = res
    assert_match(jres, tres)
    # no OUTFILE section: every output the step makes, the water table's too
    assert "OUT_ZWT3" in tres.outputs and "OUT_SWE_BAND" not in tres.outputs
    # the reference's state, not a cold start: the two differ
    cold = trun(tconfig.parse_global_param_file(str(tmp_path / "t" /
                                                     "global.txt")),
                progress=False, device="cpu")
    assert np.abs(cold.outputs["OUT_SOIL_MOIST"]
                  - tres.outputs["OUT_SOIL_MOIST"]).max() > 1.0
    assert os.path.exists(tmp_path / "t" / "results" / "state_19900105")


def read_ascii_fluxes(d):
    return {f: np.loadtxt(d / f) for f in sorted(os.listdir(d))
            if f.startswith("fluxes_")}


def test_cli_on_the_driver_fixture_ascii(tmp_path):
    from test_driver import write_fixture
    from vic_tpu.driver import run_simulation as jrun
    for sub in ("j", "t"):
        (tmp_path / sub).mkdir()
    jg = write_fixture(tmp_path / "j", fmt="ASCII")
    tg = write_fixture(tmp_path / "t", fmt="ASCII")
    jres = jrun(jconfig.parse_global_param_file(str(jg)), progress=False)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "vic_tpu_torch", "-g", str(tg), "--device",
         "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Model execution time" in proc.stderr
    ref, got = read_ascii_fluxes(tmp_path / "j"), read_ascii_fluxes(
        tmp_path / "t")
    assert sorted(got) == sorted(ref) and len(got) == 2
    # the files' columns: the date, then each variable's elements in the
    # order of the run's outputs
    atol = [0.0] * 4
    for k, v in jres.outputs.items():
        atol += [ROOT_RESIDUAL_TOL.get(k, TOL)] * int(np.prod(v.shape[2:]))
    for f, a in ref.items():
        assert got[f].shape == a.shape == (40, len(atol)), f
        np.testing.assert_array_equal(got[f][:, :4], a[:, :4])
        # 6 decimals in the files: the tolerance plus the last digit's
        # rounding
        assert (np.abs(got[f] - a) <= np.asarray(atol) + 1e-6
                + TOL * np.abs(a)).all(), f


def test_run_on_the_driver_fixture_netcdf(tmp_path):
    from test_driver import write_fixture
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_simulation as trun
    from vic_tpu_torch.io.native import NetCDFFile
    res = []
    for cfg, run, sub, kw in ((jconfig, jrun, "j", {}),
                              (tconfig, trun, "t", {"device": "cpu"})):
        (tmp_path / sub).mkdir()
        g = write_fixture(tmp_path / sub, fmt="NETCDF")
        res.append(run(cfg.parse_global_param_file(str(g)), progress=False,
                       **kw))
    assert_match(*res)
    with NetCDFFile(str(tmp_path / "j" / "results.nc")) as fj, \
            NetCDFFile(str(tmp_path / "t" / "results.nc")) as ft:
        assert ft.var_names() == fj.var_names()
        nlat, nlon = fj.dim_len("lat"), fj.dim_len("lon")
        for v in ("EVAP", "RUNOFF", "SWE", "SURF_TEMP", "WATER_ERROR"):
            a = fj.get(v, (0, 0, 0), (40, nlat, nlon))
            b = ft.get(v, (0, 0, 0), (40, nlat, nlon))
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=v)
