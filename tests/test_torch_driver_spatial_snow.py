"""The port's run driver with SPATIAL_SNOW, CORRPREC and CONTINUEONERROR
against vic_tpu's, on the same reference-format files (testing
.write_driver_run: 4 cells, a glacier tile, 2 snow bands, daily BINARY
forcing through MTCLIM) from 1996-03-15, when the first snows on bare
ground come and go in partial patches.

CORRPREC and CONTINUEONERROR come from the global file. SPATIAL_SNOW is the
reference's compile-time option (user_def.h): vic_tpu's global-file parser
has no keyword for it and skips a SPATIAL_SNOW line, and so does the port's
copy; both packages take it on the GlobalParams. So:

- `python -m vic_tpu_torch -g` (run_main) on a global file with
  SPATIAL_SNOW TRUE, CORRPREC TRUE and CONTINUEONERROR TRUE against
  vic_tpu's run_simulation of the same file;
- run_simulation with spatial_snow set over the 12 records, then a warm
  start of both from one ASCII state file written after 8 (it carries
  depth_full_snow_cover under SPATIAL_SNOW) over the last 4: the legacy
  format does not carry the depletion curve's memory, so both packages
  restart it from the cold start's and the coverage from the pack
  (initialize_model_state.c:327ff), and their runs agree.

Every aggregated OUT_* and state field at rtol = atol = 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig
from vic_tpu_torch.testing import write_driver_run

torch.set_num_threads(1)

TOL = 1e-4
N_CELL = 4
N_DAY, N_FIRST = 12, 8
RUN = dict(n_cell=N_CELL, start=(1996, 3, 15), n_day=N_DAY,
           accum_start=(1995, 10, 1), july_tavg=(6.0, 16.0))
OPTIONS = "SPATIAL_SNOW TRUE\nCORRPREC TRUE\nCONTINUEONERROR TRUE\n"
EXTRA_OUTVARS = ("OUT_SNOW_COVER", "OUT_ADV_SENS", "OUT_PREC")


def write_run(root):
    """write_driver_run's files with the three options and OUT_SNOW_COVER
    and OUT_ADV_SENS in the OUTFILE section."""
    path = write_driver_run(root, **RUN)
    text = open(path).read()
    text = text.replace("FULL_ENERGY TRUE\n", "FULL_ENERGY TRUE\n" + OPTIONS)
    head, tail = text.split("OUTFILE fluxes ")
    n, rest = tail.split("\n", 1)
    extra = "".join(f"OUTVAR {v} %.4f OUT_TYPE_FLOAT 1\n"
                    for v in EXTRA_OUTVARS[:2])
    with open(path, "w") as f:
        f.write(f"{head}OUTFILE fluxes {int(n) + 2}\n{extra}{rest}")
    return path


def assert_match(jres, tres):
    assert sorted(tres.outputs) == sorted(jres.outputs)
    for k, a in jres.outputs.items():
        np.testing.assert_allclose(tres.outputs[k], a, rtol=TOL, atol=TOL,
                                   err_msg=k)
    for f in dataclasses.fields(jres.final_state):
        a = np.asarray(getattr(jres.final_state, f.name))
        b = getattr(tres.final_state, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)


def test_cli_runs_the_options_of_its_global_file(tmp_path):
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_main
    jg, tg = write_run(tmp_path / "j"), write_run(tmp_path / "t")
    jgp = jconfig.parse_global_param_file(jg)
    tgp = tconfig.parse_global_param_file(tg)
    assert tgp.corrprec and tgp.continue_on_error and not tgp.spatial_snow
    assert (jgp.corrprec, jgp.continue_on_error, jgp.spatial_snow) == \
        (True, True, False)
    jres = jrun(jgp, progress=False)
    tres = run_main(["-g", tg, "--device", "cpu"])
    assert_match(jres, tres)
    assert (tres.outputs["OUT_CELL_VALID"] == 1.0).all()
    assert np.abs(tres.outputs["OUT_WATER_ERROR"]).max() <= 1e-2


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """Both packages' runs with SPATIAL_SNOW over all N_DAY records, then
    both from one ASCII state file written after N_FIRST records (by the
    port's run of those records) over the rest, on the whole run's forcing:
    (whole j, whole t, warm j, warm t, the port's whole run without
    SPATIAL_SNOW)."""
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import _state_path
    from vic_tpu_torch.driver import run_simulation as trun
    root = tmp_path_factory.mktemp("spatial_driver")
    runs = ((jconfig, jrun, "j", {}), (tconfig, trun, "t", {"device": "cpu"}))
    out = []
    for cfg, run, sub, kw in runs:
        gp = cfg.parse_global_param_file(write_run(root / sub))
        out.append(run(gp.replace(spatial_snow=True), progress=False, **kw))
    forcing = out[1].forcing
    gp = tconfig.parse_global_param_file(str(root / "t" / "global.txt"))
    gp_b = gp.replace(spatial_snow=True, endday=14 + N_FIRST,
                      state_name=str(root / "state_b"))
    trun(gp_b, forcing={k: v[:N_FIRST] for k, v in forcing.items()},
         write_output=False, progress=False, device="cpu")
    state = _state_path(gp_b, (1996, 3, 14 + N_FIRST))
    for cfg, run, sub, kw in runs:
        gp = cfg.parse_global_param_file(str(root / sub / "global.txt"))
        gp = gp.replace(spatial_snow=True, startday=15 + N_FIRST,
                        init_state=True, save_state=False)
        out.append(run(gp, forcing={k: v[N_FIRST:]
                                    for k, v in forcing.items()},
                       init_state_path=state, write_output=False,
                       progress=False, **kw))
    gp = tconfig.parse_global_param_file(str(root / "t" / "global.txt"))
    out.append(trun(gp, forcing=forcing, write_output=False, progress=False,
                    device="cpu"))
    return out


def test_spatial_snow_run_matches_vic_tpu(split_runs):
    jres, tres = split_runs[:2]
    assert tres.timeaxis.nrecs == N_DAY
    assert_match(jres, tres)
    assert (tres.outputs["OUT_CELL_VALID"] == 1.0).all()
    # the first snows cover their lanes in part: without SPATIAL_SNOW the
    # coverage differs
    full = split_runs[4]
    assert np.abs(full.outputs["OUT_SNOW_COVER"]
                  - tres.outputs["OUT_SNOW_COVER"]).max() > 0.01


def test_warm_start_restarts_the_depletion_memory_as_vic_tpu(split_runs):
    jres, tres = split_runs[2:4]
    assert tres.timeaxis.nrecs == N_DAY - N_FIRST
    assert_match(jres, tres)
