"""The port's run driver against vic_tpu's on reference-format files that
switch frozen soil on as its users set it up: FROZEN_SOIL TRUE, QUICK_FLUX
FALSE, NODES 10, EXP_TRANS TRUE (vic_tpu_torch.testing.write_driver_run's
files, 4 cells x 4 daily records of January, so the soil freezes).

Every aggregated OUT_* and final-state field is held at rtol = atol =
1e-4, the layer ice at rtol 1e-3 (vic_tpu_torch.testing.FROZEN_ICE_RTOL),
and the ASCII state files the two drivers write, read back alike, carry
10 node temperatures that agree at 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig
from vic_tpu_torch.testing import FROZEN_ICE_RTOL, write_driver_run

torch.set_num_threads(1)

TOL = 1e-4
RUN = dict(n_cell=4, start=(1996, 1, 10), n_day=4, accum_start=(1995, 10, 1),
           july_tavg=(6.0, 16.0))
N_NODE = 10
# the global file's lines that switch frozen soil on
FROZEN_LINES = {"FROZEN_SOIL": "TRUE", "QUICK_FLUX": "FALSE",
                "NODES": str(N_NODE), "EXP_TRANS": "TRUE"}
STATE_FILE = "state_19960113"


def write_frozen_run(root) -> str:
    path = write_driver_run(root, **RUN)
    lines = []
    for line in open(path).read().splitlines():
        key = line.split(" ", 1)[0]
        lines.append(f"{key} {FROZEN_LINES[key]}" if key in FROZEN_LINES
                     else line)
    lines += [f"{k} {v}" for k, v in FROZEN_LINES.items()
              if not any(x.split(" ", 1)[0] == k for x in lines)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vic_tpu.driver import run_simulation as jrun
    from vic_tpu_torch.driver import run_simulation as trun
    root = tmp_path_factory.mktemp("driver_frozen")
    jdir, tdir = root / "j", root / "t"
    jg, tg = write_frozen_run(jdir), write_frozen_run(tdir)
    jgp = jconfig.parse_global_param_file(jg)
    tgp = tconfig.parse_global_param_file(tg)
    assert (tgp.frozen_soil, tgp.quick_flux, tgp.nnode, tgp.exp_trans) == (
        True, False, N_NODE, True)
    assert (jgp.frozen_soil, jgp.quick_flux, jgp.nnode, jgp.exp_trans) == (
        True, False, N_NODE, True)
    return (jrun(jgp, progress=False), trun(tgp, progress=False,
                                            device="cpu"), jdir, tdir, tgp)


def test_frozen_exp_trans_run_matches_vic_tpu(runs):
    jres, tres, _, _, _ = runs
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
            rtol = FROZEN_ICE_RTOL if f.name == "ice" else TOL
            np.testing.assert_allclose(b, a, rtol=rtol, atol=TOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert tres.final_state.node_temp.shape[-1] == N_NODE
    # the soil freezes
    assert float(tres.final_state.ice.max()) > 0.0
    assert np.abs(tres.outputs["OUT_WATER_ERROR"]).max() <= 1e-2


def test_ascii_state_files_carry_ten_node_temperatures(runs):
    from vic_tpu_torch.driver import load_domain
    from vic_tpu_torch.io.state_io import load_state
    from vic_tpu_torch.state import initial_state
    jres, tres, jdir, tdir, gp = runs
    domain = load_domain(gp)
    template = initial_state(domain, gp, "cpu")
    a = load_state(str(jdir / "results" / STATE_FILE), gp, template,
                   domain).numpy()
    b = load_state(str(tdir / "results" / STATE_FILE), gp, template,
                   domain).numpy()
    assert b["node_temp"].shape[-1] == N_NODE
    for k in a:
        if a[k].dtype.kind == "f":
            rtol = FROZEN_ICE_RTOL if k == "ice" else TOL
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    mask = domain.hru.mask
    np.testing.assert_allclose(b["node_temp"][mask],
                               tres.final_state.node_temp.numpy()[mask],
                               rtol=1e-6, atol=1e-4)
