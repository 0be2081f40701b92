"""The port's run driver reproduces vic_tpu's run of the committed driver
fixture: 16 cells x 12 daily records of the main path in the reference's
file formats (tests/fixtures/torch_port/driver/, its global file's paths
as @FIXDIR@), with vic_tpu's aggregated OUT_*, final state and GMB fit in
driver_16x12.npz (tools/make_torch_port_fixture.py driver). chip_smoke.py
holds the card's run against the same file.
"""
import filecmp
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.config import parse_global_param_file
from vic_tpu_torch.driver import run_simulation
from vic_tpu_torch.testing import relocate_run, run_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

PORT_TOL = 1e-4


def test_committed_inputs_are_what_the_writer_writes(tmp_path):
    fixture.write_driver_inputs(tmp_path)
    for sub in ("", "forcing"):
        names = sorted(os.listdir(os.path.join(fixture.DRIVER_DIR, sub)))
        assert names == sorted(os.listdir(tmp_path / sub)), sub
        for name in names:
            path = os.path.join(fixture.DRIVER_DIR, sub, name)
            if os.path.isfile(path):
                assert filecmp.cmp(path, tmp_path / sub / name,
                                   shallow=False), name


def test_port_on_cpu_matches_fixture(tmp_path):
    committed = dict(np.load(fixture.DRIVER_FIXTURE))
    gp = parse_global_param_file(relocate_run(fixture.DRIVER_DIR, tmp_path))
    res = run_simulation(gp, progress=False, device="cpu")
    got = run_arrays(res)
    assert sorted(got) == sorted(committed)
    assert len([k for k in got if k.startswith("out/")]) == 12
    for k, a in committed.items():
        b = got[k]
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=PORT_TOL, atol=PORT_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert committed["gmb/b1"].shape == (1, 16)
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2
    n_files = len([f for f in os.listdir(tmp_path / "results")
                   if f.startswith("fluxes_")])
    assert n_files == 16
