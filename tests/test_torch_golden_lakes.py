"""The committed golden fixture of the lakes configuration is what vic_tpu
produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/lakes_16x4.npz holds every OUT_* and final-state
field of 16 cells x 4 daily January records of the light configuration
with LAKES on the synthetic parabolic basin
(tools/make_torch_port_fixture.py lakes). The port's run is held at
rtol = atol = 1e-4 with the lakes' tolerance leaves as
vic_tpu_torch.testing.lake_run_failures holds them; chip_smoke.py holds the
port's GPU run against the same file.
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_lakes
from vic_tpu_torch.model import run
from vic_tpu_torch.testing import lake_run_failures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4


def test_committed_lakes_fixture_is_fresh():
    committed = dict(np.load(fixture.LAKES_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 186
    assert len([k for k in committed if k.startswith("state/")]) == 51
    fresh = fixture.lakes_reference()
    assert sorted(fresh) == sorted(committed)
    for k, a in committed.items():
        b = np.asarray(fresh[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FRESH_TOL, atol=FRESH_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_port_on_cpu_matches_lakes_fixture():
    committed = dict(np.load(fixture.LAKES_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_lakes(n_cell, n_rec, "cpu")
    lp = extras["lake_params"]
    final, outs = run(state, stack, params, gp, lake_params=lp)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    assert sorted(got) == sorted(committed)
    assert lake_run_failures(committed, got, PORT_TOL,
                             params.cell_area.numpy()) == []
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2
    # the lakes freeze and carry snow within the four records
    assert committed["out/OUT_LAKE_ICE_FRACT"].max() > 0.5
    assert committed["state/lake_swe"].max() > 0.0
