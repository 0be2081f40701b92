"""The committed golden fixture of the heavy configuration without LAKES is
what vic_tpu produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/heavy_nolakes_16x8.npz holds every OUT_* and
final-state field of 16 cells x 8 3-hourly records (one day) of the heavy
configuration without LAKES on its split forcing
(tools/make_torch_port_fixture.py heavy_nolakes). chip_smoke.py holds the
port's GPU run against the same file. The port is held at 1e-4 but for the
leaves of ROADMAP.md queue 3 (vic_tpu_torch.testing.heavy_run_failures).
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_heavy_nolakes
from vic_tpu_torch.model import run
from vic_tpu_torch.testing import heavy_run_failures, thaw_edge_cells

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4


def test_committed_heavy_nolakes_fixture_is_fresh():
    committed = dict(np.load(fixture.HEAVY_NOLAKES_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 155
    assert len([k for k in committed if k.startswith("state/")]) == 51
    ref = fixture.heavy_nolakes_reference()
    assert sorted(ref) == sorted(committed)
    for k, a in ref.items():
        b = committed[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FRESH_TOL, atol=FRESH_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_port_on_cpu_matches_heavy_nolakes_fixture():
    committed = dict(np.load(fixture.HEAVY_NOLAKES_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_heavy_nolakes(n_cell, n_rec,
                                                           "cpu")
    final, outs = run(state, stack, params, gp, **extras)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    assert sorted(got) == sorted(committed)
    assert heavy_run_failures(committed, got, PORT_TOL) == []
    np.testing.assert_array_equal(got["out/OUT_TCANOPY_ITER"],
                                  committed["out/OUT_TCANOPY_ITER"])


def test_heavy_nolakes_fixture_engages_each_path():
    """Blowing snow, a wet fraction below 1, layer ice and more than one
    CLOSE_ENERGY pass; the cold cells close their water balance and the
    thaw-edge cells are the minority."""
    committed = dict(np.load(fixture.HEAVY_NOLAKES_FIXTURE))
    assert np.abs(committed["out/OUT_SUB_BLOWING"]).max() > 0.0
    assert (committed["state/mu"] < 1.0).any()
    assert committed["state/ice"].max() > 0.0
    assert committed["out/OUT_TCANOPY_ITER"].max() > 1
    werr = committed["out/OUT_WATER_ERROR"]
    assert np.abs(werr[:, 1::2]).max() <= 1e-2
    assert thaw_edge_cells(committed).sum() <= werr.shape[1] * 2 // 3
