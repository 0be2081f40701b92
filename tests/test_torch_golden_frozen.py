"""The committed golden fixture of the frozen-soil configuration is what
vic_tpu produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/frozen_16x4.npz holds every OUT_* and final-state
field of 16 cells x 4 daily records (tools/make_torch_port_fixture.py
frozen). chip_smoke.py holds the port's GPU run against the same file. The
port is held at 1e-4 but for the two leaves of tests/test_torch_frozen_model
.py's LOOSE, for the causes given there.
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_frozen
from vic_tpu_torch.model import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4
LOOSE = {"out/OUT_ENERGY_ERROR": (PORT_TOL, 1e-3),
         "state/ice": (1e-3, PORT_TOL)}


def _assert_arrays(ref, got, tol, what, loose=None):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if a.dtype.kind == "f":
            rtol, atol = (loose or {}).get(k, (tol, tol))
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {k}")


def test_committed_frozen_fixture_is_fresh():
    committed = dict(np.load(fixture.FROZEN_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 151
    assert len([k for k in committed if k.startswith("state/")]) == 51
    _assert_arrays(fixture.frozen_reference(), committed, FRESH_TOL,
                   "committed frozen fixture vs vic_tpu today")


def test_port_on_cpu_matches_frozen_fixture():
    committed = dict(np.load(fixture.FROZEN_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_frozen(n_cell, n_rec, "cpu")
    geom = extras["geom"]
    final, outs = run(state, stack, params, gp, geom=geom)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    _assert_arrays(committed, got, PORT_TOL, "port on CPU vs frozen fixture",
                   loose=LOOSE)
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2
    assert committed["state/ice"].max() > 0
