"""The committed golden fixture of the blowing_close configuration is what
vic_tpu produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/blowing_close_16x4.npz holds every OUT_* and
final-state field of 16 cells x 4 daily records of the light configuration
with BLOWING and CLOSE_ENERGY on its windy, cold forcing
(tools/make_torch_port_fixture.py blowing_close). chip_smoke.py holds the
port's GPU run against the same file.
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_blowing_close
from vic_tpu_torch.model import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4


def _assert_arrays(ref, got, tol, what):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {k}")


def test_committed_blowing_close_fixture_is_fresh():
    committed = dict(np.load(fixture.BLOWING_CLOSE_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 150
    assert len([k for k in committed if k.startswith("state/")]) == 51
    _assert_arrays(fixture.blowing_close_reference(), committed, FRESH_TOL,
                   "committed blowing_close fixture vs vic_tpu today")


def test_port_on_cpu_matches_blowing_close_fixture():
    committed = dict(np.load(fixture.BLOWING_CLOSE_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, _ = build_blowing_close(n_cell, n_rec, "cpu")
    final, outs = run(state, stack, params, gp)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    _assert_arrays(committed, got, PORT_TOL,
                   "port on CPU vs blowing_close fixture")
    np.testing.assert_array_equal(got["out/OUT_TCANOPY_ITER"],
                                  committed["out/OUT_TCANOPY_ITER"])
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2
    assert np.abs(committed["out/OUT_SUB_BLOWING"]).max() > 0
