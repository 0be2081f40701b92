"""The committed golden fixture of the spatial_snow configuration (the light
configuration with SPATIAL_SNOW, CORRPREC and CONTINUEONERROR from 1 May
with a melting spring pack) is what vic_tpu produces today, and the port's
CPU run reproduces it.

tests/fixtures/torch_port/spatial_snow_16x4.npz holds every OUT_* (151, the
light step's and OUT_CELL_VALID) and final-state field of 16 cells x 4
daily records (tools/make_torch_port_fixture.py spatial_snow).
chip_smoke.py holds the port's GPU run against the same file. The port is
held at 1e-4 but for OUT_ENERGY_ERROR, the residual at an accepted Brent
root, at 1e-3 W/m^2 (ROADMAP.md queue 3, residual-at-root leaves).
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_spatial_snow
from vic_tpu_torch.model import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4
ROOT_RESIDUAL_TOL = {"out/OUT_ENERGY_ERROR": 1e-3}    # W/m^2


def _assert_arrays(ref, got, tol, atol_of, what):
    assert sorted(got) == sorted(ref), what
    for k, a in ref.items():
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=tol,
                                       atol=atol_of.get(k, tol),
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {k}")


def test_committed_spatial_snow_fixture_is_fresh():
    committed = dict(np.load(fixture.SPATIAL_SNOW_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 151
    assert len([k for k in committed if k.startswith("state/")]) == 51
    _assert_arrays(fixture.spatial_snow_reference(), committed, FRESH_TOL,
                   {}, "committed fixture vs vic_tpu today")


def test_port_on_cpu_matches_spatial_snow_fixture():
    committed = dict(np.load(fixture.SPATIAL_SNOW_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_spatial_snow(n_cell, n_rec,
                                                          "cpu")
    final, outs = run(state, stack, params, gp, **extras)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    _assert_arrays(committed, got, PORT_TOL, ROOT_RESIDUAL_TOL,
                   "port on CPU vs fixture")
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2


def test_spatial_snow_fixture_engages_its_options():
    """Partial coverage with a nonzero advected sensible heat, the
    depletion curve's memory, gauge corrections above 1 on windy cells,
    and every cell valid."""
    ref = dict(np.load(fixture.SPATIAL_SNOW_FIXTURE))
    cov = ref["out/OUT_SNOW_COVER"]
    partial = (cov > 0.0) & (cov < 1.0)
    assert partial.sum() >= 16
    assert np.abs(ref["out/OUT_ADV_SENS"][partial]).max() > 0.1
    lane_cov = ref["state/coverage"]
    assert ((lane_cov > 0.0) & (lane_cov < 1.0)).any()
    assert (ref["state/snow_swq_slope"] < 0.0).any()
    assert (ref["out/OUT_CELL_VALID"] == 1.0).all()
    # CORRPREC: the light run on the same forcing catches less
    gp, params, stack, state, extras = build_spatial_snow(16, 4, "cpu")
    light = gp.replace(corrprec=False)
    _, outs = run(state, stack, params, light, outvars=["OUT_PREC"])
    prec = ref["out/OUT_PREC"]
    raw = outs["OUT_PREC"].numpy()
    wet = raw > 0.0
    assert (prec[wet] > raw[wet]).all()
