"""The committed golden fixture of the heavy configuration with LAKES is what
vic_tpu produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/heavy_16x8.npz holds every OUT_* and final-state
field of 16 cells x 8 3-hourly records (one day) of
`__graft_entry__._build(heavy=True)`'s configuration on the split forcing
of vic_tpu_torch.entry.heavy_forcing (tools/make_torch_port_fixture.py
heavy). chip_smoke.py holds the port's GPU run against the same file. The
port is held at 1e-4 but for the leaves of ROADMAP.md queue 3: the heavy
rule's thaw-edge cells, the lakes' storage residuals and mixes, and the
leaves the two couple (vic_tpu_torch.testing.heavy_lake_run_failures).
This is the one test file that compiles vic_tpu's heavy step.
"""
import functools
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_heavy
from vic_tpu_torch.model import run
from vic_tpu_torch.physics import blowing_snow
from vic_tpu_torch.testing import heavy_lake_run_failures, thaw_edge_cells

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def port_run():
    """The port's CPU run at the fixture's size: ({"out/...", "state/..."}
    arrays, the cell area, the step in seconds, and per record the lakes
    under snow and those with a nonzero blowing-snow flux, read from its
    calc_blowing_snow_plain calls on the [n_cell] lake lanes)."""
    committed = np.load(fixture.HEAVY_FIXTURE)
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_heavy(n_cell, n_rec, "cpu")
    lake_calls = []
    plain = blowing_snow.calc_blowing_snow_plain

    def watched(**kw):
        flux, transport = plain(**kw)
        if kw["tair"].dim() == 1:
            snow = kw["snowdepth"] > 0.0
            lake_calls.append((int(snow.sum()),
                               int((snow & (flux != 0.0)).sum())))
        return flux, transport

    blowing_snow.calc_blowing_snow_plain = watched
    try:
        final, outs = run(state, stack, params, gp, **extras)
    finally:
        blowing_snow.calc_blowing_snow_plain = plain
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    return got, params.cell_area.numpy(), gp.dt * 3600.0, lake_calls


def test_committed_heavy_fixture_is_fresh():
    committed = dict(np.load(fixture.HEAVY_FIXTURE))
    assert len([k for k in committed if k.startswith("out/")]) == 191
    assert len([k for k in committed if k.startswith("state/")]) == 51
    ref = fixture.heavy_reference()
    assert sorted(ref) == sorted(committed)
    for k, a in ref.items():
        b = committed[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FRESH_TOL, atol=FRESH_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_port_on_cpu_matches_heavy_fixture():
    committed = dict(np.load(fixture.HEAVY_FIXTURE))
    got, cell_area, dt_sec, _ = port_run()
    assert sorted(got) == sorted(committed)
    assert heavy_lake_run_failures(committed, got, PORT_TOL, cell_area,
                                   dt_sec) == []
    np.testing.assert_array_equal(got["out/OUT_TCANOPY_ITER"],
                                  committed["out/OUT_TCANOPY_ITER"])


def test_heavy_fixture_engages_each_path():
    """Lake ice, snow on it and a blowing-snow flux over it (the port's
    lake-lane calls), a wet fraction below 1, layer ice and more than one
    CLOSE_ENERGY pass; the cold cells close their water balance and the
    thaw-edge cells are the minority."""
    committed = dict(np.load(fixture.HEAVY_FIXTURE))
    _, _, _, lake_calls = port_run()
    assert len(lake_calls) == committed["out/OUT_EVAP"].shape[0]
    assert committed["out/OUT_LAKE_ICE_FRACT"].max() > 0.5
    assert committed["out/OUT_LAKE_SWE"].max() > 0.0
    assert max(snow for snow, _ in lake_calls) > 0
    assert max(blown for _, blown in lake_calls) > 0
    assert np.abs(committed["out/OUT_SUB_BLOWING"]).max() > 0.0
    assert (committed["state/mu"] < 1.0).any()
    assert committed["state/ice"].max() > 0.0
    assert committed["out/OUT_TCANOPY_ITER"].max() > 1
    werr = committed["out/OUT_WATER_ERROR"]
    assert np.abs(werr[:, 1::2]).max() <= 1e-2
    assert thaw_edge_cells(committed).sum() <= werr.shape[1] * 2 // 3
