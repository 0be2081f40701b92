"""The committed golden fixture of the frozen_quick configuration (the
light configuration with FROZEN_SOIL on QUICK_FLUX's 3 nodes) is what
vic_tpu produces today, and the port's CPU run reproduces it.

tests/fixtures/torch_port/frozen_quick_16x4.npz holds every OUT_* and
final-state field of 16 cells x 4 daily records
(tools/make_torch_port_fixture.py frozen_quick). chip_smoke.py holds the
port's GPU run against the same file. The port is held at 1e-4 but for the
leaves of vic_tpu_torch.testing.frozen_run_failures: OUT_FUSION and
OUT_ENERGY_ERROR, which follow the fusion term's steep unfrozen-water curve
across the Brent root's final bracket, and the layer ice (ROADMAP.md
queue 3).
"""
import os
import sys

import numpy as np
import torch

from vic_tpu_torch.entry import build_frozen_quick
from vic_tpu_torch.model import run
from vic_tpu_torch.testing import frozen_run_failures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

FRESH_TOL = 1e-5
PORT_TOL = 1e-4
N_NODE = 3


def test_committed_frozen_quick_fixture_is_fresh():
    committed = dict(np.load(fixture.FROZEN_QUICK_FIXTURE))
    fresh = fixture.frozen_quick_reference()
    assert sorted(fresh) == sorted(committed)
    assert len([k for k in committed if k.startswith("state/")]) == 51
    assert committed["state/node_temp"].shape[-1] == N_NODE
    for k, a in fresh.items():
        b = committed[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FRESH_TOL, atol=FRESH_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_port_on_cpu_matches_frozen_quick_fixture():
    committed = dict(np.load(fixture.FROZEN_QUICK_FIXTURE))
    n_rec, n_cell = committed["out/OUT_EVAP"].shape
    gp, params, stack, state, extras = build_frozen_quick(n_cell, n_rec, "cpu")
    final, outs = run(state, stack, params, gp, **extras)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    assert sorted(got) == sorted(committed)
    assert frozen_run_failures(committed, got, PORT_TOL) == []
    assert np.abs(got["out/OUT_WATER_ERROR"]).max() <= 1e-2
    # the soil freezes and the fusion term is live
    assert committed["state/ice"].max() > 0
    assert np.abs(committed["out/OUT_FUSION"]).max() > 0
