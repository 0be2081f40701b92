"""Where the port's heavy_nolakes run leaves rtol = atol = 1e-4 against
vic_tpu, and why (CPU, no JAX).

    python tools/heavy_nolakes_leaves.py

1. fixture: the port's CPU run of tests/fixtures/torch_port/
   heavy_nolakes_16x8.npz's size against that fixture (vic_tpu's run):
   each float leaf beyond 1e-4, its largest difference on the thaw-edge
   cells (vic_tpu_torch.testing.thaw_edge_cells) and on the others.
2. one ulp: the port against itself with its carried node temperatures,
   then its soil moisture, moved up and down by one float32 ulp: the same
   leaves' largest differences over the four runs, the spread two programs
   that round differently must allow.
3. closure: max |OUT_WATER_ERROR| of the warm (even, raining) and the cold
   (odd) cells, and again with the glacier lanes weighted 0: vic_tpu's
   DIST_PRCP residual sits where rain on bare ice enters the glacier's
   store at the wet fraction's intensity P/mu.

Prints one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vic_tpu_torch.entry import build_heavy_nolakes  # noqa: E402
from vic_tpu_torch.model import run  # noqa: E402
from vic_tpu_torch.testing import thaw_edge_cells  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "heavy_nolakes_16x8.npz")
TOL = 1e-4


def as_fixture(final, outs):
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    return got


def beyond(ref, got, edge):
    """{leaf: (max |diff| on thaw-edge cells, on the others)} of the float
    leaves beyond rtol = atol = TOL."""
    out = {}
    for key, a in ref.items():
        if a.dtype.kind != "f":
            continue
        d = np.abs(got[key] - a)
        bad = d > TOL + TOL * np.abs(a)
        if not bad.any():
            continue
        cell_axis = 1 if key.startswith("out/") else 0
        d = np.moveaxis(d, cell_axis, 0).reshape(edge.size, -1)
        out[key] = (float(d[edge].max()) if edge.any() else 0.0,
                    float(d[~edge].max()) if (~edge).any() else 0.0)
    return out


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    ref = dict(np.load(FIXTURE))
    n_rec, n_cell = ref["out/OUT_EVAP"].shape
    edge = thaw_edge_cells(ref)
    gp, params, stack, state, extras = build_heavy_nolakes(n_cell, n_rec,
                                                           "cpu")
    base = as_fixture(*run(state, stack, params, gp, **extras))

    envelope = {}
    for field in ("node_temp", "moist"):
        for toward in (1e4, -1e4):
            x = getattr(state, field)
            nudged = dataclasses.replace(state, **{field: torch.nextafter(
                x, torch.full_like(x, toward))})
            ulp = as_fixture(*run(nudged, stack, params, gp, **extras))
            for key, (e, o) in beyond(base, ulp, edge).items():
                pe, po = envelope.get(key, (0.0, 0.0))
                envelope[key] = (max(pe, e), max(po, o))

    werr = np.abs(base["out/OUT_WATER_ERROR"]).max(0)
    w0 = params.weight
    params.weight = torch.where(params.is_glacier, 0.0, w0)
    _, no_glac = run(state, stack, params, gp, outvars=["OUT_WATER_ERROR"],
                     **extras)
    params.weight = w0
    werr_ng = no_glac["OUT_WATER_ERROR"].abs().amax(0).numpy()

    result = {
        "cells": n_cell, "records": n_rec,
        "thaw_edge_cells": [int(i) for i in np.flatnonzero(edge)],
        "fixture_vs_port": beyond(ref, base, edge),
        "port_vs_port_one_ulp": envelope,
        "water_error_max_mm": {
            "warm": float(werr[0::2].max()), "cold": float(werr[1::2].max()),
            "warm_without_glacier_lanes": float(werr_ng[0::2].max()),
            "cold_without_glacier_lanes": float(werr_ng[1::2].max())},
    }
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
