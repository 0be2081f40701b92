"""Where the port's heavy run with LAKES leaves rtol = atol = 1e-4 against
vic_tpu, and why (CPU; JAX for vic_tpu's runs).

    JAX_PLATFORMS=cpu python tools/heavy_lake_leaves.py [--cells 256]

1. fixture: the port's CPU run at tests/fixtures/torch_port/heavy_16x8.npz's
   size against that fixture (vic_tpu's run): the keys the heavy rule, the
   lakes' rule and their union fail (vic_tpu_torch.testing), and for each
   coupled leaf of testing.heavy_lake_run_failures the largest difference
   it holds.
2. one ulp: the port against itself with its starting lake volume moved
   up by one float32 ulp: the coupled leaves' largest differences, the
   spread two programs that round differently must allow.
3. solve_lake: the port's and vic_tpu's solve_lake on the very inputs the
   port's run hands it in its third record: the largest difference of the
   lakes' top layer after one step.
4. closure at --cells cells x 8 records: max |OUT_WATER_ERROR| of the warm
   (even, raining) and cold (odd) cells and max |OUT_LAKE_WATER_ERROR|,
   vic_tpu's run beside the port's.

Prints one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_torch_port_fixture as fixture  # noqa: E402
from vic_tpu_torch.entry import build_heavy  # noqa: E402
from vic_tpu_torch.model import run  # noqa: E402
from vic_tpu_torch.physics import lake as tl  # noqa: E402
from vic_tpu_torch.testing import (THAW_FLUX_LEAVES, _heavy_ok,  # noqa: E402
                                   _lake_ok, heavy_lake_run_failures,
                                   heavy_run_failures, lake_run_failures,
                                   thaw_edge_cells)

TOL = 1e-4
SOLVE_LAKE_RECORD = 2


def port_run(n_cell, n_rec, nudge_volume=False):
    """The port's CPU run as the fixtures lay it out, the cell area and the
    step in seconds."""
    gp, params, stack, state, extras = build_heavy(n_cell, n_rec, "cpu")
    if nudge_volume:
        state.lake_volume = torch.nextafter(
            state.lake_volume, torch.full_like(state.lake_volume, np.inf))
    final, outs = run(state, stack, params, gp, **extras)
    got = {f"out/{k}": v.numpy() for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    return got, params.cell_area.numpy(), gp.dt * 3600.0


def coupled(ref, got, cell_area, dt_sec):
    """Largest difference of each coupled leaf where neither the heavy nor
    the lakes' rule holds it."""
    heavy_ok, lake_ok = _heavy_ok(ref, TOL), _lake_ok(ref, TOL, cell_area,
                                                      dt_sec)
    worst = {"energy fluxes off the thaw edge": 0.0,
             "OUT_LAKE_SURF_TEMP": 0.0, "OUT_SOIL_TNODE_WL": 0.0}
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(got[key])
        if a.dtype.kind != "f":
            continue
        left = ~(heavy_ok(key, a, b) | lake_ok(key, a, b))
        if not left.any():
            continue
        d = float(np.abs(b - a)[left].max())
        name = key.split("/", 1)[1].removesuffix("_BAND")
        k = ("energy fluxes off the thaw edge" if name in THAW_FLUX_LEAVES
             else name if name in worst else key)
        worst[k] = max(worst.get(k, 0.0), d)
    return worst


def spread(base, got, ref):
    """The coupled leaves' largest differences between two port runs."""
    edge = thaw_edge_cells(ref)
    flux = max(float(np.abs(got[k] - base[k]).max()) for k in base
               if k.split("/", 1)[1].removesuffix("_BAND")
               in THAW_FLUX_LEAVES)
    wl = np.abs(got["out/OUT_SOIL_TNODE_WL"] - base["out/OUT_SOIL_TNODE_WL"])
    return {"energy fluxes": flux,
            "OUT_LAKE_SURF_TEMP": float(np.abs(
                got["out/OUT_LAKE_SURF_TEMP"]
                - base["out/OUT_LAKE_SURF_TEMP"]).max()),
            "OUT_SOIL_TNODE_WL on the thaw edge": float(
                wl[:, edge].max()) if edge.any() else 0.0}


def solve_lake_step(n_cell):
    """Largest difference of the lakes' top layer between the port's and
    vic_tpu's solve_lake on the inputs of the port's record
    SOLVE_LAKE_RECORD."""
    import jax
    import jax.numpy as jnp
    import vic_tpu.physics.lake as jl
    captured = []
    plain = tl.solve_lake

    def watched(lp, st, **kw):
        captured.append((lp, st, kw))
        return plain(lp, st, **kw)

    tl.solve_lake = watched
    try:
        gp, params, stack, state, extras = build_heavy(
            n_cell, SOLVE_LAKE_RECORD + 1, "cpu")
        run(state, stack, params, gp, **extras)
    finally:
        tl.solve_lake = plain
    lp, st, kw = captured[SOLVE_LAKE_RECORD]
    got = plain(lp, st, **kw)

    def J(x):
        return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x
    jkw = {k: J(v) for k, v in kw.items() if k not in ("dt_sec", "blowing")}
    ref = jax.jit(functools.partial(jl.solve_lake, dt_sec=kw["dt_sec"],
                                    blowing=kw["blowing"]))(
        jl.LakeParams(**{f.name: J(getattr(lp, f.name))
                         for f in dataclasses.fields(lp)}),
        jl.LakeState(**{f.name: J(getattr(st, f.name))
                        for f in dataclasses.fields(st)}), **jkw)
    return float(np.abs(got.state.temp[:, 0].numpy()
                        - np.asarray(ref.state.temp)[:, 0]).max())


def closure(arrays):
    werr = np.abs(arrays["out/OUT_WATER_ERROR"])
    return {"warm": float(werr[:, 0::2].max()),
            "cold": float(werr[:, 1::2].max()),
            "lake": float(np.abs(arrays["out/OUT_LAKE_WATER_ERROR"]).max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=256)
    a = ap.parse_args()
    torch.set_num_threads(4)
    ref = dict(np.load(fixture.HEAVY_FIXTURE))
    n_rec, n_cell = ref["out/OUT_EVAP"].shape
    got, cell_area, dt_sec = port_run(n_cell, n_rec)
    nudged, _, _ = port_run(n_cell, n_rec, nudge_volume=True)
    ref_big = fixture.heavy_reference(n_cell=a.cells, n_rec=8)
    got_big, _, _ = port_run(a.cells, 8)
    print(json.dumps({
        "fixture": {
            "heavy rule fails": heavy_run_failures(ref, got, TOL),
            "lakes rule fails": lake_run_failures(ref, got, TOL, cell_area,
                                                  dt_sec),
            "union with the coupled leaves fails": heavy_lake_run_failures(
                ref, got, TOL, cell_area, dt_sec),
            "coupled leaves, largest difference": coupled(ref, got,
                                                          cell_area, dt_sec)},
        "one ulp of lake volume": spread(got, nudged, ref),
        "solve_lake top layer, one step": solve_lake_step(n_cell),
        f"closure at {a.cells} cells, vic_tpu": closure(ref_big),
        f"closure at {a.cells} cells, port": closure(got_big),
    }, indent=1))


if __name__ == "__main__":
    main()
