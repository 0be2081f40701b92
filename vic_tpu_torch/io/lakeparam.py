"""Lake parameter file reader (read_lakeparam.c), a copy of
`vic_tpu/io/lakeparam.py` returning {field: numpy array} for
`prepare.lake_params_from_numpy`.

Format per cell (whitespace, possibly multi-line):
  <gridcel> <lake_idx> <numnod> <mindepth> <wfrac> <depth_in> <rpercent>
  then the depth-area profile: with LAKE_PROFILE, numnod (z, Cl) pairs
  (depth above lake bottom, area fraction of cell); otherwise a single
  (z[0], Cl[0]) pair with the rest linearly interpolated to zero at the
  bottom (read_lakeparam.c:150-210).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..constants import MAX_LAKE_NODES


def read_lakeparam_file(path: str, soil, gp) -> dict:
    tokens = []
    with open(path) as f:
        for line in f:
            if line.strip().startswith("#"):
                continue
            tokens.extend(line.split())
    it = iter(tokens)
    nxt = lambda: next(it)

    n_cell = soil.n_cell
    NN = MAX_LAKE_NODES
    cell_index = {int(g): i for i, g in enumerate(soil.gridcel)}

    has_lake = np.zeros(n_cell, bool)
    numnod = np.zeros(n_cell, np.int32)
    z = np.zeros((n_cell, NN + 1))
    basin = np.zeros((n_cell, NN + 1))
    mindepth = np.zeros(n_cell)
    wfrac = np.zeros(n_cell)
    depth_in = np.zeros(n_cell)
    rpercent = np.zeros(n_cell)
    cl0 = np.zeros(n_cell)

    try:
        while True:
            gridcel = int(float(nxt()))
            _lake_idx = int(float(nxt()))
            nn = int(float(nxt()))
            if gridcel not in cell_index:
                # consume the rest of this cell's record and continue
                for _ in range(4):
                    nxt()
                npairs = nn if gp.lake_profile else 1
                for _ in range(2 * npairs):
                    nxt()
                continue
            ci = cell_index[gridcel]
            if _lake_idx < 0 or nn < 1:
                continue
            nn = min(nn, NN)
            mindepth[ci] = float(nxt())
            wfrac[ci] = float(nxt())
            depth_in[ci] = float(nxt())
            rpercent[ci] = float(nxt())
            zz = np.zeros(nn + 1)
            bb = np.zeros(nn + 1)
            if gp.lake_profile:
                # numnod (z, Cl) pairs; bottom closed at zero
                # (read_lakeparam.c:205-221)
                for k in range(nn):
                    zz[k] = float(nxt())
                    bb[k] = float(nxt()) * soil.cell_area[ci]
            else:
                # single (maxdepth, Cl[0]) pair; area-depth curve
                # basin[i] = PI*(pow(z/maxdepth, BETA)*radius)^2 with
                # BETA=0.001 (LAKE.h:41) — a near-cylindrical basin that
                # closes to a point only at the bottom node
                # (read_lakeparam.c:164-203)
                z0 = float(nxt())
                c0 = float(nxt())
                basin0 = c0 * soil.cell_area[ci]
                radius = np.sqrt(basin0 / np.pi)
                tempdz = z0 / nn
                zz[0] = z0
                bb[0] = basin0
                for k in range(1, nn + 1):
                    zz[k] = max((nn - k) * tempdz, 0.0)
                    x = (zz[k] / z0) ** 0.001 * radius if zz[k] > 0 else 0.0
                    bb[k] = np.pi * x * x
            has_lake[ci] = True
            numnod[ci] = nn
            cl0[ci] = bb[0] / soil.cell_area[ci]
            z[ci, :nn + 1] = zz
            basin[ci, :nn + 1] = bb
    except StopIteration:
        pass

    maxdepth = z[:, 0]
    vol = np.zeros(n_cell)
    for k in range(NN):
        vol += (z[:, k] - z[:, k + 1]).clip(0) * (basin[:, k]
                                                  + basin[:, k + 1]) / 2.0
    # volume below the outflow sill (read_lakeparam.c:229-233 get_volume),
    # in float32 as vic_tpu evaluates it
    from ..physics.lake import volume_from_depth
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    minvol = volume_from_depth(SimpleNamespace(z=f32(z), basin=f32(basin)),
                               f32(mindepth)).numpy()
    return dict(
        has_lake=has_lake, numnod=numnod, z=z, basin=basin,
        mindepth=mindepth, minvolume=minvol, maxvolume=vol,
        maxdepth=maxdepth, wfrac=wfrac, depth_in=depth_in,
        rpercent=rpercent, cl0=cl0)
