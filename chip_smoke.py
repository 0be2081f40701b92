#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every phase runs, in this order; each raises (non-zero exit, no result
line) on failure:

0. device: a CUDA device is required; prints the card's name and power limit.
1. build: compiles the CUDA kernels from vic_tpu_torch/csrc with nvcc (one
   process per source) and prints ptxas' registers and spills.
2. kernels: each configuration at its slice's size (32,768 cells, 262,144
   HRU lanes; heavy_nolakes and heavy 8,192 cells) with each kernel binding
   wrapped to capture its real arguments: K1-K5 in the light step's first
   record, K6, K7 (and K4 again) in the frozen step's third, K8, K9 (and
   K2 again, with a blowing-snow flux) in the blowing_close step's fourth,
   K10-K13 in the lakes step's second (open, partly and fully iced lakes
   side by side), K14 and again K7 (with DIST_PRCP's dry column), K4 (its dry
   column's call) and K6 (the lower probe of a CLOSE_ENERGY pass) in the
   heavy_nolakes step's fourth, K5 again with the dry column in the
   dist_prcp step's second, and every kernel of the heavy path (K12 with
   the blowing-snow flux over lake ice, K8 on the lake lanes) in the heavy
   step's seventh, where lakes carry snow on ice that blows (K12 and K8
   timed on those arguments too); then the forms frozen soil adds as its
   users set it up (the last rows of ROWS): K6 and K7 on 10 EXP_TRANS nodes
   in the frozen_exp step's third record, K5 with the fusion term in the
   frozen_quick step's second, and K6 at 3, 18 and 50 EXP_TRANS nodes in
   the third record of frozen_exp's configuration with its node count
   replaced, at 4,096 cells; then K2 and K5 in the spatial_snow step's
   second record, where packs cover part of their lanes (SPATIAL_SNOW's
   advected sensible heat in K2), and the three loops no step calls: K15
   mass_release on the light step's canopy snow and melt storage (and on
   seeded storage that releases), K16 implicit_profile on K6's arguments of
   the frozen (5 nodes) and frozen_exp (10 EXP_TRANS nodes) steps, NOFLUX
   both ways, and K17 bisection on K2's and K1's arguments of the light
   step, 40 steps. Each row's kernel is re-run on those arguments beside its
   plain PyTorch version on the card, compared, timed with CUDA events and
   given its bound (the least time the card could take for the same
   work).
3. reference: each configuration's fixture size (16 cells x 4 records,
   spatial_snow's too;
   heavy_nolakes and heavy 16 x 8 3-hourly) through the port on the card
   against
   tests/fixtures/torch_port/<config>_16x<records>.npz, written by vic_tpu
   on CPU.
4. slice: 32,768 cells x 8 daily records of each configuration, 8,192
   cells x 8 3-hourly records of heavy_nolakes and heavy, through
   vic_tpu_torch.model.run, every kernel's launch counter set to 0 just
   before each run and read just after it, and every plain solver of the
   port (ops.rootfind.batched_brent and batched_bisection,
   ops.tridiag.thomas_solve and each *_plain) made to fail if it is handed a CUDA tensor during the run;
   frozen_exp also times its SPATIAL_FROST layer ice; then frozen_exp's
   configuration at 3, 18 and 50 nodes, 4,096 cells x 8 records, the same
   way. Each row's launches in the kernels line are its kernel's count in
   the slice of the configuration its arguments came from (0 for K15-K17,
   which no step calls). The spatial_snow slice prints the share of snow
   lanes with fractional coverage, then runs again with NaN air
   temperature in 64 cells from its fourth record: CONTINUEONERROR must
   freeze them there (OUT_CELL_VALID 0, the state after the third record)
   and leave every other cell equal to the first run.
5. driver: a run of the main path in the reference's file formats
   (vic_tpu_torch.testing.write_driver_run: 8,192 cells x 370 daily records
   from 1995-10-01, a glacier tile, 2 snow bands, COMPUTE_TREELINE with the
   July mean from the forcing, daily VIC BINARY forcing through MTCLIM,
   BINARY output, an ASCII state file, the glacier mass-balance interval
   from 1995-10-01, so one fit at 1996-09-30) through the CLI's code path
   (`vic_tpu_torch.driver.run_main`), the plain solvers guarded and K1-K5's
   counters read around it; every output file read back; the same forcing
   again in cell blocks of 4,096 (equal outputs) ending 3 records early with
   its ASCII state, read back field for field, and a warm start from it
   for the last 3 records against the continuous run (held on the lanes
   without snow at the restart: the legacy format re-derives LongUnderOut
   and the snow coverage); and the committed 16-cell driver fixture
   against vic_tpu's run of it (tests/fixtures/torch_port/driver_16x12.npz).

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.testing import (frozen_run_failures,
                                   heavy_lake_run_failures,
                                   heavy_run_failures, lake_run_failures,
                                   thaw_edge_cells)

ROOT = Path(__file__).resolve().parent
SMOKE_CELLS = 32768
SMOKE_RECS = 8
HEAVY_CELLS = 8192         # the heavy configuration's size in bench.py
FROZEN_RECORD = 2          # record whose step gives K6 and K7 their arguments
BLOWING_RECORD = 3         # record whose step gives K8 and K9 theirs
LAKES_RECORD = 1           # record whose step gives K10-K13 theirs
HEAVY_RECORD = 3           # record whose step gives K14 and the heavy K4/6/7
DIST_PRCP_RECORD = 1       # record whose step gives K5's dry column
# record whose step gives every kernel of the heavy path its arguments: the
# lakes froze over from the third record and carry snow that blows from the
# sixth (16 cells on CPU)
HEAVY_LAKE_RECORD = 6
CONFIG_NAMES = ("light", "frozen", "blowing_close", "lakes", "heavy_nolakes",
                "heavy", "frozen_exp", "frozen_quick", "spatial_snow")
FROZEN_QUICK_RECORD = 1    # record whose step gives K5 its fusion term
# record whose step gives K2 and K5 fractional coverage (the packs melt
# into patches from the first record)
SPATIAL_SNOW_RECORD = 1
NAN_CELLS = 64             # cells of the spatial_snow slice made NaN
NAN_FROM = 3               # from this record on
BISECTION_ITERS = 40
NODE_COUNT_CELLS = 4096    # cells of the 3-, 18- and 50-node K6 rows
# cells of each configuration's kernel capture and slice
CELLS = {"heavy_nolakes": HEAVY_CELLS, "heavy": HEAVY_CELLS}
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
FIXTURE_FILES = {"heavy_nolakes": "heavy_nolakes_16x8.npz",
                 "heavy": "heavy_16x8.npz"}
CSRC = "vic_tpu_torch/csrc/"
# kernel -> (source, TPU loop it replaces, module of its plain version,
# plain name, configuration whose step captures its arguments)
KERNELS = {
    "glacier_brent": ("vic_kernels.cu", "vic_tpu/physics/glacier.py:130",
                      "glacier", "glacier_brent_plain", "light"),
    "snowpack_brent": ("vic_kernels.cu", "vic_tpu/physics/snow.py:443",
                       "snow", "snowpack_brent_plain", "light"),
    "canopy_brent": ("vic_kernels.cu", "vic_tpu/physics/canopy_snow.py:270",
                     "canopy_snow", "canopy_brent_plain", "light"),
    "runoff_hourly": ("vic_kernels.cu", "vic_tpu/physics/runoff.py:171",
                      "runoff", "runoff_hourly_plain", "light"),
    "surface_brent": ("surface_brent.cu", "vic_tpu/physics/surface.py:438",
                      "surface", "surface_brent_plain", "light"),
    "node_sweep": ("node_sweep.cu", "vic_tpu/physics/frozen_soil.py:311",
                   "frozen_soil", "solve_t_profile_explicit_plain", "frozen"),
    "fd_surface_brent": ("fd_surface_brent.cu",
                         "vic_tpu/physics/surface.py:438", "surface",
                         "surface_brent_plain", "frozen"),
    "blowing_snow": ("blowing_snow.cu",
                     "vic_tpu/physics/blowing_snow.py:171", "blowing_snow",
                     "calc_blowing_snow_plain", "blowing_close"),
    "canopy_air_step": ("canopy_air.cu", "vic_tpu/model.py:841",
                        "canopy_air", "canopy_air_step_plain",
                        "blowing_close"),
    # K10 and K11 hold ops/tridiag.py:16's Thomas solve and lake.py:443's
    # tracer_mixer inside
    "lake_open_water": ("lake_open_water.cu", "vic_tpu/physics/lake.py:584",
                        "lake", "lake_open_water_plain", "lakes"),
    "lake_under_ice": ("lake_under_ice.cu", "vic_tpu/physics/lake.py:1112",
                       "lake", "water_under_ice_plain", "lakes"),
    "lake_ice_brent": ("lake_ice_brent.cu", "vic_tpu/physics/lake.py:960",
                       "lake", "lake_ice_brent_plain", "lakes"),
    "lake_depth": ("lake_depth.cu", "vic_tpu/physics/lake.py:204", "lake",
                   "depth_from_volume_plain", "lakes"),
    "affine_surface_brent": ("affine_surface_brent.cu",
                             "vic_tpu/physics/surface.py:438", "surface",
                             "surface_brent_plain", "heavy_nolakes"),
    # the loops no step calls, on arguments the steps give their neighbours
    "mass_release": ("mass_release.cu",
                     "vic_tpu/physics/canopy_snow.py:126", "canopy_snow",
                     "mass_release_plain", "light"),
    "implicit_profile": ("implicit_profile.cu",
                         "vic_tpu/physics/frozen_soil.py:601", "frozen_soil",
                         "solve_t_profile_implicit_plain", "frozen"),
    "bisection": ("bisection.cu", "vic_tpu/ops/rootfind.py:210", "bisection",
                  "bisection_plain", "light"),
}
# where K15-K17 take their arguments: the result of the step's
# snow_intercept (vic_tpu_torch.model), or another kernel's call
CAPTURED_FROM = {"mass_release": "snow_intercept",
                 "implicit_profile": "node_sweep",
                 "bisection/snowpack": "snowpack_brent",
                 "bisection/glacier": "glacier_brent"}
# functions of vic_tpu_torch.model whose result capture_kernel_args takes
MODEL_RESULTS = ("snow_intercept",)
LAKE_KERNELS = ("lake_open_water", "lake_under_ice", "lake_ice_brent",
                "lake_depth")
# the kernels also timed on the heavy step's arguments, and what they are
HEAVY_LAKE_TIMED = {"lake_ice_brent": "heavy, with the blowing-snow flux",
                    "blowing_snow": "heavy, lake lanes"}
SURFACE_KERNELS = ("surface_brent", "fd_surface_brent", "affine_surface_brent")
# the configurations with DIST_PRCP: their surface residuals carry the dry
# column
DIST_PRCP_CONFIGS = ("dist_prcp", "heavy_nolakes", "heavy")
# the kernels each configuration's step must launch
PATH_KERNELS = {
    "light": ("glacier_brent", "snowpack_brent", "canopy_brent",
              "runoff_hourly", "surface_brent"),
    "frozen": ("glacier_brent", "snowpack_brent", "canopy_brent",
               "runoff_hourly", "node_sweep", "fd_surface_brent"),
    "blowing_close": ("glacier_brent", "snowpack_brent", "canopy_brent",
                      "runoff_hourly", "surface_brent", "blowing_snow",
                      "canopy_air_step"),
    "lakes": ("glacier_brent", "snowpack_brent", "canopy_brent",
              "runoff_hourly", "surface_brent") + LAKE_KERNELS,
    "heavy_nolakes": ("glacier_brent", "snowpack_brent", "canopy_brent",
                      "runoff_hourly", "node_sweep", "fd_surface_brent",
                      "blowing_snow", "canopy_air_step",
                      "affine_surface_brent"),
}
PATH_KERNELS["heavy"] = PATH_KERNELS["heavy_nolakes"] + LAKE_KERNELS
PATH_KERNELS["frozen_exp"] = PATH_KERNELS["frozen"]
PATH_KERNELS["frozen_quick"] = PATH_KERNELS["light"]
PATH_KERNELS["spatial_snow"] = PATH_KERNELS["light"]
# the record of each configuration's step that gives its kernels their
# arguments (the first where not named), and the call of a kernel in that
# step whose arguments are taken (the first where not named): in the
# heavy_nolakes step K4's second call is the dry column's and K6's first the
# lower probe of the first CLOSE_ENERGY pass; in the heavy step K8's second
# is the lake lanes'
RECORD = {"frozen": FROZEN_RECORD, "blowing_close": BLOWING_RECORD,
          "lakes": LAKES_RECORD, "heavy_nolakes": HEAVY_RECORD,
          "dist_prcp": DIST_PRCP_RECORD, "heavy": HEAVY_LAKE_RECORD,
          "frozen_exp": FROZEN_RECORD, "frozen_quick": FROZEN_QUICK_RECORD,
          "spatial_snow": SPATIAL_SNOW_RECORD}
NTH = {"heavy_nolakes": {"runoff_hourly": 1},
       "heavy": {"runoff_hourly": 1, "blowing_snow": 1}}
# the node counts that replace frozen_exp's 10 in K6's rows and slices at
# NODE_COUNT_CELLS cells
NODE_COUNTS = (3, 18, 50)
# the rows of the kernels line: row -> (kernel, configuration, node count
# that replaces frozen_exp's or None); each kernel on its own
# configuration's step, then the forms frozen soil adds as its users set it
# up: K6 and K7 on 10 EXP_TRANS nodes, K5 with the fusion term, and K6 at
# each of NODE_COUNTS EXP_TRANS nodes
ROWS = {name: (name, k[4], None) for name, k in KERNELS.items()
        if name != "bisection"}
ROWS.update({
    "node_sweep/exp_trans_10": ("node_sweep", "frozen_exp", None),
    "fd_surface_brent/exp_trans_10": ("fd_surface_brent", "frozen_exp", None),
    "surface_brent/fusion": ("surface_brent", "frozen_quick", None),
})
ROWS.update({f"node_sweep/exp_trans_{n}": ("node_sweep", "frozen_exp", n)
             for n in NODE_COUNTS})
# SPATIAL_SNOW's forms of K2 and K5, and the rest of K16's and K17's rows
ROWS.update({
    "snowpack_brent/spatial_snow": ("snowpack_brent", "spatial_snow", None),
    "surface_brent/spatial_snow": ("surface_brent", "spatial_snow", None),
    "implicit_profile/exp_trans_10": ("implicit_profile", "frozen_exp", None),
    "bisection/snowpack": ("bisection", "light", None),
    "bisection/glacier": ("bisection", "light", None),
})
# the steps whose arguments each kernel is also held on, besides its own
# configuration's: the frozen step's K4, the blowing_close step's K2 (a
# blowing-snow flux in its residual), the dist_prcp step's K5 (DIST_PRCP's
# dry column), the heavy_nolakes step's every kernel of its path (K4's
# dry column, K6's lower probe, K7 with the dry column), and the heavy
# step's every kernel of its path (K8's call on the lake lanes, K12 with the
# blowing-snow flux over lake ice; K5 is not on it)
ALSO_ON = {
    "glacier_brent": ("heavy_nolakes", "heavy"),
    "snowpack_brent": ("blowing_close", "heavy_nolakes", "heavy"),
    "canopy_brent": ("heavy_nolakes", "heavy"),
    "runoff_hourly": ("frozen", "heavy_nolakes", "heavy"),
    "surface_brent": ("dist_prcp",),
    "node_sweep": ("heavy_nolakes", "heavy"),
    "fd_surface_brent": ("heavy_nolakes", "heavy"),
    "blowing_snow": ("heavy_nolakes", "heavy"),
    "canopy_air_step": ("heavy_nolakes", "heavy"),
    "affine_surface_brent": ("heavy",),
    "lake_open_water": ("heavy",),
    "lake_under_ice": ("heavy",),
    "lake_ice_brent": ("heavy",),
    "lake_depth": ("heavy",),
}
# Brent stops a lane anywhere inside its final bracket, |c - b| <= 2*tol_i
# with tol_i = 2*FLT_EPSILON*|b| + 1e-4 C, so two runs whose residuals differ
# by ulps may stop up to one bracket width apart: roots must agree within
# 2*tol_i of the kernel's root.
BRENT_TOL = 1e-4           # C, the solver's tol addend
FLAG_DISAGREE_FRAC = 1e-4  # of the active lanes
RUNOFF_TOL = 1e-5          # rtol = atol
SWEEP_TOL = 1e-4           # C, node temperatures of K6 vs its plain version
BLOWING_RTOL = 1e-4        # K8 vs its plain version
BLOWING_ATOL = 1e-9        # kg/m^2/s, far below the -5e-5 floor
CANOPY_AIR_TOL = 1e-5      # C, K9's tc_next vs its plain version
REF_TOL = 1e-3             # rtol = atol, card libm vs XLA-CPU
WATER_TOL = 1e-2           # mm, max |OUT_WATER_ERROR|
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, FP32 op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations (+ - * / and each libm call counted as one) of one
# residual evaluation plus one Brent iteration's own ~30, counted from the
# residuals in csrc/; per hourly trip and layer for K4; per node for K6
RESIDUAL_OPS = {"glacier_brent": 55 + 30, "snowpack_brent": 55 + 30,
                "canopy_brent": 70 + 30, "surface_brent": 150 + 30}
FUSION_OPS = 20                   # the fusion term of K5, K7 and K14
RUNOFF_OPS_PER_LAYER_HOUR = 30
SWEEP_OPS_PER_NODE = 20           # t_lin and the bookkeeping
NODE_RESIDUAL_OPS = 30            # SoilThermalEqn with its unfrozen water
# K7: the FD residual (K5's plus the fusion term's) and the propose and
# accept steps' Brent arithmetic (~30) per lane and evaluation
FD_RESIDUAL_OPS = 150 + FUSION_OPS + 30
# K14 per evaluation: K7's residual and Brent step with nodes 1-2
# interpolated between the two probes (a division and 7 more); with
# DIST_PRCP every residual (K5, K7, K14) evaluates the dry column's ET too:
# a Penman of ~20 and the transpiration split of ~10 per soil layer
AFFINE_RESIDUAL_OPS = FD_RESIDUAL_OPS + 8
DRY_ET_OPS = 20 + 10 * 3
# K8 per snow-covered lane (csrc/blowing_snow.cu): 10 wind increments, each
# 26 shear residuals of ~9 and 24 bisection updates of ~4, one
# sub_with_height of ~55 at hsalt/2 and 16 quadrature nodes of ~75 (an exp,
# a sub_with_height, the transport integrand), ~170 of saltation terms,
# bounds and probability; ~60 once per lane
BLOWING_OPS_PER_LANE = 10 * (26 * 9 + 24 * 4 + 55 + 16 * 75 + 170) + 60
CANOPY_AIR_OPS_PER_LANE = 40      # the closed form and the secant guards
# The lake fixed points stop a lake at |change| <= 1e-4 (C for K10's skin
# temperature, W/m^2 for K11's qw): two runs that stop one iteration apart
# differ by about that much, so columns and qw agree within twice it, the
# fluxes of K10 within LAKE_FLUX_TOL (~30 W/m^2/K of flux sensitivity x
# 2e-4 C), and the rest at LAKE_RTOL; delta_h, a difference of float32
# column sums of ~1e16 J, within its ulp bound (vic_tpu_torch.testing)
LAKE_FP_TOL = 2e-4
LAKE_FLUX_TOL = 1e-2       # W/m^2
LAKE_RTOL = 1e-4
# K10/K11 FP32 operations (counted from csrc/lake.cuh and the kernels): a
# lake's set-up (density, heat capacity, energy, eddy diffusivity, the
# matrix and its elimination), each fixed-point iteration (the fluxes, the
# forward and back substitution, the column energy), and each red-black
# mix pass over one pair of active layers (two densities and the test)
LAKE_OPEN_SETUP_OPS = 2600
LAKE_OPEN_ITER_OPS = 300
LAKE_ICE_SETUP_OPS = 1900
LAKE_ICE_ITER_OPS = 260
LAKE_MIX_OPS_PER_PAIR = 25
LAKE_MIX_SWEEPS = 20
# K12: the ice residual and a Brent iteration; K13: 30 bisection steps of
# an area (~8 operations a trapezoid) and a volume (~12) over 20 trapezoids
RESIDUAL_OPS["lake_ice_brent"] = 60 + 30
RESIDUAL_OPS["affine_surface_brent"] = AFFINE_RESIDUAL_OPS
LAKE_DEPTH_OPS = 30 * 20 * (8 + 12)
# K15: ~15 operations a round, 8 rounds a lane; K16 a node per Newton step:
# the residual and the Jacobian row (~25) and the row scaling and Thomas
# solve (~15), and ~30 more for the three unfrozen-water evaluations of a
# node below 0 C where frozen soil is active; K17 a residual evaluation and
# a bisection step (~4)
MASS_RELEASE_OPS_PER_LANE = 8 * 15
IMPLICIT_OPS_PER_NODE = 40
IMPLICIT_ICE_OPS_PER_NODE = 30
BISECTION_STEP_OPS = 4
LOOP_TOL = 1e-5            # K15 and K17 vs their plain versions
IMPLICIT_TOL = 1e-4        # C, K16 vs its plain version


def phase(title):
    print(f"== {title}", flush=True)


def device_phase():
    phase("0 device")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


def build_phase():
    phase("1 build")
    from vic_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build(extra_flags=("-Xptxas", "-v"))
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    build.load()


def clone_args(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: clone_args(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # a NamedTuple
        return type(obj)(*(clone_args(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone_args(v) for v in obj)
    return obj


def capture_kernel_args(config, names, device, record=0, calls=None,
                        nth=None, build=None, cells=None):
    """Run `config` at its slice's size (or `cells`; build(n_cell, n_rec,
    device) in place of its builder, if given) up to its record `record`
    with each binding in `names` wrapped in that record's step; returns
    {kernel: (args, kwargs)} of its first call there, or of its call number
    nth[kernel] (from 0), and counts each kernel's calls in that step into
    the dict `calls`, if given. Names in MODEL_RESULTS are functions of
    vic_tpu_torch.model whose result is taken in place of their
    arguments."""
    from vic_tpu_torch import kernels, model
    from vic_tpu_torch.model import make_step

    captured = {}
    home = {name: model if name in MODEL_RESULTS else kernels
            for name in names}
    originals = {name: getattr(home[name], name) for name in names}
    calls = {} if calls is None else calls
    nth = nth or {}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            first = calls.get(name, 0) == nth.get(name, 0)
            calls[name] = calls.get(name, 0) + 1
            if first and name not in MODEL_RESULTS:
                captured[name] = (clone_args(args), clone_args(kwargs))
            out = fn(*args, **kwargs)
            if first and name in MODEL_RESULTS:
                captured[name] = clone_args(out)
            return out
        return wrapper

    gp, params, stack, state, extras = (build or CONFIGS[config])(
        cells or CELLS.get(config, SMOKE_CELLS), record + 1, device)
    step = make_step(params, gp, **extras)
    for r in range(record):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    for name, fn in originals.items():
        setattr(home[name], name, wrap(name, fn))
    try:
        step(state, {k: v[record] for k, v in stack.items()})
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(home[name], name, fn)
    missing = set(names) - set(captured)
    if missing:
        raise RuntimeError(f"kernels not reached by the {config} step: "
                           f"{missing}")
    return captured


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_brent(name, kern, plain):
    """Kernel vs plain Brent on the same lanes; raises outside tolerance."""
    root_k, conv_k, brack_k = kern.root, kern.converged, kern.bracketed
    root_p, conv_p, brack_p = plain.root, plain.converged, plain.bracketed
    active = brack_k | brack_p
    n_active = int(active.sum())
    flag_dis = int(((conv_k != conv_p) | (brack_k != brack_p)).sum())
    both = conv_k & conv_p
    diff = (root_k - root_p).abs()
    root_err = float(diff[both].max()) if bool(both.any()) else 0.0
    bracket = 2.0 * (2.0 * torch.finfo(torch.float32).eps * root_k.abs()
                     + BRENT_TOL)
    outside = int((both & (diff > bracket)).sum())
    over_tol = int((both & (diff > BRENT_TOL)).sum())
    max_abs = float(diff.max())
    print(f"  {name}: lanes {root_k.numel()}, bracketed {n_active}, "
          f"converged {int(conv_k.sum())}/{int(conv_p.sum())} (kernel/plain),"
          f" flag disagreements {flag_dis}, max |root diff| where both "
          f"converged {root_err:.3e} C ({over_tol} lanes above {BRENT_TOL} C,"
          f" {outside} outside the final bracket width), max |root diff| "
          f"{max_abs:.3e}, "
          f"kernel iterations {iterations_of(kern)}, "
          f"plain loop trips {plain.iterations}")
    if flag_dis > FLAG_DISAGREE_FRAC * max(n_active, 1):
        raise AssertionError(f"{name}: {flag_dis} converged/bracketed "
                             f"disagreements of {n_active} active lanes")
    if outside:
        raise AssertionError(f"{name}: {outside} roots differ by more than "
                             f"the final bracket width (max {root_err} C)")
    return root_err


def iterations_of(result):
    """Brent trips: the lanes' most (K1-K5) or the batch's (K7)."""
    its = result.iterations
    return int(its.max()) if isinstance(its, torch.Tensor) else int(its)


def compare_blowing(kern, plain, snowdepth, label):
    """K8 vs its plain version at rtol BLOWING_RTOL, atol BLOWING_ATOL; the
    path counts as exercised only if some snow-covered lane blows."""
    worst = 0.0
    for part, a, b in zip(("flux", "transport"), kern, plain):
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        bad = diff > BLOWING_ATOL + BLOWING_RTOL * b.abs()
        print(f"  blowing_snow ({label}) {part}: max |diff| "
              f"{float(diff.max()):.3e}, outside rtol={BLOWING_RTOL} "
              f"atol={BLOWING_ATOL}: {int(bad.sum())}")
        if bool(bad.any()):
            raise AssertionError(f"blowing_snow {part} outside tolerance")
    snow = (snowdepth > 0.0).expand(plain[0].shape)
    blowing = int((snow & (plain[0] != 0.0)).sum())
    print(f"  blowing_snow ({label}): {int(snow.sum())} snow-covered lanes, "
          f"{blowing} with a nonzero flux")
    if not blowing:
        raise AssertionError("blowing_snow: no snow-covered lane blows; the "
                             "path was not exercised")
    return worst


def compare_canopy_air(kern, plain, label):
    """K9 vs its plain version: tc_next and g within CANOPY_AIR_TOL, the
    batch maxima too, and the same stop decision."""
    from vic_tpu_torch.model import OVER_TOL_F32
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    stop_k = float(kern[2]) <= OVER_TOL_F32
    stop_p = float(plain[2]) <= OVER_TOL_F32
    print(f"  canopy_air_step ({label}): max |diff| tc_next {diffs[0]:.3e} "
          f"C, g {diffs[1]:.3e} C, batch max change {float(kern[2]):.6g} / "
          f"{float(plain[2]):.6g} C (kernel/plain), stop {stop_k}/{stop_p}")
    if max(diffs) > CANOPY_AIR_TOL or stop_k != stop_p:
        raise AssertionError("canopy_air_step outside tolerance")
    return max(diffs)


def compare_runoff(kern, plain, label):
    worst = 0.0
    for part, a, b in zip(("liq", "runoff_extra", "baseflow"), kern, plain):
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        bad = diff > RUNOFF_TOL + RUNOFF_TOL * b.abs()
        print(f"  runoff_hourly ({label}) {part}: max |diff| "
              f"{float(diff.max()):.3e}, outside rtol=atol={RUNOFF_TOL}: "
              f"{int(bad.sum())}")
        if bool(bad.any()):
            raise AssertionError(f"runoff_hourly ({label}) {part} outside "
                                 "tolerance")
    return worst


def compare_sweep(kern, plain, label):
    """K6 vs its plain version: node temperatures within SWEEP_TOL, equal
    per-node fallback counts and an equal batch-wide sweep count."""
    diff = float((kern.temp - plain.temp).abs().max())
    fb_dis = int((kern.fbcount != plain.fbcount).sum())
    sweeps_k, sweeps_p = int(kern.iterations), int(plain.iterations)
    print(f"  node_sweep ({label}): lanes {kern.temp[..., 0].numel()}, sweeps "
          f"{sweeps_k}/{sweeps_p} (kernel/plain), max |T diff| {diff:.3e} C, "
          f"fallback-count disagreements {fb_dis}, lanes with a fallback "
          f"{int((plain.fbcount > 0).any(-1).sum())}")
    if sweeps_k != sweeps_p:
        raise AssertionError(f"node_sweep: {sweeps_k} sweeps, plain "
                             f"{sweeps_p}")
    if fb_dis or not diff <= SWEEP_TOL:
        raise AssertionError(f"node_sweep: max |T diff| {diff} C, "
                             f"{fb_dis} fallback-count disagreements")
    return diff


def lake_energy_bound(kwargs, dt_sec):
    """delta_h's bound per lake: LAKE_ENERGY_ULPS ulps of the column's
    energy over (surface x dt) (vic_tpu_torch.testing)."""
    from vic_tpu_torch.physics import lake
    from vic_tpu_torch.testing import LAKE_ENERGY_ULPS
    temp, grid = kwargs["temp"], kwargs["grid"]
    energy = lake.energycalc(temp, grid, lake.specheat(temp),
                             lake.water_density(temp)).cpu().numpy()
    surface = grid.surface[..., 0].double().cpu().numpy()
    return (LAKE_ENERGY_ULPS * np.spacing(np.abs(energy)).astype(np.float64)
            / np.maximum(surface * dt_sec, 1e-12))


def compare_lake_fields(name, kern, plain, atol, skip=()):
    """Each float field of the lake results within atol[field] +
    LAKE_RTOL*|plain| on the lakes whose converged flags agree."""
    agree = kern.converged == plain.converged
    for field in kern._fields:
        a, b = getattr(kern, field), getattr(plain, field)
        if field in skip or not isinstance(a, torch.Tensor) \
                or a.dtype != torch.float32:
            continue
        ok = agree[..., None] if a.dim() == 2 else agree
        diff = torch.where(ok, (a - b).abs(), 0.0)
        tol = torch.as_tensor(atol[field], device=a.device)
        tol = tol[..., None] if a.dim() == 2 and tol.dim() else tol
        bad = int((diff > tol + LAKE_RTOL * b.abs()).sum())
        print(f"  {name} {field}: max |diff| {float(diff.max()):.3e}, "
              f"outside tolerance {bad}")
        if bad:
            raise AssertionError(f"{name} {field} outside tolerance")


def compare_lake_flags(name, kern, plain, active):
    n_active = int(active.sum())
    dis = int((kern.converged != plain.converged).sum())
    its = kern.iterations[active]
    print(f"  {name}: lakes {kern.converged.numel()}, active {n_active}, "
          f"converged {int(kern.converged[active].sum())}/"
          f"{int(plain.converged[active].sum())} (kernel/plain), flag "
          f"disagreements {dis}, kernel iterations mean "
          f"{float(its.float().mean()) if n_active else 0.0:.2f} max "
          f"{int(its.max()) if n_active else 0}, plain loop trips "
          f"{plain.iterations}")
    if not n_active:
        raise AssertionError(f"{name}: no active lake; the path was not "
                             "exercised")
    if dis > FLAG_DISAGREE_FRAC * n_active:
        raise AssertionError(f"{name}: {dis} converged disagreements of "
                             f"{n_active} active lakes")


def compare_mixed(name, got, ref):
    """Columns within LAKE_FP_TOL but where a mix near 4 C fell the other
    way (vic_tpu_torch.testing.mixed_column_excess)."""
    from vic_tpu_torch.testing import mixed_column_excess
    diff = (got - ref).abs()
    over = int((diff.amax(-1) > LAKE_FP_TOL).sum())
    bad = mixed_column_excess(got.cpu().numpy(), ref.cpu().numpy(),
                              LAKE_FP_TOL)
    print(f"  {name}: max |T diff| {float(diff.max()):.3e} C, lakes beyond "
          f"{LAKE_FP_TOL} C {over} (each a mix near 4 C that fell the other "
          f"way), unexplained {len(bad)}")
    if bad:
        raise AssertionError(f"{name}: columns differ beyond a mixing flip "
                             f"at {bad[:5]}")
    return float(diff.max())


def compare_lake_open_water(kwargs):
    """K10 vs its plain version: (the kernel's WaterEBResult, its mixed
    column, the largest difference)."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_open_water_plain
    kern, t_open = kernels.lake_open_water(**kwargs)
    plain, t_open_p = lake_open_water_plain(**kwargs)
    torch.cuda.synchronize()
    compare_lake_flags("lake_open_water (open-water lakes)", kern, plain,
                       kwargs["active"])
    atol = dict(qh=LAKE_FLUX_TOL, qle=LAKE_FLUX_TOL, lwnet=LAKE_FLUX_TOL,
                delta_h=torch.as_tensor(lake_energy_bound(
                    kwargs, kwargs["dt_sec"]), dtype=torch.float32,
                    device=t_open.device) + LAKE_FLUX_TOL,
                energy_ice_formation=LAKE_FLUX_TOL, new_ice_area=1.0,
                new_ice_height=1e-6, new_ice_water_eq=1.0, evap_mm_s=1e-9,
                energy_out_bottom=LAKE_FLUX_TOL)
    compare_lake_fields("lake_open_water", kern, plain, atol,
                        skip=("temp",))
    # the reported error: the columns' (C)
    err = compare_mixed("lake_open_water temp", kern.temp, plain.temp)
    return kern, t_open, max(err, compare_mixed(
        "lake_open_water t_open (mixed)", t_open, t_open_p))


def compare_lake_under_ice(kwargs):
    """K11 vs its plain version: (the kernel's UnderIceResult, the largest
    difference)."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import water_under_ice_plain
    kern = kernels.lake_under_ice(**kwargs)
    plain = water_under_ice_plain(**kwargs)
    torch.cuda.synchronize()
    compare_lake_flags("lake_under_ice (ice-covered lakes)", kern, plain,
                       kwargs["active"])
    atol = dict(qw=LAKE_FP_TOL, energy_out_bottom=LAKE_FLUX_TOL,
                delta_h=torch.as_tensor(lake_energy_bound(
                    kwargs, kwargs["dt_sec"]), dtype=torch.float32,
                    device=kern.qw.device) + LAKE_FLUX_TOL)
    compare_lake_fields("lake_under_ice", kern, plain, atol, skip=("temp",))
    # the reported error: the column's (C)
    return kern, compare_mixed("lake_under_ice temp", kern.temp, plain.temp)


def compare_lake_depth(args):
    """K13 vs its plain version: depths equal, or within one final
    bisection step (maxdepth / 2^30)."""
    from types import SimpleNamespace

    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import DEPTH_ITERS, depth_from_volume_plain
    z, basin, maxdepth, volume = args
    kern = kernels.lake_depth(*args)
    plain = depth_from_volume_plain(
        SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth), volume)
    torch.cuda.synchronize()
    diff = (kern - plain).abs()
    step = maxdepth.expand(diff.shape) / 2.0 ** DEPTH_ITERS
    exact = int((diff == 0).sum())
    print(f"  lake_depth: lakes {diff.numel()}, equal depths {exact}, max "
          f"|diff| {float(diff.max()):.3e} m")
    if bool((diff > step).any()):
        raise AssertionError("lake_depth: depths differ by more than one "
                             "bisection step")
    return kern, float(diff.max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and FP32
    operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def brent_work(name, args, kwargs, kern):
    """Bytes in and out of one Brent kernel call, and its FP32 operations:
    residual evaluations that these inputs need (2 endpoints + one per
    iteration on bracketed lanes, 2 + 2*max_tries on unbracketed active
    lanes; bracket expansions of lanes that do bracket are not counted).
    K14 reads the fusion inputs and nodes 1-2 of the two probe profiles
    besides K5's inputs."""
    from vic_tpu_torch.kernels import FD_SURFACE_INPUTS, surface_inputs
    from vic_tpu_torch.ops.rootfind import MAXTRIES
    lo, hi, active = args[:3]
    ops_per_eval = RESIDUAL_OPS[name]
    if name in ("surface_brent", "affine_surface_brent"):
        kw = kwargs["eb_kwargs"]
        inputs = list(surface_inputs(kw).values())
        if kw.get("frozen_soil"):
            inputs += [kw[k] for k in FD_SURFACE_INPUTS + ("fs_active",)]
            if name == "surface_brent":
                ops_per_eval += FUSION_OPS
        if name == "affine_surface_brent":
            ts_a, t_a, ts_b, t_b = kw["fd_interp"]
            inputs += [ts_a, ts_b, t_a[..., 1:3], t_b[..., 1:3]]
        if kw.get("dist_dry") is not None:
            ops_per_eval += DRY_ET_OPS
        max_tries = MAXTRIES
    else:
        inputs = list(kwargs.values())
        max_tries = kwargs["max_tries"]
    bytes_in = nbytes(lo, hi, active, *inputs)
    bytes_out = nbytes(kern.root, kern.converged, kern.bracketed,
                       kern.iterations)
    act = active.expand(kern.root.shape)
    evals = torch.where(kern.bracketed, 2 + kern.iterations,
                        torch.where(act, 2 + 2 * max_tries, 0))
    return bytes_in + bytes_out, float(evals.sum()) * ops_per_eval


def fd_brent_work(kwargs, kern, evaluations):
    """Bytes in and out of one K7 call (each residual input once, the
    outputs once; the node profiles are K6's own) and its FP32 operations:
    `evaluations` residual launches on every lane, as the batch-wide sweep
    count of the reference makes every lane's profile depend on every
    candidate."""
    from vic_tpu_torch.kernels import FD_SURFACE_INPUTS, surface_inputs
    kw = kwargs["eb_kwargs"]
    inputs = list(surface_inputs(kw).values()) + [
        kw[k] for k in FD_SURFACE_INPUTS + ("fs_active",) if k in kw]
    bytes_moved = nbytes(*inputs, kern.root, kern.converged, kern.bracketed)
    ops = FD_RESIDUAL_OPS + (DRY_ET_OPS if kw.get("dist_dry") is not None
                             else 0)
    return bytes_moved, evaluations * kern.root.numel() * ops


def blowing_work(kwargs, result):
    from vic_tpu_torch.kernels import BLOWING_INPUTS, BLOWING_MASKS
    inputs = [kwargs[k] for k in BLOWING_INPUTS + BLOWING_MASKS]
    snow = (kwargs["snowdepth"] > 0.0).expand(result[0].shape)
    return (nbytes(*inputs, *result),
            float(snow.sum()) * BLOWING_OPS_PER_LANE)


def canopy_air_work(kwargs, result):
    return (nbytes(*kwargs.values(), *result),
            result[0].numel() * CANOPY_AIR_OPS_PER_LANE)


def runoff_work(args, result):
    liq = result[0]
    dt_hours = args[-1]
    lanes, nl = liq[..., 0].numel(), liq.shape[-1]
    return (nbytes(*args[:-1], *result),
            lanes * dt_hours * nl * RUNOFF_OPS_PER_LAYER_HOUR)


def sweep_work(args, kwargs, kern):
    """Bytes in and out of one K6 call, and its FP32 operations: every
    interior node per sweep, plus the residual evaluations of the nodes that
    start below 0 C where frozen soil is active (2 for nodes above the
    soil-layer count, 2 + 16 for deeper nodes; expansions not counted)."""
    t0, surf, kappa, cs, moist, ice0, geom, fs_active = args
    read = ("e_coef", "solver_max_moist", "solver_bubble", "solver_expt") + (
        ("zp1", "exp_a", "bexp") if kwargs.get("exp_trans")
        else ("alpha", "beta", "gamma"))
    geo = [getattr(geom, k) for k in read]
    bytes_moved = nbytes(t0, surf, kappa, cs, moist, ice0, fs_active, *geo,
                         kern.temp, kern.fbcount)
    nn = t0.shape[-1]
    sweeps = int(kern.iterations)
    cold = (t0[..., 1:nn - 1] < 0.0) & fs_active[:, None, None]
    evals = torch.where(torch.arange(1, nn - 1, device=t0.device)
                        < kwargs["nlayer"], 2, 18)
    ops = sweeps * (t0[..., 0].numel() * (nn - 2) * SWEEP_OPS_PER_NODE
                    + float((cold * evals).sum()) * NODE_RESIDUAL_OPS)
    return bytes_moved, ops


def lake_column_work(kwargs, kern, outputs, setup_ops, iter_ops,
                     mix_each_iteration):
    """Bytes in and out of one K10/K11 call and its FP32 operations: each
    active lake's set-up and the iterations it ran, and the red-black mix
    passes over its active layer pairs (once on every lake for K10, in
    each iteration for K11)."""
    grid, active = kwargs["grid"], kwargs["active"]
    inputs = [v for v in kwargs.values() if isinstance(v, torch.Tensor)]
    bytes_moved = nbytes(*inputs, *grid, *outputs)
    its = kern.iterations.double()
    pairs = (grid.numnod - 1).clamp(min=0).double()
    mix = LAKE_MIX_SWEEPS * pairs * LAKE_MIX_OPS_PER_PAIR
    act = active.double()
    ops = act * (setup_ops + its * iter_ops)
    ops = ops + (its * mix if mix_each_iteration else mix)
    return bytes_moved, float(ops.sum())


def lake_depth_work(args, kern):
    return nbytes(*args, kern), kern.numel() * LAKE_DEPTH_OPS


def check_lake_kernel(name, args, kwargs, calls, label="lakes",
                      record=LAKES_RECORD):
    """K10-K13 on the arguments of their first call in the `label` step's
    record `record` (`calls` calls in that record) against their plain
    versions; returns (largest difference, (bytes, operations) of the
    call). On the heavy step K12 must see the blowing-snow flux over lake
    ice on some bracketed lake."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_ice_brent_plain
    print(f"  {name}: {calls} calls in the {label} step's record {record}")
    if name == "lake_open_water":
        kern, t_open, err = compare_lake_open_water(kwargs)
        return err, lake_column_work(kwargs, kern, list(kern) + [t_open],
                                     LAKE_OPEN_SETUP_OPS, LAKE_OPEN_ITER_OPS,
                                     mix_each_iteration=False)
    if name == "lake_under_ice":
        kern, err = compare_lake_under_ice(kwargs)
        return err, lake_column_work(kwargs, kern, list(kern),
                                     LAKE_ICE_SETUP_OPS, LAKE_ICE_ITER_OPS,
                                     mix_each_iteration=True)
    if name == "lake_depth":
        kern, err = compare_lake_depth(args)
        return err, lake_depth_work(args, kern)
    kern = kernels.lake_ice_brent(*args, **kwargs)
    plain = lake_ice_brent_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = compare_brent(f"{name} ({label})", kern, plain)
    if not int(kern.bracketed.sum()):
        raise AssertionError("lake_ice_brent: no lake bracketed; the path "
                             "was not exercised")
    if label == "heavy":
        blown = kwargs["blowing_flux"].expand(kern.root.shape) != 0.0
        print(f"  lake_ice_brent (heavy): {int(blown.sum())} lakes with a "
              f"blowing-snow flux, {int((blown & kern.bracketed).sum())} of "
              "them bracketed")
        if not bool((blown & kern.bracketed).any()):
            raise AssertionError("lake_ice_brent: no bracketed lake with a "
                                 "blowing-snow flux; the path was not "
                                 "exercised")
    return err, brent_work(name, args, kwargs, kern)


def dry_column_lanes(name, eb_kwargs):
    """Print and check that a surface Brent's residual carries DIST_PRCP's
    dry column with some lane on a wet fraction mu < 1."""
    mu = eb_kwargs.get("mu_wet")
    wet_part = int((mu < 1.0).sum()) if mu is not None else 0
    print(f"  {name}: {wet_part} lanes with a wet fraction mu < 1")
    if eb_kwargs.get("dist_dry") is None or not wet_part:
        raise AssertionError(f"{name}: no lane with a dry column; the path "
                             "was not exercised")


def compare(name, label, kern, plain, kwargs):
    """A kernel's result against its plain version's on the arguments the
    `label` step gave it; returns the largest difference."""
    if name == "blowing_snow":
        if label == "heavy":
            label = "heavy, lake lanes"
        return compare_blowing(kern, plain, kwargs["snowdepth"], label)
    if name == "canopy_air_step":
        return compare_canopy_air(kern, plain, label)
    if name == "runoff_hourly":
        return compare_runoff(kern, plain, label)
    if name == "node_sweep":
        return compare_sweep(kern, plain, label)
    if label in DIST_PRCP_CONFIGS and name in SURFACE_KERNELS:
        dry_column_lanes(f"{name} ({label})", kwargs["eb_kwargs"])
    return compare_brent(f"{name} ({label})", kern, plain)


def check_kernel(name, label, args, kwargs, kern_fn, plain_fn, captured,
                 also_on=()):
    """K1-K9 and K14 on the arguments the `label` step gave them against
    their plain versions, then on those of the steps in `also_on`; returns
    (largest difference, (bytes, operations) of the first call)."""
    from vic_tpu_torch import kernels
    sweeps_before = kernels.launches["node_sweep"]
    kern = kern_fn(*args, **kwargs)
    evaluations = kernels.launches["node_sweep"] - sweeps_before
    plain = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    err = compare(name, label, kern, plain, kwargs)
    if name == "fd_surface_brent":
        print(f"  fd_surface_brent ({label}): {evaluations} residual "
              "evaluations (node_sweep calls) in the kernel's solve")
        work = fd_brent_work(kwargs, kern, evaluations)
    elif name == "blowing_snow":
        work = blowing_work(kwargs, kern)
    elif name == "canopy_air_step":
        work = canopy_air_work(kwargs, kern)
    elif name == "runoff_hourly":
        work = runoff_work(args, kern)
    elif name == "node_sweep":
        work = sweep_work(args, kwargs, kern)
    else:
        work = brent_work(name, args, kwargs, kern)
    for also in also_on:
        a, kw = captured[also][name]
        if name == "snowpack_brent" and also == "blowing_close":
            print(f"  snowpack_brent (blowing_close): "
                  f"{int((kw['blowing_flux'] != 0).sum())} lanes with a "
                  "blowing flux")
        err = max(err, compare(name, also, kern_fn(*a, **kw),
                               plain_fn(*a, **kw), kw))
    return err, work


def step_label(config, nnode):
    return f"{config}/nnode={nnode}" if nnode else config


def kernels_phase(device):
    phase(f"2 kernels at {SMOKE_CELLS} cells (heavy_nolakes {HEAVY_CELLS})")
    from vic_tpu_torch import kernels
    # one capture run per step, wrapping the kernels of the rows on it and
    # those ALSO_ON holds on it
    steps = {}
    for row, (name, config, nnode) in ROWS.items():
        steps.setdefault((config, nnode), set()).add(
            CAPTURED_FROM.get(row, CAPTURED_FROM.get(name, name)))
    for name, labels in ALSO_ON.items():
        for config in labels:
            steps.setdefault((config, None), set()).add(name)
    captured, calls = {}, {}
    for (config, nnode), names in steps.items():
        label = step_label(config, nnode)
        calls[label] = {}
        captured[label] = capture_kernel_args(
            config, sorted(names), device, record=RECORD.get(config, 0),
            calls=calls[label], nth=NTH.get(config),
            build=node_count_build(nnode) if nnode else None,
            cells=NODE_COUNT_CELLS if nnode else None)
        print(f"  {label} step record {RECORD.get(config, 0)}: kernel calls "
              f"{calls[label]}")
    results = {}
    for row, (name, config, nnode) in ROWS.items():
        source, replaces, module, plain_name, _ = KERNELS[name]
        label = step_label(config, nnode)
        kern_fn = getattr(kernels, name)
        if name in LOOP_KERNELS:
            results[row] = check_loop_kernel(row, name, captured[label],
                                             label)
            continue
        args, kwargs = captured[label][name]
        plain_fn = getattr(importlib.import_module(
            f"vic_tpu_torch.physics.{module}"), plain_name)
        if name == "lake_depth":
            # the plain version takes the lake parameters, the kernel their
            # profiles
            from types import SimpleNamespace
            z, basin, maxdepth, _ = args
            lp = SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth)
            plain_fn = (lambda fn: lambda *a: fn(lp, a[3]))(plain_fn)
        if row != name:
            check_form(row, nnode, args, kwargs)
        if name in LAKE_KERNELS:
            err, work = check_lake_kernel(name, args, kwargs,
                                          calls[label][name])
            for also in ALSO_ON[name]:
                a, kw = captured[also][name]
                err = max(err, check_lake_kernel(
                    name, a, kw, calls[also][name], also, RECORD[also])[0])
        else:
            err, work = check_kernel(
                name, label if row == name else row, args, kwargs, kern_fn,
                plain_fn, captured, ALSO_ON.get(name, ()) if row == name
                else ())
        ms = cuda_ms(lambda: kern_fn(*args, **kwargs), reps=20)
        plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs), reps=3)
        bound_ms, bound_by = bound(*work)
        print(f"  {row}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
              f"{work[1]:.4g} FP32 operations)")
        results[row] = dict(
            name=row, route="cuda", source=CSRC + source, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        if row in HEAVY_LAKE_TIMED:
            # the heavy path's own form of the kernel: K12 with the
            # blowing-snow flux, K8 on the 8,192 lake lanes
            a, kw = captured["heavy"][name]
            kern = kern_fn(*a, **kw)
            work = (brent_work(name, a, kw, kern) if name == "lake_ice_brent"
                    else blowing_work(kw, kern))
            bound_ms, bound_by = bound(*work)
            print(f"  {name} ({HEAVY_LAKE_TIMED[name]}): kernel "
                  f"{cuda_ms(lambda: kern_fn(*a, **kw), reps=20):.4f} ms, "
                  f"plain torch "
                  f"{cuda_ms(lambda: plain_fn(*a, **kw), reps=3):.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
                  f"{work[1]:.4g} FP32 operations)")
    return results


# the kernels no step calls (K15-K17)
LOOP_KERNELS = ("mass_release", "implicit_profile", "bisection")


def loop_args(row, name, captured):
    """(args, kwargs) of K15-K17's row `row` from what the step gave:
    snow_intercept's canopy snow and melt storage for K15; K6's arguments
    for K16, with the step's NOFLUX; K2's or K1's for K17, BISECTION_ITERS
    steps."""
    if name == "mass_release":
        ci = captured["snow_intercept"]
        return (ci.int_snow, ci.temp_int_storage), {}
    if name == "implicit_profile":
        a, kw = captured["node_sweep"]
        return a, dict(dt_sec=kw["dt_sec"], noflux=kw["noflux"],
                       frozen=kw["frozen"])
    a, kw = captured[CAPTURED_FROM[row]]
    inputs = {k: v for k, v in kw.items()
              if k not in ("max_iter", "max_tries")}
    return (row.split("/")[1],) + tuple(a) + (BISECTION_ITERS,), inputs


def compare_loop(row, name, kern, plain):
    """K15-K17 against their plain versions; returns the largest
    difference."""
    if name == "implicit_profile":
        diff = float((kern.temp - plain.temp).abs().max())
        fb_dis = int((kern.fbcount != plain.fbcount).sum())
        print(f"  {row}: lanes {kern.temp[..., 0].numel()}, max |T diff| "
              f"{diff:.3e} C, fallback-count disagreements {fb_dis}, lanes "
              f"with a fallback {int((plain.fbcount > 0).any(-1).sum())}")
        if fb_dis or not diff <= IMPLICIT_TOL:
            raise AssertionError(f"{row}: max |T diff| {diff} C, {fb_dis} "
                                 "fallback-count disagreements")
        return diff
    if name == "bisection":
        flag_dis = int((kern.bracketed != plain.bracketed).sum())
        diff = float((kern.root - plain.root).abs().max())
        print(f"  {row}: lanes {kern.root.numel()}, bracketed "
              f"{int(kern.bracketed.sum())}, flag disagreements {flag_dis}, "
              f"max |root diff| {diff:.3e} C")
        if flag_dis or not diff <= LOOP_TOL or not bool(kern.bracketed.any()):
            raise AssertionError(f"{row}: {flag_dis} flag disagreements, "
                                 f"max |root diff| {diff} C")
        return diff
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    print(f"  {row}: lanes {kern[0].numel()}, lanes releasing "
          f"{int((plain[2] > 0).sum())}, dripping {int((plain[3] > 0).sum())}"
          f", max |diff| {max(diffs):.3e} m")
    if not max(diffs) <= LOOP_TOL:
        raise AssertionError(f"{row}: max |diff| {max(diffs)} m")
    return max(diffs)


def loop_work(name, args, kwargs, kern):
    """Bytes in and out of one K15-K17 call and its FP32 operations (K16:
    every node of every Newton step, the unfrozen-water terms on the nodes
    that start below 0 C where frozen soil is active; K17: BISECTION_ITERS +
    2 residual evaluations on active lanes)."""
    if name == "mass_release":
        return (nbytes(*args, *kern),
                kern[0].numel() * MASS_RELEASE_OPS_PER_LANE)
    if name == "implicit_profile":
        from vic_tpu_torch.kernels import IMPLICIT_GEOMETRY
        t0, surf, kappa, cs, moist, ice0, geom, fs_active = args
        geo = [getattr(geom, k) for k in IMPLICIT_GEOMETRY]
        cold = (t0 < 0.0) & fs_active[:, None, None] if kwargs["frozen"] \
            else torch.zeros_like(t0, dtype=torch.bool)
        ops = kern.iterations * (t0.numel() * IMPLICIT_OPS_PER_NODE
                                 + float(cold.sum())
                                 * IMPLICIT_ICE_OPS_PER_NODE)
        return (nbytes(t0, surf, kappa, cs, moist, ice0, fs_active, *geo,
                       kern.temp, kern.fbcount), ops)
    residual, lo, hi, active, n_iter = args
    ops = RESIDUAL_OPS[f"{residual}_brent"] - 30 + BISECTION_STEP_OPS
    act = float(active.expand(kern.root.shape).sum())
    return (nbytes(lo, hi, active, *kwargs.values(), *kern),
            act * (n_iter + 2) * ops)


def check_loop_kernel(row, name, captured, label):
    """K15-K17's row `row` on what the `label` step gave: compared with its
    plain version (K16 with NOFLUX both ways; K15 also on seeded storage
    that releases), timed, and given its bound; returns its row of the
    kernels line."""
    from vic_tpu_torch import kernels
    source, replaces, module, plain_name, _ = KERNELS[name]
    kern_fn = getattr(kernels, name)
    plain_fn = getattr(importlib.import_module(
        f"vic_tpu_torch.physics.{module}"), plain_name)
    args, kwargs = loop_args(row, name, captured)
    print(f"  {row}: on the {label} step's record {RECORD.get(label, 0)}")
    kern = kern_fn(*args, **kwargs)
    err = compare_loop(row, name, kern, plain_fn(*args, **kwargs))
    if name == "implicit_profile":
        other = dict(kwargs, noflux=not kwargs["noflux"])
        err = max(err, compare_loop(f"{row} (noflux={other['noflux']})",
                                    name, kern_fn(*args, **other),
                                    plain_fn(*args, **other)))
    if name == "mass_release":
        # storage up to 30% of the canopy snow: the release branch too
        gen = torch.Generator(device=args[0].device).manual_seed(3)
        storage = args[0] * 0.3 * torch.rand(
            args[0].shape, generator=gen, device=args[0].device)
        err = max(err, compare_loop(f"{row} (seeded storage)", name,
                                    kern_fn(args[0], storage),
                                    plain_fn(args[0], storage)))
    ms = cuda_ms(lambda: kern_fn(*args, **kwargs), reps=20)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs), reps=3)
    work = loop_work(name, args, kwargs, kern)
    bound_ms, bound_by = bound(*work)
    print(f"  {row}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
          f"{work[1]:.4g} FP32 operations)")
    return dict(name=row, route="cuda", source=CSRC + source,
                replaces=replaces, launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def node_count_build(nnode):
    """frozen_exp's builder with its node count replaced."""
    from vic_tpu_torch import entry

    def build(n_cell, n_rec, device):
        gp = entry.frozen_exp_params(n_rec).replace(nnode=nnode)
        return entry._build(gp, n_cell, n_rec, device)
    return build


def check_form(row, nnode, args, kwargs):
    """Raise unless a row frozen soil or SPATIAL_SNOW adds carries what it
    stands for: K6 on frozen_exp's EXP_TRANS profile (at its node count or
    `nnode`) with interior nodes below 0 C where frozen soil is active, K5
    with the fusion term on active lanes with top-layer ice, K2 and K5 on
    active lanes whose pack covers part of the lane."""
    if row.endswith("/spatial_snow"):
        coverage = (kwargs["eb_kwargs"]["snow_coverage"]
                    if row.startswith("surface_brent/")
                    else kwargs["snow_cover_fract"])
        check_coverage(row, coverage, args[2])
    elif row.startswith("node_sweep/"):
        nn = args[0].shape[-1]
        cold = int(((args[0][..., 1:nn - 1] < 0.0)
                    & args[7][:, None, None]).sum())
        print(f"  {row}: {nn} nodes, exp_trans {kwargs['exp_trans']}, "
              f"{cold} interior nodes below 0 C with frozen soil active")
        if not kwargs["exp_trans"] or nn != (nnode or 10) or not cold:
            raise AssertionError(f"{row}: not the EXP_TRANS profile with "
                                 "frozen nodes it stands for")
    elif row.startswith("surface_brent/"):
        eb = kwargs["eb_kwargs"]
        live = int((args[2] & (eb["ice0_vol"] > 0.0)).sum())
        print(f"  {row}: {live} active lanes with top-layer ice in the "
              "fusion term")
        if not eb.get("frozen_soil") or not live:
            raise AssertionError(f"{row}: no fusion term; the path was not "
                                 "exercised")


def check_coverage(row, coverage, active):
    """Print the active lanes whose pack covers part of the lane, and raise
    if there is none."""
    cov = coverage.expand(active.shape)
    partial = int(((cov > 0.0) & (cov < 1.0) & active).sum())
    print(f"  {row}: {partial} active lanes with 0 < coverage < 1")
    if not partial:
        raise AssertionError(f"{row}: no fractional coverage; the path was "
                             "not exercised")


def reference_phase(device, config):
    """Returns the fixture's largest |OUT_WATER_ERROR|."""
    from vic_tpu_torch.model import run

    ref = np.load(FIXTURES / FIXTURE_FILES.get(config, f"{config}_16x4.npz"))
    n_rec, n_cell = ref["out/OUT_EVAP"].shape
    phase(f"3 reference: {config}, {n_cell} cells x {n_rec} records vs the "
          "vic_tpu fixture")
    gp, params, stack, state, extras = CONFIGS[config](n_cell, n_rec, device)
    final, outs = run(state, stack, params, gp, **extras)
    torch.cuda.synchronize()
    got = {f"out/{k}": v for k, v in outs.items()}
    got.update({f"state/{k}": v for k, v in final.numpy().items()})
    if set(got) != set(ref.files):
        raise AssertionError(f"fixture keys differ: "
                             f"{sorted(set(got) ^ set(ref.files))}")
    got = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    ref = dict(ref)
    worst = {k: float(np.abs(a - got[k]).max()) for k, a in ref.items()
             if a.dtype.kind == "f"}
    # the tolerance leaves as the CPU tests hold them
    # (vic_tpu_torch.testing.lake_run_failures, heavy_run_failures,
    # heavy_lake_run_failures); elsewhere rtol = atol
    if config in ("frozen_exp", "frozen_quick"):
        failed = frozen_run_failures(ref, got, REF_TOL)
    elif config in ("heavy_nolakes", "heavy"):
        failed = (heavy_run_failures(ref, got, REF_TOL)
                  if config == "heavy_nolakes" else heavy_lake_run_failures(
                      ref, got, REF_TOL, params.cell_area.cpu().numpy(),
                      gp.dt * 3600.0))
        edge = thaw_edge_cells(ref)
        for key in failed:
            d = np.abs(got[key] - ref[key])
            d = np.moveaxis(d, 1 if key.startswith("out/") else 0, 0)
            d = d.reshape(edge.size, -1).max(1)
            print(f"  {key}: max |diff| on the thaw-edge cells "
                  f"{d[edge].max():.4g}, on the others {d[~edge].max():.4g}")
    else:
        failed = lake_run_failures(ref, got, REF_TOL,
                                   params.cell_area.cpu().numpy())
    top = sorted(worst, key=worst.get, reverse=True)[:8]
    print("  largest differences: " + ", ".join(
        f"{k} {worst[k]:.3e}" for k in top) + f"; {len(worst)} float arrays")
    ref_werr = float(np.abs(ref["out/OUT_WATER_ERROR"]).max())
    got_werr = float(np.abs(got["out/OUT_WATER_ERROR"]).max())
    print(f"  max |OUT_WATER_ERROR| {got_werr:.4e} mm, the fixture's "
          f"{ref_werr:.4e} mm")
    if failed:
        raise AssertionError(f"outside rtol=atol={REF_TOL}: {failed}")
    return ref_werr


def flat_tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from flat_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from flat_tensors(v)


def guard_plain_solvers():
    """Replace ops.rootfind.batched_brent and batched_bisection,
    ops.tridiag.thomas_solve and every *_plain solver, in each
    vic_tpu_torch module that holds one, by a wrapper that raises if it is
    handed a CUDA tensor. Returns the function that puts them back."""
    import sys
    patched = []

    def guarded(name, fn):
        def wrapper(*args, **kwargs):
            if any(t.is_cuda for t in flat_tensors((args, kwargs))):
                raise AssertionError(f"{name}, a plain version, ran on a "
                                     "CUDA tensor on the card's path")
            return fn(*args, **kwargs)
        return wrapper

    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith("vic_tpu_torch"):
            continue
        for attr, fn in list(vars(mod).items()):
            if callable(fn) and (attr in ("batched_brent", "batched_bisection",
                                         "thomas_solve")
                                 or attr.endswith("_plain")):
                patched.append((mod, attr, fn))
                setattr(mod, attr, guarded(f"{mod_name}.{attr}", fn))

    def restore():
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
    return restore


def slice_phase(device, config, ref_werr=None, nnode=None):
    """ref_werr: the configuration's fixture's largest |OUT_WATER_ERROR|,
    printed beside the slice's; nnode: frozen_exp's configuration with its
    node count replaced, at NODE_COUNT_CELLS cells."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.model import run

    n_cell = NODE_COUNT_CELLS if nnode else CELLS.get(config, SMOKE_CELLS)
    gp, params, stack, state, extras = (
        node_count_build(nnode) if nnode else CONFIGS[config])(
            n_cell, SMOKE_RECS, device)
    phase(f"4 slice: {step_label(config, nnode)}, {n_cell} cells x "
          f"{SMOKE_RECS} records of {gp.dt} h")
    # warm-up record, outside the timed and counted run
    run(state, {k: v[:1] for k, v in stack.items()}, params, gp, **extras)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    restore = guard_plain_solvers()
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs = run(state, stack, params, gp, **extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(device)

    for k, v in outs.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k} is not finite")
        if v.shape[:2] != (SMOKE_RECS, n_cell):
            raise AssertionError(f"{k} has shape {tuple(v.shape)}")
    for k, v in final.numpy().items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"state {k} is not finite")
    werr_cell = outs["OUT_WATER_ERROR"].abs().amax(0)
    werr = float(werr_cell.max())
    rate = n_cell * SMOKE_RECS / wall
    print(f"  {len(outs)} outputs finite; max |OUT_WATER_ERROR| {werr:.3e} mm"
          + (f" (the fixture's {ref_werr:.3e} mm)" if ref_werr is not None
             else ""))
    print(f"  {rate:.1f} cell-steps/s ({wall:.3f} s for {SMOKE_RECS} records, "
          f"warm-up record excluded); peak device memory {peak} bytes")
    print(f"  kernel launches in this run: {launches}")
    print("  kernel launches per record: " + json.dumps(
        {k: v / SMOKE_RECS for k, v in launches.items() if v}))
    if config in ("frozen", "frozen_exp", "frozen_quick"):
        ice = float(final.ice.sum())
        print(f"  layer ice at the end {ice:.1f} mm summed over lanes; "
              f"OUT_FDEPTH max {float(outs['OUT_FDEPTH'].max()):.3f} cm; "
              f"max |OUT_FUSION| {float(outs['OUT_FUSION'].abs().max()):.4g}"
              f" W/m^2; node temperatures {tuple(final.node_temp.shape)}")
        if not ice > 0.0:
            raise AssertionError(f"{config}: no layer ice; frozen soil was "
                                 "not exercised")
    if config == "frozen_exp" and not nnode:
        layer_ice_cost(device, final, params, gp, extras["geom"])
    if config in ("blowing_close", "heavy_nolakes", "heavy"):
        passes = [int(x) for x in outs["OUT_TCANOPY_ITER"][:, 0].tolist()]
        print(f"  CLOSE_ENERGY passes per record: {passes}; max "
              f"|OUT_SUB_BLOWING| "
              f"{float(outs['OUT_SUB_BLOWING'].abs().max()):.4g} mm")
    if config in ("lakes", "heavy"):
        ice = outs["OUT_LAKE_ICE_FRACT"]
        print(f"  lakes: ice fraction per record min/max "
              f"{[round(float(x), 4) for x in ice.amin(1)]} / "
              f"{[round(float(x), 4) for x in ice.amax(1)]}; lakes with "
              f"snow at the end {int((final.lake_swe > 0).sum())}; max "
              f"|OUT_LAKE_WATER_ERROR| "
              f"{float(outs['OUT_LAKE_WATER_ERROR'].abs().max()):.3e} mm; "
              f"OUT_LAKE_ENERGY_ERROR "
              f"{float(outs['OUT_LAKE_ENERGY_ERROR'].min()):.4g} to "
              f"{float(outs['OUT_LAKE_ENERGY_ERROR'].max()):.4g} W/m^2")
    if config in ("heavy_nolakes", "heavy"):
        ice = float(final.ice.max())
        print(f"  lanes with a wet fraction mu < 1 at the end "
              f"{int((final.mu < 1.0).sum())}; max layer ice {ice:.1f} mm; "
              f"OUT_FDEPTH max {float(outs['OUT_FDEPTH'].max()):.3f} cm; "
              f"max |OUT_WATER_ERROR| of the even (warm, raining) cells "
              f"{float(werr_cell[0::2].max()):.3e} mm, of the odd (cold) "
              f"cells {float(werr_cell[1::2].max()):.3e} mm")
        # vic_tpu's DIST_PRCP closure leaves ~0.1 mm on the raining warm
        # cells (ROADMAP.md queue 3): only the cold cells are held
        werr = float(werr_cell[1::2].max())
    if werr > WATER_TOL:
        raise AssertionError(f"water balance error {werr} mm")
    if config == "spatial_snow":
        spatial_snow_checks(state, stack, params, gp, extras, final, outs)
    idle = [k for k in PATH_KERNELS[config] if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the {config} "
                             f"slice: {idle}")
    return launches


def spatial_snow_checks(state, stack, params, gp, extras, final, outs):
    """The share of snow lanes whose pack covers part of the lane at the
    end of the spatial_snow slice, then CONTINUEONERROR: the slice again
    with NaN air temperature in NAN_CELLS cells from record NAN_FROM, the
    plain solvers guarded. Those cells must read OUT_CELL_VALID 0 from
    there and end with their state after record NAN_FROM - 1; every other
    cell's outputs and state must equal the first run's (nothing in the
    light step couples cells)."""
    from vic_tpu_torch.model import run
    snow = (final.swq > 0.0) & params.mask
    partial = snow & (final.coverage > 0.0) & (final.coverage < 1.0)
    cell_cov = outs["OUT_SNOW_COVER"]
    print(f"  snow lanes with 0 < coverage < 1 at the end: "
          f"{int(partial.sum())} of {int(snow.sum())} "
          f"({float(partial.sum()) / max(float(snow.sum()), 1.0):.4f}); "
          f"cells with 0 < OUT_SNOW_COVER < 1 per record "
          f"{((cell_cov > 0.0) & (cell_cov < 1.0)).sum(1).tolist()}; max "
          f"|OUT_ADV_SENS| {float(outs['OUT_ADV_SENS'].abs().max()):.4g} "
          "W/m^2")
    if not bool(partial.any()):
        raise AssertionError("spatial_snow: no fractional coverage")
    n_cell = cell_cov.shape[1]
    cells = torch.arange(0, n_cell, n_cell // NAN_CELLS,
                         device=cell_cov.device)[:NAN_CELLS]
    others = torch.ones(n_cell, dtype=torch.bool, device=cell_cov.device)
    others[cells] = False
    air = stack["air_temp"].clone()
    air[NAN_FROM:, cells] = float("nan")
    restore = guard_plain_solvers()
    try:
        final_n, outs_n = run(state, dict(stack, air_temp=air), params, gp,
                              **extras)
        torch.cuda.synchronize()
    finally:
        restore()
    before, _ = run(state, {k: v[:NAN_FROM] for k, v in stack.items()},
                    params, gp, **extras)
    valid = torch.ones_like(outs_n["OUT_CELL_VALID"])
    valid[NAN_FROM:, cells] = 0.0
    bad = []
    if not torch.equal(outs_n["OUT_CELL_VALID"], valid):
        bad.append("OUT_CELL_VALID")
    bad += [k for k, v in outs_n.items()
            if not torch.equal(v[:, others], outs[k][:, others])]
    frozen_fields = 0
    for name in (f.name for f in dataclasses.fields(final_n)):
        if name == "cell_valid":
            continue
        got = getattr(final_n, name)
        if not torch.equal(got[others], getattr(final, name)[others]):
            bad.append(f"state/{name} (other cells)")
        if not torch.equal(got[cells], getattr(before, name)[cells]):
            bad.append(f"state/{name} (NaN cells)")
        frozen_fields += 1
    print(f"  CONTINUEONERROR: NaN air temperature in {len(cells)} cells "
          f"from record {NAN_FROM}: cells valid at the end "
          f"{int(final_n.cell_valid.sum())} of {n_cell}; {frozen_fields} "
          f"state fields of the NaN cells held at record {NAN_FROM - 1}'s; "
          f"outputs and state of the other cells equal to the first run: "
          f"{'yes' if not bad else 'no'}")
    if bad:
        raise AssertionError(f"CONTINUEONERROR: differs from the first run "
                             f"or not frozen: {bad}")


def layer_ice_cost(device, final, params, gp, geom):
    """CUDA-event ms and peak extra device bytes of one estimate_layer_ice
    call over SPATIAL_FROST's subareas and over one area, on the slice's
    final node temperatures and moisture (the step makes one call a
    record, two with DIST_PRCP)."""
    from vic_tpu_torch.physics.frozen_soil import (estimate_layer_ice,
                                                   frost_kwargs,
                                                   layer_ice_params)
    soil = layer_ice_params(params.max_moist, params.bubble, params.expt,
                            params.fs_active)
    for label, kw in (("frost subareas", frost_kwargs(gp)),
                      ("one area", dict(frost_subareas=1))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        ms = cuda_ms(lambda: estimate_layer_ice(final.node_temp, final.moist,
                                                geom, soil, **kw), reps=10)
        extra = torch.cuda.max_memory_allocated(device) - base
        print(f"  layer ice ({label}: {kw}): {ms:.4f} ms a call, peak "
              f"{extra} bytes above the run's")


DRIVER_CELLS = HEAVY_CELLS   # a basin: bench.py's heavy size
DRIVER_DAYS = 370
DRIVER_START = (1995, 10, 1)
DRIVER_CHUNK = 100           # records per chunk
DRIVER_CELL_CHUNK = 4096
WARM_RECS = 3                # records after the warm start
# tests/test_state_io.py's legacy resume test: the legacy formats do not
# carry LongUnderOut, re-derived on a warm start
WARM_MOIST_TOL = (1e-3, 5e-3)   # rtol, atol
WARM_SWQ_TOL = (8e-2, 1e-3)
# the state the reference's legacy state files carry for the light flags
STATE_FILE_FIELDS = (
    "moist", "ice", "wdew", "snow_canopy", "swq", "surf_temp", "pack_temp",
    "surf_water", "pack_water", "density", "depth", "albedo", "last_snow",
    "melting", "cold_content", "node_temp", "tfoliage", "glac_water_storage",
    "glac_cum_mass_balance", "glac_surf_temp", "surf_temp_fbcount",
    "snow_temp_fbcount")


def driver_phase(device):
    """Returns the seconds the phase took."""
    from vic_tpu_torch import driver, kernels
    from vic_tpu_torch.io import native
    from vic_tpu_torch.testing import (binary_readback_error, relocate_run,
                                       run_arrays, water_closure,
                                       write_driver_run)

    phase(f"5 driver: {DRIVER_CELLS} cells x {DRIVER_DAYS} daily records "
          "from reference-format files")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gfile = write_driver_run(os.path.join(tmp, "run"), DRIVER_CELLS,
                                 start=DRIVER_START, n_day=DRIVER_DAYS,
                                 accum_start=DRIVER_START)
        print(f"  inputs written in {time.perf_counter() - t0:.3f} s")
        restore = guard_plain_solvers()
        try:
            kernels.reset_launches()
            res = driver.run_main(["-g", gfile, "--chunk", str(DRIVER_CHUNK)])
            launches = {k: kernels.launches[k] for k in PATH_KERNELS["light"]}
        finally:
            restore()
        st = res.stage_s
        print(f"  seconds: parameter files {st['params']:.3f}, forcing with "
              f"MTCLIM {st['forcing']:.3f}, model run {st['run']:.3f} "
              f"({res.cell_steps_per_s:.1f} cell-steps/s), outputs and "
              f"state {st['write']:.3f}")
        print(f"  peak device memory {res.peak_device_bytes} bytes; "
              f"libnetcdf found: {native.netcdf_found()}")
        print(f"  kernel launches: {launches}; per record " + json.dumps(
            {k: v / DRIVER_DAYS for k, v in launches.items()}))
        # where a lane's pack melts out within a record vic_tpu's own snow
        # budget drops the pack's liquid water, cell for cell with the port
        # (testing.water_closure, ROADMAP.md queue 3): on melt records the
        # bound grows by the liquid-water capacity of the cell's pack
        excess, n_melt, werr_melt, werr = water_closure(res.outputs,
                                                        WATER_TOL)
        print(f"  max |OUT_WATER_ERROR| {werr:.4e} mm off the records where "
              f"snow melts; on those {werr_melt:.4e} mm ({n_melt} "
              f"cell-records above {WATER_TOL} mm), largest excess over "
              f"{WATER_TOL} mm + 0.035 x the previous OUT_SWE {excess:.4e}")
        for r in res.gmb_results:
            print(f"  GMB fit at {r.date}: b0 {r.b0.min():.6g}..{r.b0.max():.6g}"
                  f", b1 {r.b1.min():.6g}..{r.b1.max():.6g}, b2 "
                  f"{r.b2.min():.6g}..{r.b2.max():.6g}, points per cell "
                  f"{int(r.n_points.min())}..{int(r.n_points.max())}")
        idle = [k for k, v in launches.items() if v == 0]
        if idle:
            raise AssertionError(f"kernels never launched by the driver: "
                                 f"{idle}")
        if not (werr <= WATER_TOL and excess <= 0.0):
            raise AssertionError(f"water balance error {werr} mm, excess "
                                 f"{excess} mm on melt records")
        if not res.gmb_results:
            raise AssertionError("no glacier mass-balance fit emitted")

        gp = driver.parse_global_param_file(gfile)
        domain = driver.load_domain(gp)
        names = [v for of in gp.outfiles for v in of.varnames]
        t0 = time.perf_counter()
        files = [os.path.join(gp.result_dir, f"fluxes_{la:.5f}_{lo:.5f}")
                 for la, lo in zip(domain.soil.lat, domain.soil.lng)]
        n_files = len([f for f in os.listdir(gp.result_dir)
                       if f.startswith("fluxes_")])
        if n_files != DRIVER_CELLS:
            raise AssertionError(f"{n_files} output files, not "
                                 f"{DRIVER_CELLS}")
        readback = max(binary_readback_error(f, res.outputs, ci, names)
                       for ci, f in enumerate(files))
        print(f"  {n_files} BINARY flux files read back in "
              f"{time.perf_counter() - t0:.3f} s: largest |file - packed "
              f"run| {readback}")
        if readback != 0.0:
            raise AssertionError(f"flux files differ from the run by "
                                 f"{readback}")

        # the same forcing in cell blocks, ending WARM_RECS records early
        ax = res.timeaxis
        n_first = DRIVER_DAYS - WARM_RECS
        last = n_first - 1
        gp_b = gp.replace(endyear=int(ax.year[last]),
                          endmonth=int(ax.month[last]),
                          endday=int(ax.day[last]),
                          state_name=os.path.join(tmp, "state_b"))
        first = {k: v[:n_first] for k, v in res.forcing.items()}
        t0 = time.perf_counter()
        res_b = driver.run_simulation(gp_b, domain=domain, forcing=first,
                                      chunk_recs=DRIVER_CHUNK,
                                      chunk_cells=DRIVER_CELL_CHUNK,
                                      write_output=False, progress=False)
        diff = max(float(np.abs(v - res.outputs[k][:n_first]).max())
                   for k, v in res_b.outputs.items())
        gmb_b = np.concatenate([r.b0 for r in res_b.gmb_results])
        gmb_diff = float(np.abs(gmb_b - res.gmb_results[0].b0).max())
        print(f"  blocks of {DRIVER_CELL_CHUNK} cells, {n_first} records: "
              f"{time.perf_counter() - t0:.3f} s, largest |difference| "
              f"from the single block {diff}, of the GMB b0 {gmb_diff}")
        if sorted(res_b.outputs) != sorted(res.outputs) or diff != 0.0 \
                or gmb_diff != 0.0:
            raise AssertionError("the cell-block run differs from the "
                                 "single-block run")

        # warm start from the blocks' ASCII state for the last records; the
        # July means the treeline needs come from the whole run's forcing
        from vic_tpu_torch.physics.hydrology_misc import july_avg_temperature
        july = july_avg_temperature(res.forcing["air_temp"], ax.month)
        warm_domain = dataclasses.replace(domain, soil=dataclasses.replace(
            domain.soil, avg_july_air_temp=july))
        gp_c = gp.replace(startyear=int(ax.year[n_first]),
                          startmonth=int(ax.month[n_first]),
                          startday=int(ax.day[n_first]),
                          july_tavg_supplied=True, init_state=True,
                          save_state=False)
        state_file = driver._state_path(gp_b, (int(ax.year[last]),
                                               int(ax.month[last]),
                                               int(ax.day[last])))
        res_c = driver.run_simulation(
            gp_c, domain=warm_domain,
            forcing={k: v[n_first:] for k, v in res.forcing.items()},
            init_state_path=state_file, write_output=False, progress=False)
        # the ASCII state file holds the blocks' final state: every field
        # the legacy format carries, on every HRU of the mosaic, exactly
        from vic_tpu_torch.io.state_io import load_state
        from vic_tpu_torch.state import initial_state
        at_restart = res_b.final_state
        mask = domain.hru.mask
        loaded = load_state(state_file, gp, initial_state(domain, gp, "cpu"),
                            domain)
        file_diff = max(float(np.abs(
            getattr(loaded, k).numpy()[mask].astype(np.float64)
            - getattr(at_restart, k).numpy()[mask]).max())
            for k in STATE_FILE_FIELDS)
        print(f"  ASCII state file read back: largest |difference| from the "
              f"run's state over {len(STATE_FILE_FIELDS)} fields {file_diff}")
        if file_diff != 0.0:
            raise AssertionError("the state file does not hold the state")
        # a warm start from it against the continuous run: lanes without
        # snow at the restart hold test_state_io's legacy resume tolerances;
        # lanes under snow diverge because the legacy formats do not carry
        # LongUnderOut or the snow coverage, which a warm start re-derives
        # (initialize_model_state.c:291-293, :327), as vic_tpu's does on CPU
        # (ROADMAP.md queue 3): printed, not held
        cont, warm = res.final_state, res_c.final_state
        snow = ((at_restart.swq + at_restart.snow_canopy).numpy() > 0.0) \
            & mask
        for name, (rtol, atol) in (("moist", WARM_MOIST_TOL),
                                   ("swq", WARM_SWQ_TOL)):
            a, b = getattr(cont, name).numpy(), getattr(warm, name).numpy()
            d = np.abs(b - a).reshape(snow.shape + (-1,))
            bound = (atol + rtol * np.abs(a)).reshape(d.shape)
            excess = float((d - bound)[~snow].max())
            print(f"  warm start, {WARM_RECS} records: {name} max |diff| "
                  f"{float(d[~snow].max()):.4g} on the lanes without snow "
                  f"at the restart (rtol {rtol}, atol {atol}: excess "
                  f"{excess:.4g}); {float(d[snow].max()):.4g} on the "
                  f"{int(snow.sum())} lanes under snow")
            if excess > 0:
                raise AssertionError(f"warm start {name} outside rtol={rtol}"
                                     f", atol={atol}")
        out_diff = max(float(np.abs(v - res.outputs[k][n_first:]).max())
                       for k, v in res_c.outputs.items())
        print(f"  warm start: largest |difference| of its outputs from the "
              f"continuous run {out_diff:.4g}")

        # the committed 16-cell driver fixture against vic_tpu's run of it
        ref = dict(np.load(FIXTURES / "driver_16x12.npz"))
        g16 = relocate_run(FIXTURES / "driver", os.path.join(tmp, "fixture"))
        got = run_arrays(driver.run_simulation(
            driver.parse_global_param_file(g16), progress=False))
        if sorted(got) != sorted(ref):
            raise AssertionError(f"driver fixture keys differ: "
                                 f"{sorted(set(got) ^ set(ref))}")
        failed = [k for k, a in ref.items() if not (
            np.allclose(got[k], a, rtol=REF_TOL, atol=REF_TOL)
            if a.dtype.kind == "f" else np.array_equal(got[k], a))]
        worst = max(float(np.abs(got[k] - a).max()) for k, a in ref.items()
                    if a.dtype.kind == "f")
        print(f"  driver fixture, 16 cells x 12 records: largest |difference"
              f"| from vic_tpu {worst:.4g}; outside rtol=atol={REF_TOL}: "
              f"{failed}")
        if failed:
            raise AssertionError(f"driver fixture outside {REF_TOL}: "
                                 f"{failed}")
    wall = time.perf_counter() - t_phase
    print(f"  phase 5 wall time {wall:.3f} s")
    return wall


def main():
    device = device_phase()
    build_phase()
    results = kernels_phase(device)
    ref_werr = {config: reference_phase(device, config)
                for config in CONFIG_NAMES}
    launches = {config: slice_phase(device, config, ref_werr[config])
                for config in CONFIG_NAMES}
    for nnode in NODE_COUNTS:
        launches[step_label("frozen_exp", nnode)] = slice_phase(
            device, "frozen_exp", nnode=nnode)
    driver_phase(device)
    # each row's count from the slice of the path its arguments came from
    for row, (name, config, nnode) in ROWS.items():
        results[row]["launches"] = launches[step_label(config, nnode)][name]
    print(json.dumps({"kernels": [results[row] for row in ROWS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
