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
   record, K6, K7 (and K4 again) in the frozen step's third, K8, K9's pass
   and its final update (and K2 and K5 again, with a blowing-snow flux) in
   the blowing_close step's fourth,
   K10-K13 and the lakes' water balance in the lakes step's second (open,
   partly and fully iced lakes side by side; the water balance also in the
   heavy step's fourth), K14 and again K7 (with DIST_PRCP's dry column), K4 (its dry
   column's call) and K6 (the lower probe of a CLOSE_ENERGY pass) in the
   heavy_nolakes step's fourth, K5 again with the dry column in the
   dist_prcp step's second, and every kernel of the heavy path (K12 with
   the blowing-snow flux over lake ice, K8 on the lake lanes) in the heavy
   step's seventh, where lakes carry snow on ice that blows (K12 and K8
   timed on those arguments too); K12 is the whole of lake_ice_melt (its
   Brent's flags equal the plain version's and its roots within the final
   bracket, every other field within testing.ice_melt_failures' rule of
   the plain version at the kernel's roots), also on the seeded lakes of
   testing.ice_melt_inputs, which reach every branch of it; then the forms
   frozen soil adds as its
   users set it up (the last rows of ROWS): K6 and K7 on 10 EXP_TRANS nodes
   in the frozen_exp step's third record, K5 with the fusion term in the
   frozen_quick step's second, and K6 at 3, 18 and 50 EXP_TRANS nodes in
   the third record of frozen_exp's configuration with its node count
   replaced, at 4,096 cells; then K2 and K5 in the spatial_snow step's
   second record, where packs cover part of their lanes (SPATIAL_SNOW's
   advected sensible heat in K2), and the three loops no step calls: K15
   mass_release on the light step's canopy snow and melt storage (and on
   seeded storage that releases), which must take its vector path, and
   again on its table path (the canopy snow a view offset by one float,
   the storage broadcast from [n_cell, 1]), K16 implicit_profile on K6's
   arguments of
   the frozen (5 nodes) and frozen_exp (10 EXP_TRANS nodes) steps and of
   frozen_exp's configuration at 3, 18 and 50 nodes, NOFLUX both ways, and
   K17 bisection on K2's and K1's arguments of the light step, 40 steps;
   K15's, K16's and K17's rows also print their kernel's device ms
   (device_ms: CUDA events behind a spin of the device, the median of
   five calls) beside the wrapper's ms.
   Each row's kernel is re-run on those arguments beside its
   plain PyTorch version on the card, compared, timed with CUDA events and
   given its bound (the least time the card could take for the same
   work); K1's, K2's, K3's, K5's and K14's rows also print their lanes'
   warp efficiency and waves (tools/profile_lane_brent.py's definitions),
   K10's and K11's their lakes, active lakes and the sweeps each of their
   mixes ran (counted on the plain version's columns, which also set the
   mix's share of the bound); K10, K11, the water balance and K16 print
   ptxas' registers, stack frame and spill stores of each instance, and
   fail on a spill, or on a stack frame in K16's instances that hold their
   nodes in registers (3, 5 and 10).
   K9's pass and final update, K13 and the water balance (every output,
   lake by lake and lane by lane) must equal their plain versions' (NaN
   where theirs are NaN), K9's largest change also as the host reads it
   from its pinned word, and each of their calls, and K12's, must be one
   device event (no fill, no copy: ONE_LAUNCH).
   K5's terms, K2's terms at its root and K1's terms, cold content and
   vapour loss at its accepted temperature are held against the plain
   ones at the kernel's own accepted temperature, K2's melt test and terms
   at 0 C and K1's melt test and melt against their plain versions', on
   every form and every lane (K1 on light's first record and again on
   blowing_close's, heavy_nolakes' and heavy's), each field at TERMS_RTOL
   and its unit's absolute limit (vic_tpu_torch.testing.terms_atol: water
   depths at TERMS_WATER_ATOL_M m, the residual at the root at
   TERMS_RESIDUAL_ATOL W/m^2); a lane whose melt test differs is printed
   and allowed only within MELT_TIE_ULPS of the tie. K4 is held against
   the plain runoff_step, every field of RunoffResult at RUNOFF_TOL, on
   light's, frozen's, heavy_nolakes' (both columns) and heavy's
   arguments. K6 and K7 are also held
   where a NaN reaches the node profile: frozen_exp's configuration with
   CONTINUEONERROR and NaN air temperature in NAN_CELLS cells, on the first
   record with the NaN (equal Brent trips, profile solves and sweeps; the
   other lanes within their bounds); K2, K5, K1 and K4 where it reaches
   their lanes: spatial_snow's step with NaN air in NAN_CELLS cells, record
   NAN_FROM (NaN at the plain version's elements, terms included).
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
   ops.tridiag.thomas_solve and each *_plain) made to fail if it is
   handed a CUDA tensor during the run, and no plain evaluation of the
   snowpack balance (K2 returns its terms), the glacier balance (K1
   returns its terms), the lake ice balance (K12 computes lake_ice_melt),
   the infiltration curve (K4 computes runoff_step) or, on K5's paths, of
   the surface balance (K5 returns its terms) allowed; the lakes and heavy
   slices must launch K13 twice a record and the water balance and K12
   once, the CLOSE_ENERGY slices K9 once a pass and its
   final update once a record;
   frozen_exp also times its SPATIAL_FROST layer ice; then frozen_exp's
   configuration at 3, 18 and 50 nodes, 4,096 cells x 8 records, the same
   way. Each row's launches in the kernels line are its kernel's count in
   the slice of the configuration its arguments came from (0 for K15-K17,
   which no step calls). The spatial_snow slice prints the share of snow
   lanes with fractional coverage, then runs again with NaN air
   temperature in 64 cells from its fourth record: CONTINUEONERROR must
   freeze them there (OUT_CELL_VALID 0, the state after the third record)
   and leave every other cell equal to the first run. Then heavy (8,192
   cells) and blowing_close (32,768) with CONTINUEONERROR, with and without
   NaN air temperature in 64 cells from the fourth record
   (`nan_slice_phase`): K8 on the HRU lanes (and, on heavy, the lake
   lanes), K9 (pass and final update), K10-K13, the water balance and K14
   against their plain versions on the first
   NaN record's arguments, NaN at the same elements and the rest within
   each row's tolerance; the NaN cells read OUT_CELL_VALID 0, every record
   before the NaN equals the run without it, the NaN records run
   CLOSE_ENERGY's 25 passes, and the other cells (whose secant steps past
   convergence move them away from the run without the NaN, in vic_tpu
   too) hold a control run with the NaN in other cells at REF_TOL; on
   heavy their cold cells close their water balance.
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
   and the snow coverage); the same half again in one block with
   STATE_FORMAT NETCDF (the reference's NetCDF schema, or without libnetcdf
   the npz at the state path + ".npz"), its file read back and its warm
   start held the same way; where libnetcdf is found, the run's outputs
   written in SHARDS NetCDF shards and merged, equal to the single
   writer's file (else one line says why not); and the committed 16-cell
   driver fixture against vic_tpu's run of it
   (tests/fixtures/torch_port/driver_16x12.npz).
6. split: light and lakes, 32,768 cells x 8 records, and heavy, 8,192
   cells x 8 3-hourly records, through driver.run_simulation on one
   device and split over every CUDA device (on a one-card host the card
   twice: two cooperative grids of K6 and K7 side by side, each of half
   the co-resident blocks), the plain solvers guarded and each path
   kernel's counter (every device together) read around each run; heavy's
   CLOSE_ENERGY passes, node sweeps and the Brent around them voted over
   the shares (vic_tpu_torch/parallel/votes.py): its passes a record, K9's
   launches (every share took every pass) and K7's sweeps, each share's
   equal to the one-device run's; the split run's outputs and state held
   against the one-device run at tests/test_sharding_driver.py's gate
   (rtol = atol = 1e-5, 1e-3 on OUT_*_ERROR); cell-steps/s of each run;
   the card's name and power limit.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds.
"""
import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from vic_tpu_torch.constants import CLOSE_ENERGY_MAXITER
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.testing import (BRENT_TOL, TERMS_ATOL, TERMS_RESIDUAL_ATOL,
                                   TERMS_RTOL, TERMS_WATER_ATOL_M,
                                   frozen_run_failures,
                                   heavy_lake_run_failures,
                                   heavy_run_failures, lake_run_failures,
                                   terms_atol, thaw_edge_cells)

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
                      "runoff", "runoff_step_plain", "light"),
    "surface_brent": ("surface_brent.cu", "vic_tpu/physics/surface.py:438",
                      "surface", "surface_brent_plain", "light"),
    "node_sweep": ("node_sweep.cu", "vic_tpu/physics/frozen_soil.py:311",
                   "frozen_soil", "solve_t_profile_explicit_plain", "frozen"),
    "fd_surface_brent": ("fd_surface_brent.cu",
                         "vic_tpu/physics/surface.py:438", "surface",
                         "surface_root_plain", "frozen"),
    "blowing_snow": ("blowing_snow.cu",
                     "vic_tpu/physics/blowing_snow.py:171", "blowing_snow",
                     "calc_blowing_snow_plain", "blowing_close"),
    "canopy_air_step": ("canopy_air.cu", "vic_tpu/model.py:841",
                        "canopy_air", "canopy_air_step_plain",
                        "blowing_close"),
    # K9's final update at the settled temperature
    "canopy_air_final": ("canopy_air.cu", "vic_tpu/model.py:844",
                         "canopy_air", "canopy_air_final_plain",
                         "blowing_close"),
    # K10 and K11 hold ops/tridiag.py:16's Thomas solve and lake.py:443's
    # tracer_mixer inside
    "lake_open_water": ("lake_open_water.cu", "vic_tpu/physics/lake.py:584",
                        "lake", "lake_open_water_plain", "lakes"),
    "lake_under_ice": ("lake_under_ice.cu", "vic_tpu/physics/lake.py:1112",
                       "lake", "water_under_ice_plain", "lakes"),
    # the whole of lake_ice_melt, its Brent (:960) on csrc/lane_brent.cuh
    "lake_ice_melt": ("lake_ice_melt.cu", "vic_tpu/physics/lake.py:805",
                      "lake", "lake_ice_melt_plain", "lakes"),
    "lake_depth": ("lake_depth.cu", "vic_tpu/physics/lake.py:204", "lake",
                   "depth_from_volume_plain", "lakes"),
    # the per-HRU water balance after solve_lake, its depths on K13's
    # basin code (csrc/lake_basin.cuh)
    "lake_water_balance": ("lake_water_balance.cu",
                           "vic_tpu/physics/lake.py:1636", "lake",
                           "lake_water_balance_plain", "lakes"),
    "affine_surface_brent": ("affine_surface_brent.cu",
                             "vic_tpu/physics/surface.py:438", "surface",
                             "surface_root_plain", "heavy_nolakes"),
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
LAKE_KERNELS = ("lake_open_water", "lake_under_ice", "lake_ice_melt",
                "lake_depth", "lake_water_balance")
# the steps and records each lake kernel is also held on, besides its own
# configuration's and ALSO_ON's: the water balance on heavy's fourth
# record, where the lakes are open
LAKE_RECORDS = {"lake_water_balance": (("heavy", HEAVY_RECORD),)}
# the kernels also timed on the heavy step's arguments, and what they are
HEAVY_LAKE_TIMED = {"lake_ice_melt": "heavy, with the blowing-snow flux",
                    "blowing_snow": "heavy, lake lanes"}
SURFACE_KERNELS = ("surface_brent", "fd_surface_brent", "affine_surface_brent")
# the kernels on csrc/lane_brent.cuh's driver
LANE_BRENT_KERNELS = ("glacier_brent", "snowpack_brent", "canopy_brent",
                      "surface_brent", "affine_surface_brent")
# the kernels that also write their balance's terms (K2 at 0 C and at the
# root, K5 at the root, K1 its melt at 0 C and its terms at the accepted
# temperature), held against their plain versions' at testing.terms_atol
TERMS_KERNELS = ("glacier_brent", "snowpack_brent", "surface_brent")
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
                      "canopy_air_step", "canopy_air_final"),
    "lakes": ("glacier_brent", "snowpack_brent", "canopy_brent",
              "runoff_hourly", "surface_brent") + LAKE_KERNELS,
    "heavy_nolakes": ("glacier_brent", "snowpack_brent", "canopy_brent",
                      "runoff_hourly", "node_sweep", "fd_surface_brent",
                      "blowing_snow", "canopy_air_step", "canopy_air_final",
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
# the calls also captured, and held like the one of NTH: the heavy_nolakes
# step's first K4 call, the wet column's
ALSO_CALLS = {"heavy_nolakes": {"runoff_hourly": (0,)}}
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
ROWS.update({f"implicit_profile/exp_trans_{n}": ("implicit_profile",
                                                 "frozen_exp", n)
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
# configuration's: the frozen step's K4, the blowing_close step's K1, K2
# and K5 (CLOSE_ENERGY's first pass; a blowing-snow flux in K2's and K5's
# residuals), the dist_prcp step's K5
# (DIST_PRCP's dry column), the heavy_nolakes step's every kernel of its
# path (K4's dry column, K6's lower probe, K7 with the dry column), and the
# heavy step's every kernel of its path (K8's call on the lake lanes, K12
# with the blowing-snow flux over lake ice; K5 is not on it)
ALSO_ON = {
    "glacier_brent": ("blowing_close", "heavy_nolakes", "heavy"),
    "snowpack_brent": ("blowing_close", "heavy_nolakes", "heavy"),
    "canopy_brent": ("heavy_nolakes", "heavy"),
    "runoff_hourly": ("frozen", "heavy_nolakes", "heavy"),
    "surface_brent": ("blowing_close", "dist_prcp"),
    "node_sweep": ("heavy_nolakes", "heavy"),
    "fd_surface_brent": ("heavy_nolakes", "heavy"),
    "blowing_snow": ("heavy_nolakes", "heavy"),
    "canopy_air_step": ("heavy_nolakes", "heavy"),
    "canopy_air_final": ("heavy_nolakes", "heavy"),
    "affine_surface_brent": ("heavy",),
    "lake_open_water": ("heavy",),
    "lake_under_ice": ("heavy",),
    "lake_ice_melt": ("heavy",),
    "lake_depth": ("heavy",),
    "lake_water_balance": ("heavy",),
}
# Brent stops a lane anywhere inside its final bracket, |c - b| <= 2*tol_i
# with tol_i = 2*FLT_EPSILON*|b| + 1e-4 C, so two runs whose residuals differ
# by ulps may stop up to one bracket width apart: roots must agree within
# 2*tol_i of the kernel's root (BRENT_TOL, from vic_tpu_torch.testing, is
# the 1e-4 C).
FLAG_DISAGREE_FRAC = 1e-4  # of the active lanes
RUNOFF_TOL = 1e-5          # rtol = atol
# ulps of the larger of |rest| and refreeze_energy within which K2's melt
# test at 0 C (rest > -refreeze_energy) may fall the other way in the
# kernel: the test is formed on the card in CUDA, not in PyTorch
MELT_TIE_ULPS = 4
SWEEP_TOL = 1e-4           # C, node temperatures of K6 vs its plain version
BLOWING_RTOL = 1e-4        # K8 vs its plain version
BLOWING_ATOL = 1e-9        # kg/m^2/s, far below the -5e-5 floor
# K9 (both modes), K13 and the water balance repeat their plain versions'
# operations: their outputs must equal the plain versions' (NaN where they
# are NaN)
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
RUNOFF_ARNO_OPS = 30              # the infiltration curve, 3 powf
SWEEP_OPS_PER_NODE = 20           # t_lin and the bookkeeping
# floats a sweep streams per lane and node: five node properties and the
# iterate read and written (sweep_bytes)
SWEEP_FLOATS_PER_NODE = 7
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
# sub_with_height of ~55 at hsalt/2 and 16 quadrature nodes of ~73 (an exp,
# a sub_with_height without its fluct_v, the transport integrand sharing
# its powf), ~170 of saltation terms, bounds and probability; ~60 once per
# lane. A libm call counts as one operation here: an accurate powf is ~94
# SASS instructions, a logf 24 (tools/profile_blowing_snow.py), so the
# bound understates a lane's instructions several times (PERF.md).
BLOWING_OPS_PER_LANE = 10 * (26 * 9 + 24 * 4 + 55 + 16 * 73 + 170) + 60
CANOPY_AIR_OPS_PER_LANE = 40      # the closed form and the secant guards
CANOPY_AIR_FINAL_OPS_PER_LANE = 15   # the closed form and its sensible heat
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
# K12: the ice residual and a Brent iteration, and per lake the rest of
# lake_ice_melt: the prologue (the fresh snow's distribution, icerad with
# its six exp, ~90), the balance at 0 C and at the accepted temperature
# (~60 each) and the state update (~80); a depth solve (K13, and the
# water balance's solves of a volume that changed): the basin's 20 layer
# volumes (~4 operations each) and their 20 left-to-right suffix sums (210
# additions) once a lake, then 30 bisection steps of one trapezoid's area
# (~8) and partial volume (~6) and the step (~4), and the two searches of
# the levels while the bracket narrows to one trapezoid (5, 4, 3, 2 and 2
# comparisons each, then none)
RESIDUAL_OPS["lake_ice_melt"] = 60 + 30
ICE_MELT_LAKE_OPS = 90 + 2 * 60 + 80
RESIDUAL_OPS["affine_surface_brent"] = AFFINE_RESIDUAL_OPS
LAKE_BASIN_OPS = 20 * 4 + 210
LAKE_DEPTH_OPS = 2 * (5 + 4 + 3 + 2 + 2) + 30 * (8 + 6 + 4)
# the water balance per lake (~30) and per HRU lane (~80 on a lane of the
# mask, two powf and a sqrtf among them; ~10 on another), besides the depth
# solves its data needs (lake_balance_solves)
LAKE_BALANCE_OPS = 30
LAKE_BALANCE_LANE_OPS = (80, 10)
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


_STARTED = time.perf_counter()


def phase(title):
    """Prints a phase's title and the seconds since the script started."""
    print(f"== {title} (at {time.perf_counter() - _STARTED:.1f} s)",
          flush=True)


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


def tool(name):
    """The module tools/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lane_tools():
    """tools/profile_lane_brent.py, whose definitions of a lane batch's
    warp efficiency and waves the K3 and K14 rows print."""
    return tool("profile_lane_brent")


def lake_tools():
    """tools/profile_lake_close.py, whose count of K10's and K11's mixes
    (column_mixes) the lake rows print and charge."""
    return tool("profile_lake_close")


def build_phase():
    """Returns ptxas' {kernel: (registers, spill store bytes, stack frame
    bytes)}."""
    phase("1 build")
    from vic_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build(extra_flags=("-Xptxas", "-v"))
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    build.load()
    return lane_tools().ptxas_registers(log)


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
                        nth=None, build=None, cells=None, also=None):
    """Run `config` at its slice's size (or `cells`; build(n_cell, n_rec,
    device) in place of its builder, if given) up to its record `record`
    with each binding in `names` wrapped in that record's step; returns
    {kernel: (args, kwargs)} of its first call there, or of its call number
    nth[kernel] (from 0), and of its calls number k in also[kernel] under
    "kernel@k", and counts each kernel's calls in that step into the dict
    `calls`, if given. A name that is not a kernel binding is a function of
    vic_tpu_torch.model; of those in MODEL_RESULTS the result is taken in
    place of the arguments."""
    from vic_tpu_torch import kernels, model
    from vic_tpu_torch.model import make_step

    captured = {}
    home = {name: kernels if hasattr(kernels, name) else model
            for name in names}
    originals = {name: getattr(home[name], name) for name in names}
    calls = {} if calls is None else calls
    nth, also = nth or {}, also or {}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            k = calls.get(name, 0)
            first = k == nth.get(name, 0)
            calls[name] = k + 1
            if first and name not in MODEL_RESULTS:
                captured[name] = (clone_args(args), clone_args(kwargs))
            elif k in also.get(name, ()):
                captured[f"{name}@{k}"] = (clone_args(args),
                                           clone_args(kwargs))
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


def compare_blowing(kern, plain, snowdepth, label, exercised=True):
    """K8 vs its plain version at rtol BLOWING_RTOL, atol BLOWING_ATOL; the
    path counts as exercised only if some snow-covered lane blows (unless
    not `exercised`: the NaN phases' lake lanes need not carry snow)."""
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
    if exercised and not blowing:
        raise AssertionError("blowing_snow: no snow-covered lane blows; the "
                             "path was not exercised")
    return worst


def unequal(a, b):
    """The elements where a and b differ (NaN equal to NaN)."""
    if a.dtype == torch.bool:
        return a != b
    return (a != b) & ~(torch.isnan(a) & torch.isnan(b))


def largest_difference(a, b):
    if a.dtype == torch.bool:
        return float((a != b).sum())
    d = (a - b).abs()
    d = torch.where(torch.isnan(d), 0.0, d)
    return float(d.max()) if d.numel() else 0.0


def compare_canopy_air(kern, plain, label):
    """K9 vs its plain version: tc_next, g and the batch's largest change
    equal, so the same stop decision; the change as the host reads it after
    the launch (kernels.canopy_air_largest_change) equal too."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.model import OVER_TOL_F32
    diffs = [largest_difference(a, b) for a, b in zip(kern, plain)]
    differ = [int(unequal(a, b).sum()) for a, b in zip(kern, plain)]
    host = kernels.canopy_air_largest_change(kern[2])
    stop_k = host <= OVER_TOL_F32
    stop_p = float(plain[2]) <= OVER_TOL_F32
    print(f"  canopy_air_step ({label}): lanes differing tc_next "
          f"{differ[0]}, g {differ[1]}; max |diff| tc_next {diffs[0]:.3e} "
          f"C, g {diffs[1]:.3e} C, batch max change {float(kern[2]):.6g} "
          f"(host word {host:.6g}) / {float(plain[2]):.6g} C (kernel/plain),"
          f" stop {stop_k}/{stop_p}")
    same_max = bool(not unequal(kern[2], plain[2])) and (
        np.float32(host) == np.float32(float(plain[2]))
        or (np.isnan(host) and np.isnan(float(plain[2]))))
    if sum(differ) or not same_max or stop_k != stop_p:
        raise AssertionError("canopy_air_step differs from its plain "
                             "version")
    return max(diffs)


def compare_canopy_final(kern, plain, label):
    """K9's final update vs its plain version: Tcanopy, the fallback flag
    and the atmospheric sensible heat equal."""
    names = ("tcanopy", "fbflag", "sensible")
    differ = [int(unequal(a, b).sum()) for a, b in zip(kern, plain)]
    diffs = [largest_difference(a, b) for a, b in zip(kern, plain)]
    print(f"  canopy_air_final ({label}): lanes {kern[0].numel()}, fallbacks "
          f"{int(kern[1].sum())}; lanes differing "
          + ", ".join(f"{n} {d}" for n, d in zip(names, differ))
          + f"; max |diff| Tcanopy {diffs[0]:.3e} C, sensible "
          f"{diffs[2]:.3e} W/m^2")
    if sum(differ):
        raise AssertionError("canopy_air_final differs from its plain "
                             "version")
    return max(diffs[0], diffs[2])


def compare_runoff(kern, plain, label):
    """K4's RunoffResult against the plain runoff_step's, every field at
    rtol = atol = RUNOFF_TOL, NaN at the same elements; returns the
    largest difference."""
    worst = 0.0
    for part, a, b in zip(kern._fields, kern, plain):
        na, nb = torch.isnan(a), torch.isnan(b)
        diff = torch.where(na | nb, 0.0, (a - b).abs())
        worst = max(worst, float(diff.max()))
        bad = int((diff > RUNOFF_TOL + RUNOFF_TOL * b.abs()).sum())
        nan_dis = int((na != nb).sum())
        print(f"  runoff_hourly ({label}) {part}: max |diff| "
              f"{float(diff.max()):.3e}, outside rtol=atol={RUNOFF_TOL}: "
              f"{bad}, NaN elements {int(nb.sum())} ({nan_dis} apart)")
        if bad or nan_dis:
            raise AssertionError(f"runoff_hourly ({label}) {part} outside "
                                 "tolerance")
    return worst


def compare_sweep(kern, plain, label):
    """K6 vs its plain version: node temperatures within SWEEP_TOL where
    the plain version's are not NaN and NaN where they are, equal per-node
    fallback counts and an equal batch-wide sweep count."""
    nan_k, nan_p = torch.isnan(kern.temp), torch.isnan(plain.temp)
    nan_dis = int((nan_k != nan_p).sum())
    diff = float(torch.where(nan_p, 0.0, kern.temp - plain.temp).abs().max())
    fb_dis = int((kern.fbcount != plain.fbcount).sum())
    sweeps_k, sweeps_p = int(kern.iterations), int(plain.iterations)
    print(f"  node_sweep ({label}): lanes {kern.temp[..., 0].numel()}, sweeps "
          f"{sweeps_k}/{sweeps_p} (kernel/plain), max |T diff| {diff:.3e} C, "
          f"fallback-count disagreements {fb_dis}, lanes with a fallback "
          f"{int((plain.fbcount > 0).any(-1).sum())}, NaN nodes "
          f"{int(nan_p.sum())} (disagreements {nan_dis})")
    if sweeps_k != sweeps_p:
        raise AssertionError(f"node_sweep: {sweeps_k} sweeps, plain "
                             f"{sweeps_p}")
    if fb_dis or nan_dis or not diff <= SWEEP_TOL:
        raise AssertionError(f"node_sweep: max |T diff| {diff} C, "
                             f"{fb_dis} fallback-count and {nan_dis} NaN "
                             "disagreements")
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


def compare_lake_open_water(kwargs, results=None):
    """K10 vs its plain version (or `results`, their outputs on kwargs):
    (the kernel's WaterEBResult, its mixed column, the largest
    difference)."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_open_water_plain
    (kern, t_open), (plain, t_open_p) = results or (
        kernels.lake_open_water(**kwargs), lake_open_water_plain(**kwargs))
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


def compare_lake_under_ice(kwargs, results=None):
    """K11 vs its plain version (or `results`, their outputs on kwargs):
    (the kernel's UnderIceResult, the largest difference)."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import water_under_ice_plain
    kern, plain = results or (kernels.lake_under_ice(**kwargs),
                              water_under_ice_plain(**kwargs))
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


def lake_depth_plain(z, basin, maxdepth, volume):
    """K13's plain version on the kernel's arguments (it takes the lake
    parameters, the kernel their profiles)."""
    from vic_tpu_torch.physics.lake import depth_from_volume_plain
    return depth_from_volume_plain(
        SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth), volume)


def compare_lake_depth(args, results=None):
    """K13 vs its plain version (or `results`, their outputs on args):
    the depths equal on every lake (csrc/lake_basin.cuh makes the plain
    version's decisions)."""
    from vic_tpu_torch import kernels
    kern, plain = results or (kernels.lake_depth(*args),
                              lake_depth_plain(*args))
    torch.cuda.synchronize()
    differ = int(unequal(kern, plain).sum())
    print(f"  lake_depth: lakes {kern.numel()}, equal depths "
          f"{kern.numel() - differ}, max |diff| "
          f"{largest_difference(kern, plain):.3e} m")
    if differ:
        raise AssertionError(f"lake_depth: {differ} depths differ from the "
                             "plain version's")
    return kern, largest_difference(kern, plain)


def compare_lake_balance(args, kwargs, label, results=None):
    """The water balance kernel vs lake_water_balance_plain (or `results`,
    their outputs on these arguments): every output equal on every lake
    and lane (NaN where the plain version's is NaN); prints the lakes and
    lanes that differ and each output's largest difference. Returns (the
    kernel's WaterBalance, the largest difference)."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_water_balance_plain
    kern, plain = results or (kernels.lake_water_balance(*args, **kwargs),
                              lake_water_balance_plain(*args, **kwargs))
    torch.cuda.synchronize()
    lane_mask = kwargs["lane_mask"]
    live = args[0].has_lake & kwargs["active"]
    valid = live[:, None] & lane_mask
    lakes = torch.zeros_like(live)
    lanes = torch.zeros_like(lane_mask)
    worst, line = 0.0, []
    for field in kern._fields:
        a, b = getattr(kern, field), getattr(plain, field)
        if a is None and b is None:
            continue
        bad = unequal(a, b)
        d = largest_difference(a, b)
        worst = max(worst, d)
        line.append(f"{field} {d:.3e}")
        if bad.dim() == 1:
            lakes |= bad
        else:
            lanes |= bad if bad.dim() == 2 else bad.any(-1)
    lakes |= lanes.any(-1)
    nan = int(torch.isnan(plain.volume).sum())
    print(f"  lake_water_balance ({label}): lakes {live.numel()}, live "
          f"{int(live.sum())}, lanes of the mask {int(valid.sum())} of "
          f"{valid.numel()}, NaN volumes {nan}; lakes differing "
          f"{int(lakes.sum())}, lanes differing {int(lanes.sum())}; largest "
          "difference " + ", ".join(line))
    if bool(lakes.any()):
        where = torch.nonzero(lakes)[:5, 0].tolist()
        raise AssertionError(f"lake_water_balance ({label}): differs from "
                             f"its plain version at lakes {where}")
    return kern, worst


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
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=lo.device)
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
                       kern.iterations, *written_terms(name, kern))
    act = lane_tools().solved_lanes(name, active, kwargs, kern)
    evals = torch.where(kern.bracketed, 2 + kern.iterations,
                        torch.where(act, 2 + 2 * max_tries, 0))
    # K5's terms at the root and K1's and K2's at 0 C and at the accepted
    # temperature: one residual evaluation each on every lane
    evals_all = float(evals.sum()) + kern.root.numel() * {
        "surface_brent": 1, "snowpack_brent": 2,
        "glacier_brent": 2}.get(name, 0)
    return bytes_in + bytes_out, evals_all * ops_per_eval


def written_terms(name, kern):
    """The tensors K2 (the terms at 0 C and at the root, the melt test), K1
    (the terms at the accepted temperature, what glacier_ablation forms
    from them, the melt test) or K5 (the terms at the root but
    net_short_bare, its input) write besides the Brent's outputs."""
    if name == "snowpack_brent":
        return [*kern.terms0, *kern.terms_b, kern.melt_cond]
    if name == "glacier_brent":
        return list(kern[4:-1]) + list(kern.terms)
    if name == "surface_brent":
        return [t for f, t in kern.terms._asdict().items()
                if t is not None and f != "net_short_bare"]
    return []


def fd_brent_work(kwargs, kern):
    """Bytes in and out of one K7 call and its FP32 operations: its profile
    solves' sweeps, each streaming what sweep_bytes counts, and on every
    lane the residual of each of its `solves` evaluations (as the
    batch-wide sweep count of the reference makes every lane's profile
    depend on every candidate) reading the residual's inputs, the outputs
    once."""
    from vic_tpu_torch.kernels import FD_SURFACE_INPUTS, surface_inputs
    kw = kwargs["eb_kwargs"]
    solve = kw["fd_solve"]
    inputs = list(surface_inputs(kw).values()) + [
        kw[k] for k in FD_SURFACE_INPUTS + ("fs_active",) if k in kw]
    solves, sweeps = int(kern.solves), int(kern.sweeps)
    bytes_moved = (swept_bytes(solve, sweeps)
                   + streamed(nbytes(*inputs), solves)
                   + nbytes(kern.root, kern.converged, kern.bracketed))
    ops = FD_RESIDUAL_OPS + (DRY_ET_OPS if kw.get("dist_dry") is not None
                             else 0)
    return bytes_moved, (solves * kern.root.numel() * ops
                         + sweeps * sweep_ops(solve.t0, solve.fs_active,
                                              solve.nlayer))


def blowing_work(kwargs, result):
    from vic_tpu_torch.kernels import BLOWING_INPUTS, BLOWING_MASKS
    inputs = [kwargs[k] for k in BLOWING_INPUTS + BLOWING_MASKS]
    snow = (kwargs["snowdepth"] > 0.0).expand(result[0].shape)
    return (nbytes(*inputs, *result),
            float(snow.sum()) * BLOWING_OPS_PER_LANE)


def canopy_air_work(kwargs, result, per_lane=CANOPY_AIR_OPS_PER_LANE):
    return (nbytes(*kwargs.values(), *result),
            result[0].numel() * per_lane)


def runoff_work(args, result):
    """Bytes in and out of one K4 call (its inputs read once, RunoffResult
    written once) and its FP32 operations: the hourly trips and the two
    evaluations of the infiltration curve."""
    moist = result.moist
    dt_hours = args[-1]
    lanes, nl = moist[..., 0].numel(), moist.shape[-1]
    return (nbytes(*args[:-1], *result),
            lanes * (dt_hours * nl * RUNOFF_OPS_PER_LAYER_HOUR
                     + 2 * RUNOFF_ARNO_OPS))


def sweep_bytes(t0, geom, exp_trans):
    """Bytes one sweep of the node profile streams, whatever implements it:
    each lane's five node properties (t0, kappa, cs, moisture, ice) and the
    iterate, read and written, at every node; the cell geometry the sweep
    reads (E, the solver's three unfrozen-water parameters and the spacing's
    terms) once a cell."""
    read = ("e_coef", "solver_max_moist", "solver_bubble", "solver_expt") + (
        ("zp1", "exp_a", "bexp") if exp_trans else ("alpha", "beta", "gamma"))
    return (t0.numel() * SWEEP_FLOATS_PER_NODE * 4
            + nbytes(*(getattr(geom, k) for k in read)))


def streamed(per_pass, passes):
    """Bytes that `passes` passes over the same `per_pass` bytes must move
    from device memory: all of them once, then on each further pass only
    what the card's L2 cache cannot hold."""
    l2 = torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size
    return per_pass + max(0, per_pass - l2) * max(0, passes - 1)


def swept_bytes(solve, sweeps):
    """Bytes `sweeps` sweeps of the profile of `solve` (a NodeSolve, or
    anything with t0, geom and exp_trans) move from device memory: the
    streamed bytes of `sweeps` passes of sweep_bytes."""
    return streamed(sweep_bytes(solve.t0, solve.geom, solve.exp_trans),
                    sweeps)


def sweep_ops(t0, fs_active, nlayer):
    """FP32 operations of one sweep: every interior node, plus the residual
    evaluations of the nodes that start below 0 C where frozen soil is
    active (2 for nodes above the soil-layer count, 2 + 16 for deeper nodes;
    expansions not counted)."""
    nn = t0.shape[-1]
    cold = (t0[..., 1:nn - 1] < 0.0) & fs_active[:, None, None]
    evals = torch.where(torch.arange(1, nn - 1, device=t0.device) < nlayer,
                        2, 18)
    return (t0[..., 0].numel() * (nn - 2) * SWEEP_OPS_PER_NODE
            + float((cold * evals).sum()) * NODE_RESIDUAL_OPS)


def sweep_work(args, kwargs, kern):
    """Bytes in and out of one K6 call (its sweeps' streams, the boundary
    condition, the outputs) and its FP32 operations."""
    t0, surf, kappa, cs, moist, ice0, geom, fs_active = args
    sweeps = int(kern.iterations)
    solve = SimpleNamespace(t0=t0, geom=geom, exp_trans=kwargs["exp_trans"])
    bytes_moved = (swept_bytes(solve, sweeps)
                   + nbytes(surf, fs_active, kern.temp, kern.fbcount))
    return bytes_moved, sweeps * sweep_ops(t0, fs_active, kwargs["nlayer"])


def lake_column_work(name, kwargs, kern, outputs, setup_ops, iter_ops):
    """Bytes in and out of one K10/K11 call and its FP32 operations: each
    active lake's set-up and the iterations it ran, and each of its mixes'
    passes over the lake's active layer pairs for the sweeps the mix runs
    on this call's data, stopped after its first sweep that mixes no pair
    (tools/profile_lake_close.py column_mixes, counted on the plain
    version's columns: K10 mixes every lake once, K11 in each iteration a
    lake ran). Prints the lakes, the active ones and the sweeps each mix
    ran."""
    from vic_tpu_torch.physics import lake
    grid, active = kwargs["grid"], kwargs["active"]
    inputs = [v for v in kwargs.values() if isinstance(v, torch.Tensor)]
    bytes_moved = nbytes(*inputs, *grid, *outputs)
    lakes, _, run = lake_tools().column_mixes(lake, name, kwargs,
                                              kern.iterations)
    its = kern.iterations.double()
    pairs = (grid.numnod - 1).clamp(min=0).double()
    ops = float((active.double() * (setup_ops + its * iter_ops)).sum()) \
        + float((run.double() * pairs[lakes]).sum()) * LAKE_MIX_OPS_PER_PAIR
    counts = torch.bincount(run, minlength=lake.MIX_SWEEPS + 1).tolist()
    mean = float(run.double().mean()) if run.numel() else 0.0
    print(f"  {name}: lakes {active.numel()}, active {int(active.sum())}, "
          f"mixes {run.numel()}, sweeps a mix ran: mean {mean:.4f}, mixes "
          f"by sweeps 0..{lake.MIX_SWEEPS} {counts}")
    return bytes_moved, ops


def lake_depth_work(args, kern):
    return nbytes(*args, kern), kern.numel() * (LAKE_BASIN_OPS
                                                + LAKE_DEPTH_OPS)


def lake_balance_solves(args, kwargs):
    """The depth solves the water balance needs on these arguments: per
    lake, the liquid volumes it asks the depth of, in its order (on every
    lane the new extent's; on a lane of the mask also the baseflow's area,
    the weir's head, the dry test and the final fraction; then the final
    depth), counted where a volume above 0 (or NaN) differs from the one
    asked before it. The volumes are the plain version's on the same
    arguments (its depths by K13 on the card, equal to the plain
    bisection's, as in compare_lake_balance)."""
    from vic_tpu_torch.physics import lake as tl
    asked = []
    dispatch = tl.depth_from_volume

    def record(lp, volume):
        asked.append(volume)
        return dispatch(lp, volume)

    tl.depth_from_volume = record
    try:
        tl.lake_water_balance_plain(*args, **kwargs)
    finally:
        tl.depth_from_volume = dispatch
    lp = args[0]
    valid = (lp.has_lake & kwargs["active"])[:, None] & kwargs["lane_mask"]
    n_lane = valid.shape[1]
    if len(asked) != 5 * n_lane + 1:
        raise AssertionError(f"lake_water_balance_plain asked {len(asked)} "
                             f"depths, not 5 a lane and 1 ({n_lane} lanes)")
    every = torch.ones_like(valid[:, 0])
    order = [(asked[5 * h + k], every if k == 0 else valid[:, h])
             for h in range(n_lane) for k in range(5)] + [(asked[-1], every)]
    prev = torch.full_like(asked[0], -1.0)
    solves = torch.zeros_like(asked[0], dtype=torch.int64)
    for v, take in order:
        solves += (take & ~(v == prev) & ~(v <= 0.0)).long()
        prev = torch.where(take, v, prev)
    return int(solves.sum())


def lake_balance_work(args, kwargs, kern):
    """Bytes of the water balance (each input a lake reads, its lanes' and
    layers' included, and its outputs) and its FP32 operations: per lake
    the basin's tables and the balance, per lane its own, and the depth
    solves this run's data needs (lake_balance_solves)."""
    from vic_tpu_torch.kernels import LAKE_BALANCE_INPUTS
    lp, st, res = args
    sources = {"lp": lp, "st": st, "s1": res.state, "res": res,
               "kw": kwargs}
    n, n_lane = kwargs["lane_mask"].shape
    read = 0
    for key, where, axes in LAKE_BALANCE_INPUTS:
        x = (sources[where][key] if where == "kw"
             else getattr(sources[where], key))
        if x is not None:
            shape = {"c": (n,), "b": (n, 21), "l": (n, n_lane),
                     "ll": (n, n_lane, x.shape[-1] if x.dim() else 1)}[axes]
            read += 4 * int(np.prod(shape))
    read += n * 2 + kwargs["lane_mask"].numel()
    valid = int(((lp.has_lake & kwargs["active"])[:, None]
                 & kwargs["lane_mask"]).sum())
    other = n * n_lane - valid
    solves = lake_balance_solves(args, kwargs)
    print(f"  lake_water_balance: {solves} depth solves of a changed volume "
          f"({solves / n:.2f} a lake; {n + 5 * valid + other} asked)")
    ops = (n * (LAKE_BASIN_OPS + LAKE_BALANCE_OPS)
           + valid * LAKE_BALANCE_LANE_OPS[0]
           + other * LAKE_BALANCE_LANE_OPS[1] + solves * LAKE_DEPTH_OPS)
    return read + nbytes(*(x for x in kern if x is not None)), ops


def check_lake_kernel(name, args, kwargs, calls, label="lakes",
                      record=LAKES_RECORD, results=None):
    """K10-K13 and the water balance on the arguments of their first call
    in the `label` step's record `record` (`calls` calls in that record)
    against their plain versions (or `results`, their outputs there);
    returns (largest difference, (bytes, operations) of the call). On the
    heavy step K12 must see the blowing-snow flux over lake ice on some
    bracketed lake."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_ice_melt_plain
    print(f"  {name}: {calls} calls in the {label} step's record {record}")
    if name == "lake_open_water":
        kern, t_open, err = compare_lake_open_water(kwargs, results)
        return err, lake_column_work(name, kwargs, kern,
                                     list(kern) + [t_open],
                                     LAKE_OPEN_SETUP_OPS, LAKE_OPEN_ITER_OPS)
    if name == "lake_under_ice":
        kern, err = compare_lake_under_ice(kwargs, results)
        return err, lake_column_work(name, kwargs, kern, list(kern),
                                     LAKE_ICE_SETUP_OPS, LAKE_ICE_ITER_OPS)
    if name == "lake_depth":
        kern, err = compare_lake_depth(args, results)
        return err, lake_depth_work(args, kern)
    if name == "lake_water_balance":
        kern, err = compare_lake_balance(args, kwargs, f"{label}, record "
                                         f"{record}", results)
        return err, lake_balance_work(args, kwargs, kern)
    kern, plain = results or (kernels.lake_ice_melt(*args, **kwargs),
                              lake_ice_melt_plain(*args, **kwargs))
    err = compare_ice_melt(f"{name} ({label})", kwargs, kern, plain)
    if not int(kern.solve.bracketed.sum()):
        raise AssertionError("lake_ice_melt: no lake bracketed; the path "
                             "was not exercised")
    if label == "heavy":
        blown = kwargs["blowing_flux"].expand(kern.swq.shape) != 0.0
        brackets = kern.solve.bracketed
        print(f"  lake_ice_melt (heavy): {int(blown.sum())} lakes with a "
              f"blowing-snow flux, {int((blown & brackets).sum())} of them "
              "bracketed")
        if not bool((blown & brackets).any()):
            raise AssertionError("lake_ice_melt: no bracketed lake with a "
                                 "blowing-snow flux; the path was not "
                                 "exercised")
    return err, ice_melt_work(kwargs, kern)


def seeded_ice_melt(device, n_lake=SMOKE_CELLS):
    """K12 against lake_ice_melt_plain on testing.ice_melt_inputs' seeded
    lakes (n_lake of them), whose groups reach every branch of
    lake_ice_melt: the surface melting into the pack, the surface layer,
    the ice and through all of it, a thin pack, the Brent, the fallback,
    NaN air; returns the largest root difference."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.lake import lake_ice_melt_plain
    from vic_tpu_torch.testing import ice_melt_inputs
    kw, kinds = ice_melt_inputs(n_lake)
    kw = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
          else v for k, v in kw.items()}
    kern = kernels.lake_ice_melt(**kw)
    err = compare_ice_melt("lake_ice_melt (seeded lakes, every branch)", kw,
                           kern, lake_ice_melt_plain(**kw))
    brent = torch.from_numpy(kinds == "brent").to(device)
    if not bool(kern.solve.converged[brent].all()):
        raise AssertionError("lake_ice_melt: a seeded Brent lake did not "
                             "converge")
    return err


def compare_ice_melt(label, kwargs, kern, plain):
    """K12 against lake_ice_melt_plain (testing.ice_melt_failures: the
    Brent's flags equal, its roots within the final bracket, every other
    field within its rule of the plain version at the kernel's roots, NaN
    at the same elements); raises outside it, returns the largest root
    difference where both converged."""
    from vic_tpu_torch.testing import ice_melt_at_roots, ice_melt_failures
    at_roots = ice_melt_at_roots(kwargs, kern.solve)
    torch.cuda.synchronize()
    err = compare_brent(f"{label} Brent", kern.solve, plain.solve)
    bad = ice_melt_failures(kern, plain, at_roots)
    nan = int(torch.isnan(kern.qnet).sum())
    print(f"  {label}: {kern.swq.numel()} lakes, {nan} with a NaN balance, "
          f"fallback on {int(kern.surf_temp_fbflag.sum())}; every field "
          f"within testing.ice_melt_failures' rule of the plain version at "
          f"the kernel's roots: {'yes' if not bad else bad}")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    return err


def ice_melt_work(kwargs, kern):
    """Bytes in and out of one K12 call and its FP32 operations: its 22
    inputs and mask, the Brent's four outputs, 20 floats and the fallback
    flag a lake; per lake ICE_MELT_LAKE_OPS, and per residual evaluation
    that these inputs need (2 endpoints and one an iteration on bracketed
    lakes, 2 + 2*MAXTRIES on solved lakes that do not bracket)
    RESIDUAL_OPS["lake_ice_melt"]."""
    from vic_tpu_torch.kernels import ICE_MELT_INPUTS
    from vic_tpu_torch.ops.rootfind import MAXTRIES
    s = kern.solve
    inputs = [kwargs[k] for k in ICE_MELT_INPUTS
              if isinstance(kwargs.get(k), torch.Tensor)]
    if isinstance(kwargs.get("active"), torch.Tensor):
        inputs.append(kwargs["active"])
    outputs = [s.root, s.converged, s.bracketed, s.iterations,
               kern.surf_temp_fbflag, kern.sw_under_ice, kern.qnet,
               *kern.terms[1:]] + [getattr(kern, k) for k in (
                   "swq", "surf_temp", "pack_temp", "surf_water",
                   "pack_water", "melt_m", "ice_melt_m", "lake_ice_m",
                   "vapor_flux", "cold_content")]
    # a solved lake that does not bracket tried every expansion; one taken
    # out of the solve (melting, thin, masked) ran none. Not melting and
    # not converged: the fallback flag; thin: lake_ice_melt's surface layer
    # after the fresh snow
    from vic_tpu_torch import constants as c
    msw = c.MAX_SURFACE_SWE
    snow_ice = kwargs["swq"] - kwargs["pack_water"] - kwargs["surf_water"]
    surface = torch.clamp(snow_ice + kwargs["lake_ice_m"], max=msw)
    snowfall = kwargs["snowfall_mm"] / 1000.0
    surface = torch.where(snowfall > msw - surface, msw, surface + snowfall)
    active = kwargs.get("active")
    solved = (kern.surf_temp_fbflag & ~s.bracketed
              & ~(surface <= c.MIN_SWQ_EB_THRES)
              & (True if active is None else active))
    evals = torch.where(s.bracketed, 2 + s.iterations, 0)
    evals = evals + torch.where(solved, 2 + 2 * MAXTRIES, 0)
    return (nbytes(*inputs) + nbytes(*outputs),
            float(evals.sum()) * RESIDUAL_OPS["lake_ice_melt"]
            + s.root.numel() * ICE_MELT_LAKE_OPS)


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
    if name == "canopy_air_final":
        return compare_canopy_final(kern, plain, label)
    if name == "runoff_hourly":
        return compare_runoff(kern, plain, label)
    if name == "node_sweep":
        return compare_sweep(kern, plain, label)
    if label in DIST_PRCP_CONFIGS and name in SURFACE_KERNELS:
        dry_column_lanes(f"{name} ({label})", kwargs["eb_kwargs"])
    err = compare_brent(f"{name} ({label})", kern, plain)
    if name in TERMS_KERNELS:
        err = max(err, compare_terms(name, label, kern, plain, kwargs))
    return err


def compare_fields(label, got, ref, where, residual):
    """Each float field of the named tuples `got` and `ref` within
    TERMS_RTOL plus its own unit's absolute limit (testing.terms_atol; the
    `residual` field, the residual at the root, at TERMS_RESIDUAL_ATOL) on
    the lanes `where` (layered fields on all their layers), NaN at the same
    elements; returns the largest difference outside the residual."""
    worst, bad = 0.0, []
    for field in got._fields:
        a, b = getattr(got, field), getattr(ref, field)
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32 \
                or a is b:
            continue
        b = b.expand(a.shape)
        w = where if a.dim() == where.dim() else where[..., None]
        w = w.expand(a.shape)
        na, nb = torch.isnan(a), torch.isnan(b)
        nan_dis = int(((na != nb) & w).sum())
        diff = torch.where(w & ~na & ~nb, (a - b).abs(), 0.0)
        over = int((diff > terms_atol(field, residual)
                    + TERMS_RTOL * b.abs()).sum())
        if field != residual:
            worst = max(worst, float(diff.max()))
        if over or nan_dis:
            bad.append(f"{field}: {over} outside, {nan_dis} NaN apart, max "
                       f"|diff| {float(diff.max()):.3e}")
    print(f"  {label}: {int(where.sum())} lanes, every field within "
          f"rtol={TERMS_RTOL} and its unit's atol ({TERMS_ATOL} W/m^2 or "
          f"C, {TERMS_WATER_ATOL_M} m of water, {residual} "
          f"{TERMS_RESIDUAL_ATOL} W/m^2): {'yes' if not bad else bad}")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    return worst


def melt_ties(kern, plain, kwargs):
    """K2's melt test against its plain version's: the lanes where they
    differ, each printed with its balance at 0 C and refreeze energy;
    raises unless each lies within MELT_TIE_ULPS ulps of the tie
    rest == -refreeze_energy."""
    from vic_tpu_torch import constants as c
    t0 = plain.terms0
    refreeze = kwargs["surf_water"] * c.LF * c.RHO_W / kwargs["dt"]
    refreeze = refreeze.expand(t0.rest.shape)
    # the balance at 0 C before its two-pass branch
    rest = torch.where(plain.melt_cond, -t0.refreeze_energy,
                       t0.rest - refreeze)
    flips = kern.melt_cond != plain.melt_cond
    scale = torch.maximum(rest.abs(), refreeze.abs())
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    tie = (rest + refreeze).abs() <= MELT_TIE_ULPS * ulp
    for i in flips.reshape(-1).nonzero().reshape(-1).tolist():
        print(f"  snowpack_brent melt test flips at lane {i}: rest at 0 C "
              f"{float(rest.reshape(-1)[i])!r} W/m^2, refreeze_energy "
              f"{float(refreeze.reshape(-1)[i])!r} W/m^2, kernel "
              f"{bool(kern.melt_cond.reshape(-1)[i])}")
    if bool((flips & ~tie).any()):
        raise AssertionError(f"snowpack_brent: the melt test differs on "
                             f"{int((flips & ~tie).sum())} lanes away from "
                             "the tie")
    return flips


# K1's outputs besides its Brent's and its terms, as compare_fields holds
# them: its melt at 0 C, and what glacier_ablation forms at the accepted
# temperature
GlacierMelt = collections.namedtuple("GlacierMelt", "melt_mm")
GlacierAccepted = collections.namedtuple("GlacierAccepted",
                                         "cold_content vapor_flux")


def glacier_melt_ties(kern, plain, inputs):
    """K1's melt test against its plain version's: the lanes where they
    differ, each printed with its balance at 0 C; raises unless each lies
    within MELT_TIE_ULPS ulps of the tie melt_energy == 0, ulps of the
    largest of the balance's summands (the sum's rounding)."""
    from vic_tpu_torch.physics.glacier import glacier_energy_terms
    t0 = glacier_energy_terms(torch.zeros_like(kern.root), **inputs)
    scale = torch.stack([x.expand(t0.rest.shape).abs() for x in (
        inputs["net_short"], t0.net_long, t0.sensible, t0.latent,
        t0.latent_sub, t0.advection, t0.delta_cc, t0.grnd_flux)]).amax(0)
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    tie = t0.melt_energy.abs() <= MELT_TIE_ULPS * ulp
    flips = kern.melt_cond != plain.melt_cond
    for i in flips.reshape(-1).nonzero().reshape(-1).tolist():
        print(f"  glacier_brent melt test flips at lane {i}: balance at 0 C "
              f"{float(t0.melt_energy.reshape(-1)[i])!r} W/m^2, its largest "
              f"summand {float(scale.reshape(-1)[i])!r}, kernel "
              f"{bool(kern.melt_cond.reshape(-1)[i])}")
    if bool((flips & ~tie).any()):
        raise AssertionError(f"glacier_brent: the melt test differs on "
                             f"{int((flips & ~tie).sum())} lanes away from "
                             "the tie")
    return flips


def compare_glacier(label, kern, plain, kwargs):
    """K1's melt test, melt at 0 C, fallback flag and accepted temperature
    against its plain version's and the plain terms and what
    glacier_ablation forms from them at the kernel's own accepted
    temperature, on every lane (the melt on every lane but the melt test's
    ties); returns the largest difference."""
    from vic_tpu_torch import constants as c
    from vic_tpu_torch.physics.glacier import glacier_energy_terms
    inputs = {k: v for k, v in kwargs.items()
              if k not in ("max_iter", "max_tries")}
    flips = glacier_melt_ties(kern, plain, inputs)
    print(f"  {label}: melt test at 0 C on {int(plain.melt_cond.sum())} "
          f"lanes, {int(flips.sum())} flipped")
    ts = torch.where(kern.melt_cond, 0.0, torch.where(
        kern.converged, kern.root,
        inputs["old_tsurf"].expand(kern.root.shape)))
    same_ts = (kern.surf_temp == ts) | (torch.isnan(kern.surf_temp)
                                        & torch.isnan(ts))
    fb = ~kern.melt_cond & ~kern.converged
    fb_apart = int((kern.fbflag != plain.fbflag).sum())
    print(f"  {label}: accepted temperature is 0 C, the root or old_tsurf "
          f"on {int(same_ts.sum())} of {ts.numel()} lanes; fallback flags "
          f"{int(kern.fbflag.sum())}, {fb_apart} apart from the plain "
          "version's")
    if not bool(same_ts.all()) or not torch.equal(kern.fbflag, fb) \
            or not torch.equal(kern.fbflag[~flips], plain.fbflag[~flips]):
        raise AssertionError(f"{label}: accepted temperature or fallback "
                             "flag not as the plain version forms them")
    worst = compare_fields(f"{label} melt at 0 C",
                           GlacierMelt(kern.melt_mm),
                           GlacierMelt(plain.melt_mm), ~flips, None)
    terms = glacier_energy_terms(ts, **inputs)
    ones = torch.ones_like(flips)
    # held, but not the row's error: the cold content is ~1e6 J/m^2
    compare_fields(
        f"{label} cold content and vapour loss at the kernel's accepted "
        "temperature", GlacierAccepted(kern.cold_content, kern.vapor_flux),
        GlacierAccepted(torch.where(
            kern.melt_cond, 0.0,
            c.CH_ICE * ts * inputs["ice_depth_mm"] / 1000.0),
            -terms.vapor_flux), ones, None)
    return max(worst, compare_fields(
        f"{label} terms at the kernel's accepted temperature", kern.terms,
        terms, ones, "rest"))


def compare_terms(name, label, kern, plain, kwargs):
    """K5's terms, K2's melt test and terms at 0 C and at the root, or
    K1's (compare_glacier), against the plain terms at the kernel's own
    accepted temperature on every lane (K2's at 0 C on every lane but the
    melt test's ties); returns the largest difference."""
    from vic_tpu_torch.physics.snow import snow_energy_terms
    from vic_tpu_torch.physics.surface import surf_energy_terms
    label = f"{name} ({label})"
    if name == "glacier_brent":
        return compare_glacier(label, kern, plain, kwargs)
    if name == "surface_brent":
        eb = kwargs["eb_kwargs"]
        ts = torch.where(kern.converged, kern.root, eb["ts_old"])
        return compare_fields(f"{label} terms at the kernel's root",
                              kern.terms, surf_energy_terms(ts, **eb),
                              torch.ones_like(kern.converged), "error")
    inputs = {k: v for k, v in kwargs.items()
              if k not in ("max_iter", "max_tries")}
    if inputs.get("blowing_flux") is None:
        inputs["blowing_flux"] = 0.0
    flips = melt_ties(kern, plain, kwargs)
    print(f"  {label}: melt test at 0 C on {int(plain.melt_cond.sum())} "
          f"lanes, {int(flips.sum())} flipped")
    worst = compare_fields(f"{label} terms at 0 C", kern.terms0,
                           plain.terms0, ~flips, "rest")
    ts = torch.where(kern.converged, kern.root,
                     kwargs["old_tsurf"].expand(kern.root.shape))
    return max(worst, compare_fields(
        f"{label} terms at the kernel's root", kern.terms_b,
        snow_energy_terms(ts, **inputs), torch.ones_like(flips), "rest"))


def fd_surface_brent_plain(*args, **kwargs):
    """K7's plain version all the way down: the plain Brent with the plain
    node sweep inside at every candidate (the step's NodeSolve would launch
    K6). The result carries the profile solves and sweeps it ran."""
    from vic_tpu_torch.physics.frozen_soil import \
        solve_t_profile_explicit_plain
    from vic_tpu_torch.physics.surface import surface_root_plain
    solve = kwargs["eb_kwargs"]["fd_solve"]
    sweeps = []

    def plain_solve(ts):
        profile, opts = solve.at(ts)
        res = solve_t_profile_explicit_plain(*profile, **opts)
        sweeps.append(int(res.iterations))
        return res

    plain = surface_root_plain(*args, **dict(kwargs, eb_kwargs=dict(
        kwargs["eb_kwargs"], fd_solve=plain_solve)))
    return SimpleNamespace(**plain._asdict(), solves=len(sweeps),
                           sweeps=sum(sweeps))


def compare_fd_counts(label, kern, plain):
    """K7's Brent trips, profile solves and sweeps against its plain
    version's; raises where any differs."""
    counts = ((int(kern.iterations), plain.iterations),
              (int(kern.solves), plain.solves),
              (int(kern.sweeps), plain.sweeps))
    print(f"  fd_surface_brent ({label}): Brent trips, profile solves, "
          f"sweeps {counts} (kernel, plain)")
    if any(k != p for k, p in counts):
        raise AssertionError(f"fd_surface_brent ({label}): counts {counts} "
                             "differ from the plain loop's")


def check_kernel(name, label, args, kwargs, kern_fn, plain_fn, captured,
                 also_on=()):
    """K1-K9 and K14 on the arguments the `label` step gave them against
    their plain versions, then on those of the steps in `also_on`; returns
    (largest difference, (bytes, operations) of the first call)."""
    kern = kern_fn(*args, **kwargs)
    plain = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    err = compare(name, label, kern, plain, kwargs)
    if name == "fd_surface_brent":
        compare_fd_counts(label, kern, plain)
        work = fd_brent_work(kwargs, kern)
    elif name == "blowing_snow":
        work = blowing_work(kwargs, kern)
    elif name == "canopy_air_step":
        work = canopy_air_work(kwargs, kern)
    elif name == "canopy_air_final":
        work = canopy_air_work(kwargs, kern, CANOPY_AIR_FINAL_OPS_PER_LANE)
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
        kern, plain = kern_fn(*a, **kw), plain_fn(*a, **kw)
        err = max(err, compare(name, also, kern, plain, kw))
        if name == "fd_surface_brent":
            compare_fd_counts(also, kern, plain)
        for k in ALSO_CALLS.get(also, {}).get(name, ()):
            a, kw = captured[also][f"{name}@{k}"]
            err = max(err, compare(name, f"{also}, call {k}",
                                   kern_fn(*a, **kw), plain_fn(*a, **kw),
                                   kw))
    return err, work


def step_label(config, nnode):
    return f"{config}/nnode={nnode}" if nnode else config


def lane_brent_stats(name, args, kwargs, kern_fn, regs):
    """The lanes of a kernel on lane_brent.cuh's driver (K2, K3, K5, K14) on
    a row's arguments, as tools/profile_lane_brent.py reads them from the
    kernel's outputs: the warp efficiency of consecutive lanes and the
    waves at the registers ptxas reports for the instance the call
    launches."""
    from vic_tpu_torch.ops.rootfind import MAXTRIES
    lt = lane_tools()
    out = kern_fn(*args, **kwargs)
    evals = lt.evaluations(lt.solved_lanes(name, args[2], kwargs, out), out,
                           kwargs.get("max_tries", MAXTRIES))
    n_reg, spill, _ = lt.instance_registers(regs or {}, name,
                                            kwargs.get("eb_kwargs"))
    resident = lt.resident_threads(n_reg, 128) if n_reg else None
    lanes = out.root.numel()
    print(f"  {name}: lanes {lanes}, active {int((evals > 0).sum())}, "
          f"evaluations a lane max {int(evals.max())}, warp efficiency "
          f"{lt.warp_efficiency(evals):.4f} (consecutive lanes), ptxas "
          f"{n_reg} registers ({spill} B spill stores), waves "
          f"{lanes / resident if resident else None}")


# the kernels whose every instance must compile without spills: K10 and
# K11 (one warp a lake, its layers in registers), the water balance (its
# solves' spans in registers) and K16; of K16 the instances that hold their
# nodes in registers (csrc/implicit_profile.cu RegisterLane, their mangled
# names' node counts) must also have no stack frame
SPILL_FREE_KERNELS = ("lake_open_water", "lake_under_ice",
                      "lake_water_balance", "implicit_profile")
FRAME_FREE_INSTANCES = {"implicit_profile": tuple(
    f"ILi{n}E" for n in (3, 5, 10))}


def kernel_registers(name, regs):
    """Prints ptxas' registers, stack frame and spill stores of each
    instance of `name`'s kernel (build_phase's `regs`); fails on a spill,
    or on a stack frame where FRAME_FREE_INSTANCES names the instance."""
    found = {k: v for k, v in (regs or {}).items() if f"{name}_kernel" in k}
    if not found:
        raise AssertionError(f"{name}: no kernel in ptxas' report")
    for key, (n_reg, spill, frame) in sorted(found.items()):
        print(f"  {name}: {key}: ptxas {n_reg} registers, {frame} B stack "
              f"frame, {spill} B spill stores")
        if spill:
            raise AssertionError(f"{name}: {key}: {spill} B of spill stores")
        if frame and any(t in key for t in FRAME_FREE_INSTANCES.get(name,
                                                                    ())):
            raise AssertionError(f"{name}: {key}: a {frame} B stack frame "
                                 "in an instance that holds its nodes in "
                                 "registers")


# the kernels whose call is one device event: no fill, no copy
ONE_LAUNCH = ("canopy_air_step", "canopy_air_final", "lake_depth",
              "lake_water_balance", "lake_ice_melt")


def device_events(fn, calls=3):
    """The device events (kernels, memsets, copies) one call of fn makes:
    the most that any of `calls` calls traced in one profiler session made
    (tools/profile_fd_surface.py's `_profiled`, each device event tied to
    its call by its launch). Late in a long process the profiler on the
    card has dropped the records of a session's first kernels, while a
    fill or a copy beside the kernel would be in every call (PERF.md)."""
    numbers = lane_tools()._profiled(
        {f"call {i}": fn for i in range(calls)})[1]
    return max(n["device_events"] for n in numbers.values())


# device cycles spun before each call device_ms times (~2 ms on an H100),
# far longer than a wrapper's host time
DEVICE_SPIN_CYCLES = 4_000_000


def device_ms(fn, calls=5):
    """The device's milliseconds in one call of fn, the wrapper's host time
    left out: CUDA events around the call, recorded behind a spin of the
    device (torch.cuda._sleep) long enough that the host has enqueued the
    call before the device reaches it; the median of `calls` calls. (Late
    in this process torch.profiler, which device_events reads, has recorded
    no device event at all: PERF.md.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(DEVICE_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_phase(device, regs=None):
    """regs: ptxas' {kernel: (registers, spill bytes, stack frame bytes)}
    (build_phase)."""
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
            cells=NODE_COUNT_CELLS if nnode else None,
            also=ALSO_CALLS.get(config))
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
            if row in SPILL_FREE_KERNELS:
                kernel_registers(name, regs)
            continue
        args, kwargs = captured[label][name]
        plain_fn = getattr(importlib.import_module(
            f"vic_tpu_torch.physics.{module}"), plain_name)
        if name == "fd_surface_brent":
            plain_fn = fd_surface_brent_plain
        if name == "lake_depth":
            plain_fn = lake_depth_plain
        if row != name:
            check_form(row, nnode, args, kwargs)
        if name in LAKE_KERNELS:
            err, work = check_lake_kernel(name, args, kwargs,
                                          calls[label][name])
            for also in ALSO_ON[name]:
                a, kw = captured[also][name]
                err = max(err, check_lake_kernel(
                    name, a, kw, calls[also][name], also, RECORD[also])[0])
            for config, record in LAKE_RECORDS.get(name, ()):
                n_calls = {}
                a, kw = capture_kernel_args(config, (name,), device,
                                            record=record, calls=n_calls)[name]
                err = max(err, check_lake_kernel(
                    name, a, kw, n_calls[name], config, record)[0])
            if name == "lake_ice_melt":
                err = max(err, seeded_ice_melt(device))
        else:
            err, work = check_kernel(
                name, label if row == name else row, args, kwargs, kern_fn,
                plain_fn, captured, ALSO_ON.get(name, ()) if row == name
                else ())
        ms = cuda_ms(lambda: kern_fn(*args, **kwargs), reps=20)
        # K7's plain version sweeps the profile in plain torch at every
        # candidate: seconds a call at 10 nodes
        plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs),
                           reps=1 if name == "fd_surface_brent" else 3)
        bound_ms, bound_by = bound(*work)
        if row in ONE_LAUNCH:
            events = device_events(lambda: kern_fn(*args, **kwargs))
            print(f"  {row}: {events} device events a call")
            if events != 1:
                raise AssertionError(f"{row}: {events} device events a call "
                                     "(a fill or a copy beside the kernel)")
        print(f"  {row}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
              f"{work[1]:.4g} FP32 operations)")
        results[row] = dict(
            name=row, route="cuda", source=CSRC + source, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        if row in LANE_BRENT_KERNELS:
            lane_brent_stats(name, args, kwargs, kern_fn, regs)
        if row in SPILL_FREE_KERNELS:
            kernel_registers(name, regs)
        if row in HEAVY_LAKE_TIMED:
            # the heavy path's own form of the kernel: K12 with the
            # blowing-snow flux, K8 on the 8,192 lake lanes
            a, kw = captured["heavy"][name]
            kern = kern_fn(*a, **kw)
            work = (ice_melt_work(kw, kern) if name == "lake_ice_melt"
                    else blowing_work(kw, kern))
            bound_ms, bound_by = bound(*work)
            print(f"  {name} ({HEAVY_LAKE_TIMED[name]}): kernel "
                  f"{cuda_ms(lambda: kern_fn(*a, **kw), reps=20):.4f} ms, "
                  f"plain torch "
                  f"{cuda_ms(lambda: plain_fn(*a, **kw), reps=3):.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
                  f"{work[1]:.4g} FP32 operations)")
    return results


def nan_profile_build(n_cell, n_rec, device):
    """frozen_exp's configuration with CONTINUEONERROR and NaN air
    temperature in NAN_CELLS cells from record FROZEN_RECORD."""
    from vic_tpu_torch import entry
    gp = entry.frozen_exp_params(n_rec).replace(continue_on_error=True)
    gp, params, stack, state, extras = entry._build(gp, n_cell, n_rec, device)
    air = stack["air_temp"].clone()
    air[FROZEN_RECORD:, torch.arange(0, n_cell, n_cell // NAN_CELLS,
                                     device=air.device)[:NAN_CELLS]] = \
        float("nan")
    return gp, params, dict(stack, air_temp=air), state, extras


def nan_profile_checks(device):
    """K7 and K6 where a NaN reaches the node profile: the frozen_exp step
    with CONTINUEONERROR and NaN air temperature in NAN_CELLS cells, in the
    first record with the NaN (FROZEN_RECORD), whose surface Brent solves
    the profile at NaN candidates on those cells' lanes. A NaN change stops
    every lane's sweeps, in vic_tpu as in the kernels. K7 against its plain
    Brent with the plain node sweep inside (equal Brent trips, profile
    solves and sweeps; the other lanes within the Brent bound), and K6 at
    the lower bracket ends against its plain version (equal sweep and
    fallback counts, the other lanes within SWEEP_TOL); returns the
    largest differences, {kernel: C}."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.frozen_soil import \
        solve_t_profile_explicit_plain
    (args, kwargs), = capture_kernel_args(
        "frozen_exp", ("fd_surface_brent",), device, record=FROZEN_RECORD,
        build=nan_profile_build).values()
    lo = args[0]
    solve = kwargs["eb_kwargs"]["fd_solve"]
    print(f"  NaN profile (frozen_exp, CONTINUEONERROR, NaN air in "
          f"{NAN_CELLS} cells from record {FROZEN_RECORD}): "
          f"{int(torch.isnan(lo).sum())} lanes with a NaN candidate")
    if not bool(torch.isnan(lo).any()):
        raise AssertionError("NaN profile: no NaN candidate reached the "
                             "surface Brent")
    profile, opts = solve.at(lo)
    err = compare_sweep(kernels.node_sweep(*profile, **opts),
                        solve_t_profile_explicit_plain(*profile, **opts),
                        "frozen_exp, NaN candidates")
    kern = kernels.fd_surface_brent(*args, **kwargs)
    plain = fd_surface_brent_plain(*args, **kwargs)
    torch.cuda.synchronize()
    compare_fd_counts("frozen_exp, NaN candidates", kern, plain)
    return {"node_sweep": err,
            "fd_surface_brent": compare_brent(
                "fd_surface_brent (frozen_exp, NaN candidates)", kern,
                plain)}


# the kernels nan_terms_checks holds where NaN reaches their lanes
NAN_TERMS_KERNELS = ("snowpack_brent", "surface_brent", "glacier_brent",
                     "runoff_hourly")


def nan_terms_checks(device):
    """K2, K5, K1 and K4 where NaN reaches their lanes: the spatial_snow
    step (CONTINUEONERROR) with NaN air temperature in NAN_CELLS cells from
    record NAN_FROM, on that record's arguments: every output, the terms
    included, NaN at the plain version's elements, and the rest held as
    `compare` holds it. Returns {row: largest difference} (K2's and K5's
    SPATIAL_SNOW rows, K1's and K4's own)."""
    from vic_tpu_torch import kernels
    label = "spatial_snow, NaN air"
    names = NAN_TERMS_KERNELS
    captured = capture_kernel_args(
        "spatial_snow", names, device, record=NAN_FROM,
        build=continue_on_error_build("spatial_snow", shift=0))
    errs = {}
    for name in names:
        _, _, module, plain_name, _ = KERNELS[name]
        plain_fn = getattr(importlib.import_module(
            f"vic_tpu_torch.physics.{module}"), plain_name)
        args, kwargs = captured[name]
        kern = getattr(kernels, name)(*args, **kwargs)
        plain = plain_fn(*args, **kwargs)
        torch.cuda.synchronize()
        _, _, count = nan_lanes_agree(f"{name} ({label})", kern, plain)
        if not count:
            raise AssertionError(f"{name} ({label}): no NaN reached the "
                                 "kernel")
        row = f"{name}/spatial_snow"
        errs[row if row in ROWS else name] = compare(name, label, kern,
                                                     plain, kwargs)
    return errs


def count_balance_calls():
    """Wrap vic_tpu_torch.model.surf_energy_terms,
    physics.snow.snow_energy_terms, physics.glacier.glacier_energy_terms,
    physics.lake.ice_energy_terms and
    physics.runoff.compute_runoff_and_asat to count their calls on CUDA
    tensors; returns (the counts, the function that puts them back)."""
    from vic_tpu_torch import model
    from vic_tpu_torch.physics import glacier, lake, runoff, snow
    homes = {"surf_energy_terms": model, "snow_energy_terms": snow,
             "glacier_energy_terms": glacier, "ice_energy_terms": lake,
             "compute_runoff_and_asat": runoff}
    counts = dict.fromkeys(homes, 0)
    originals = {k: getattr(m, k) for k, m in homes.items()}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            if any(t.is_cuda for t in flat_tensors((args, kwargs))):
                counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, mod in homes.items():
        setattr(mod, name, counted(name, originals[name]))

    def restore():
        for name, mod in homes.items():
            setattr(mod, name, originals[name])
    return counts, restore


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
    print(f"  {row}: on the {label} step's record "
          f"{RECORD.get(label.split('/')[0], 0)}")
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
        err = max(err, check_mass_release_table(row, args, storage))
    ms = cuda_ms(lambda: kern_fn(*args, **kwargs), reps=20)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs), reps=3)
    work = loop_work(name, args, kwargs, kern)
    bound_ms, bound_by = bound(*work)
    dev_ms = device_ms(lambda: kern_fn(*args, **kwargs))
    print(f"  {row}: kernel {ms:.4f} ms (wrapper included), device "
          f"{dev_ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({work[0]} bytes, "
          f"{work[1]:.4g} FP32 operations)")
    return dict(name=row, route="cuda", source=CSRC + source,
                replaces=replaces, launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def check_mass_release_table(row, args, storage):
    """K15's two paths on the card: the light step's canopy snow and melt
    storage must take the vector path (both lane-contiguous and 16-byte
    aligned), and the same canopy snow as a view offset by one float with
    the seeded storage of the cell's first HRU broadcast over its HRUs
    ([n_cell, 1]) the table path, held against the plain version and timed;
    returns the largest difference."""
    from vic_tpu_torch import kernels
    from vic_tpu_torch.physics.canopy_snow import mass_release_plain
    int_snow, tstore = args
    if kernels.mass_release_route(int_snow, tstore) != "vector":
        raise AssertionError(f"{row}: the step's canopy lanes did not take "
                             "K15's vector path")
    buf = torch.empty(int_snow.numel() + 1, device=int_snow.device)
    buf[1:] = int_snow.reshape(-1)
    offset = buf[1:].view(int_snow.shape)
    cell = storage[:, :1]
    label = f"{row} (table path: offset canopy snow, [n_cell, 1] storage)"
    if kernels.mass_release_route(offset, cell) != "table":
        raise AssertionError(f"{label}: did not take K15's table path")
    err = compare_loop(label, "mass_release",
                       kernels.mass_release(offset, cell),
                       mass_release_plain(offset, cell))
    ms = cuda_ms(lambda: kernels.mass_release(offset, cell), reps=20)
    dev_ms = device_ms(lambda: kernels.mass_release(offset, cell))
    print(f"  {label}: kernel {ms:.4f} ms (wrapper included), device "
          f"{dev_ms:.4f} ms")
    return err


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
    from vic_tpu_torch import kernels, trace
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
    # the balances' terms come from K5, K2, K1 and K12 on their paths, the
    # infiltration curve from K4: no plain evaluation of any of them
    balance_calls, restore_balances = count_balance_calls()
    try:
        kernels.reset_launches()
        # K7's profile solves and sweeps (K6 inside its one launch): the
        # program's counters across the run
        counts0 = trace.counters()
        t0 = time.perf_counter()
        final, outs = run(state, stack, params, gp, **extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = trace.counters()
        launches = dict(kernels.launches)
    finally:
        restore_balances()
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
    print(f"  plain balance evaluations on the card in this run: "
          f"{balance_calls} (surf_energy_terms: the finite-difference "
          "paths' terms at the root)")
    on_k5 = "surface_brent" in PATH_KERNELS[config]
    if any(v for k, v in balance_calls.items()
           if k != "surf_energy_terms") or (
            on_k5 and balance_calls["surf_energy_terms"]):
        raise AssertionError(f"{config}: the step evaluated a balance in "
                             f"plain torch on the card: {balance_calls}")
    print("  kernel launches per record: " + json.dumps(
        {k: v / SMOKE_RECS for k, v in launches.items() if v}))
    if launches["fd_surface_brent"]:
        solves, sweeps = (counts[k] - counts0[k]
                          for k in ("k7_solves", "k7_sweeps"))
        print(f"  fd_surface_brent: {solves / SMOKE_RECS} profile solves "
              f"and {sweeps / SMOKE_RECS} sweeps a record inside its "
              "launches")
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
        # one K9 launch a pass and one for the final update
        expect_launches(config, launches, canopy_air_step=sum(passes),
                        canopy_air_final=SMOKE_RECS)
    if config in ("lakes", "heavy"):
        # the depth before the step and solve_lake's; the water balance's
        # 41 inside its one launch
        expect_launches(config, launches, lake_depth=2 * SMOKE_RECS,
                        lake_water_balance=SMOKE_RECS,
                        lake_ice_melt=SMOKE_RECS)
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


def expect_launches(config, launches, **expected):
    """Raise unless each named kernel launched as often as expected."""
    wrong = {k: (launches[k], v) for k, v in expected.items()
             if launches[k] != v}
    print(f"  launches {expected}: "
          + ("as expected" if not wrong else f"(got, expected) {wrong}"))
    if wrong:
        raise AssertionError(f"{config}: launches {wrong}")


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


# CONTINUEONERROR on the bases whose CLOSE_ENERGY, blowing-snow and lake
# kernels K8-K14 step: the slice's cells, and the rows held against their
# plain versions on the first NaN record's arguments (K8 on heavy's HRU
# lanes, then on its lake lanes, its second call in a step)
NAN_SLICES = {"heavy": HEAVY_CELLS, "blowing_close": SMOKE_CELLS}
NAN_ROWS = {"heavy": ("blowing_snow", "blowing_snow/lake_lanes",
                      "canopy_air_step", "canopy_air_final",
                      "lake_open_water", "lake_under_ice", "lake_ice_melt",
                      "lake_depth", "lake_water_balance",
                      "affine_surface_brent"),
            "blowing_close": ("blowing_snow", "canopy_air_step",
                              "canopy_air_final")}


def nan_cells(n_cell, shift=0):
    """The NAN_CELLS cells given NaN air temperature: spread over the
    domain, odd and even by turns (heavy_forcing's odd cells are its cold,
    snowy ones, its even cells warm), `shift` cells on."""
    return (torch.arange(0, n_cell, n_cell // NAN_CELLS)[:NAN_CELLS]
            + torch.arange(NAN_CELLS) % 2 + shift)


def continue_on_error_build(config, shift=None):
    """`config`'s builder with CONTINUEONERROR and, unless shift is None,
    NaN air temperature in nan_cells(n_cell, shift) from record
    NAN_FROM."""
    def build(n_cell, n_rec, device):
        gp, params, stack, state, extras = CONFIGS[config](n_cell, n_rec,
                                                           device)
        if shift is not None:
            air = stack["air_temp"].clone()
            air[NAN_FROM:, nan_cells(n_cell, shift).to(air.device)] = \
                float("nan")
            stack = dict(stack, air_temp=air)
        return (gp.replace(continue_on_error=True), params, stack, state,
                extras)
    return build


def nan_lanes_agree(label, kern, plain):
    """Raise unless every float output of a kernel is NaN exactly where its
    plain version's is; returns (kern, plain) with those elements set to 0,
    for the row's own comparison, and the count of NaN elements."""
    count = 0

    def walk(a, b):
        nonlocal count
        if isinstance(a, torch.Tensor):
            if a.dtype != torch.float32:
                return a, b
            na, nb = torch.isnan(a), torch.isnan(b)
            if not torch.equal(na, nb):
                raise AssertionError(f"{label}: NaN at {int((na != nb).sum())}"
                                     " elements where the plain version's "
                                     "differ")
            count += int(na.sum())
            return torch.where(na, 0.0, a), torch.where(nb, 0.0, b)
        if isinstance(a, tuple):
            pairs = [walk(x, y) for x, y in zip(a, b)]
            make = (lambda xs: type(a)(*xs)) if hasattr(a, "_fields") \
                else tuple
            return make([x for x, _ in pairs]), make([y for _, y in pairs])
        return a, b

    kern, plain = walk(kern, plain)
    print(f"  {label}: {count} NaN elements, the same as the plain "
          "version's")
    return kern, plain, count


def check_nan_row(row, label, args, kwargs, calls):
    """A kernel of NAN_ROWS against its plain version on the first NaN
    record's arguments: NaN at the same elements, the rest within the
    row's tolerance; returns (kernel, largest difference)."""
    from vic_tpu_torch import kernels
    name = row.split("/")[0]
    source, replaces, module, plain_name, _ = KERNELS[name]
    plain_fn = (lake_depth_plain if name == "lake_depth" else getattr(
        importlib.import_module(f"vic_tpu_torch.physics.{module}"),
        plain_name))
    kern = getattr(kernels, name)(*args, **kwargs)
    plain = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    if name == "canopy_air_step":
        print(f"  {row} ({label}): batch max change {float(kern[2])} / "
              f"{float(plain[2])} C (kernel/plain)")
    kern, plain, _ = nan_lanes_agree(f"{row} ({label})", kern, plain)
    if name == "lake_ice_melt":
        # held against the plain version at its own roots, NaN and all
        err = check_lake_kernel(name, args, kwargs, calls[name], label,
                                NAN_FROM)[0]
    elif name in LAKE_KERNELS:
        err = check_lake_kernel(name, args, kwargs, calls[name], label,
                                NAN_FROM, results=(kern, plain))[0]
    elif name == "blowing_snow":
        err = compare_blowing(kern, plain, kwargs["snowdepth"],
                              f"{label}, {row}", exercised=row == name)
    else:
        err = compare(name, label, kern, plain, kwargs)
    return name, err


# the control run's NaN cells lie this many cells from the NaN run's
NAN_SHIFT = 2


def nan_slice_phase(device, config):
    """CONTINUEONERROR with NaN air temperature in NAN_CELLS cells from
    record NAN_FROM on `config` (NAN_SLICES' cells x SMOKE_RECS records):
    first NAN_ROWS' kernels against their plain versions on the first NaN
    record's arguments, then the slice without the NaN, with it, and with
    it in cells NAN_SHIFT on (the control), the plain solvers guarded. The
    NaN cells must read OUT_CELL_VALID 0 from NAN_FROM and every cell the
    run without NaN's outputs before it. A NaN keeps the batch-wide
    CLOSE_ENERGY pass loop going to its cap (vic_tpu/model.py:841's
    jnp.max), and past convergence the other cells' secant steps move
    them: beyond REF_TOL of the run without the NaN, in vic_tpu too
    (tools/heavy_nan_coupling.py), so those differences are printed, and the
    cells NaN in neither run are held against the control, whose pass
    counts and batch-wide stops are the NaN run's, at REF_TOL; on heavy
    their cold cells must close their water balance within WATER_TOL.
    Returns the rows' largest differences, {kernel: difference}."""
    from vic_tpu_torch.model import run
    n_cell = NAN_SLICES[config]
    label = f"{config}, NaN air"
    phase(f"4 NaN slice: {config}, {n_cell} cells x {SMOKE_RECS} records, "
          f"CONTINUEONERROR, NaN air temperature in {NAN_CELLS} cells from "
          f"record {NAN_FROM}")
    build = continue_on_error_build(config, shift=0)
    errs, calls = {}, {}
    rows = NAN_ROWS[config]
    names = sorted({r.split("/")[0] for r in rows})
    captured = capture_kernel_args(config, names, device, record=NAN_FROM,
                                   calls=calls, build=build, cells=n_cell)
    if "blowing_snow/lake_lanes" in rows:
        captured["blowing_snow/lake_lanes"] = capture_kernel_args(
            config, ("blowing_snow",), device, record=NAN_FROM,
            nth={"blowing_snow": 1}, build=build,
            cells=n_cell)["blowing_snow"]
    for row in rows:
        args, kwargs = captured[row]
        name, err = check_nan_row(row, label, args, kwargs, calls)
        errs[name] = max(errs.get(name, 0.0), err)

    runs = {}
    for shift in (None, 0, NAN_SHIFT):
        gp, params, stack, state, extras = continue_on_error_build(
            config, shift)(n_cell, SMOKE_RECS, device)
        restore = guard_plain_solvers()
        try:
            runs[shift] = run(state, stack, params, gp, **extras)[1]
            torch.cuda.synchronize()
        finally:
            restore()
    clean, outs, control = runs[None], runs[0], runs[NAN_SHIFT]
    cells = nan_cells(n_cell).to(device)
    others = torch.ones(n_cell, dtype=torch.bool, device=device)
    others[cells] = False
    others[nan_cells(n_cell, NAN_SHIFT).to(device)] = False
    passes = [[int(x) for x in o["OUT_TCANOPY_ITER"][:, others][:, 0]]
              for o in (clean, outs, control)]
    print(f"  CLOSE_ENERGY passes per record without the NaN, with it, "
          f"the control: {passes}")
    valid = torch.ones_like(outs["OUT_CELL_VALID"])
    valid[NAN_FROM:, cells] = 0.0
    bad = [] if torch.equal(outs["OUT_CELL_VALID"], valid) \
        else ["OUT_CELL_VALID"]
    bad += [f"{k} (before the NaN)" for k, v in outs.items()
            if not torch.equal(v[:NAN_FROM], clean[k][:NAN_FROM])]
    if passes[1][NAN_FROM:] != [CLOSE_ENERGY_MAXITER] * (SMOKE_RECS
                                                          - NAN_FROM):
        bad.append("OUT_TCANOPY_ITER (the NaN records' pass count)")
    worst, worst_control = {}, {}
    for k, v in outs.items():
        b = v[:, others]
        if not bool(torch.isfinite(b).all()):
            bad.append(f"{k} (other cells not finite)")
        worst[k] = float((b - clean[k][:, others]).abs().max())
        a = control[k][:, others]
        diff = (b - a).abs()
        worst_control[k] = float(diff.max())
        if bool((diff > REF_TOL + REF_TOL * a.abs()).any()):
            bad.append(f"{k} (other cells beyond rtol=atol={REF_TOL} of "
                       "the control)")
    for title, w in (("the run without the NaN", worst),
                     ("the control", worst_control)):
        top = sorted(w, key=w.get, reverse=True)[:6]
        print(f"  other cells against {title}, largest differences: "
              + ", ".join(f"{k} {w[k]:.4g}" for k in top))
    print(f"  cells valid at the end "
          f"{int(outs['OUT_CELL_VALID'][-1].sum())} of {n_cell}")
    if config == "heavy":
        werr = outs["OUT_WATER_ERROR"].abs().amax(0)[others]
        cold = (torch.arange(n_cell, device=device) % 2 == 1)[others]
        print(f"  max |OUT_WATER_ERROR| of the other cold cells "
              f"{float(werr[cold].max()):.3e} mm")
        if float(werr[cold].max()) > WATER_TOL:
            bad.append("OUT_WATER_ERROR (other cold cells)")
    if bad:
        raise AssertionError(f"NaN slice {config}: {bad}")
    return errs


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


def hold_warm_start(label, res, res_c, at_restart, mask, n_first):
    """A warm start from a state file against the continuous run `res`:
    lanes without snow at the restart hold test_state_io's legacy resume
    tolerances; lanes under snow diverge where the file does not carry
    LongUnderOut or the snow coverage (the legacy formats and the
    reference's NetCDF schema), which a warm start re-derives
    (initialize_model_state.c:291-293, :327), as vic_tpu's does on CPU
    (ROADMAP.md queue 3): printed, not held."""
    cont, warm = res.final_state, res_c.final_state
    snow = ((at_restart.swq + at_restart.snow_canopy).numpy() > 0.0) & mask
    for name, (rtol, atol) in (("moist", WARM_MOIST_TOL),
                               ("swq", WARM_SWQ_TOL)):
        a, b = getattr(cont, name).numpy(), getattr(warm, name).numpy()
        d = np.abs(b - a).reshape(snow.shape + (-1,))
        bound = (atol + rtol * np.abs(a)).reshape(d.shape)
        excess = float((d - bound)[~snow].max())
        print(f"  {label} warm start, {WARM_RECS} records: {name} max |diff| "
              f"{float(d[~snow].max()):.4g} on the lanes without snow "
              f"at the restart (rtol {rtol}, atol {atol}: excess "
              f"{excess:.4g}); {float(d[snow].max()):.4g} on the "
              f"{int(snow.sum())} lanes under snow")
        if excess > 0:
            raise AssertionError(f"{label} warm start {name} outside "
                                 f"rtol={rtol}, atol={atol}")
    out_diff = max(float(np.abs(v - res.outputs[k][n_first:]).max())
                   for k, v in res_c.outputs.items())
    print(f"  {label} warm start: largest |difference| of its outputs from "
          f"the continuous run {out_diff:.4g}")


SHARDS = 4                   # OUTPUT_SHARDS of the shard check


def shards_check(driver, gp, domain, res, tmp):
    """The driver run's outputs written as NETCDF in SHARDS shards, merged
    (parallel/io_shards.merge_shards) and held against the one file a
    single writer makes of them; only where libnetcdf is found."""
    from vic_tpu_torch.io import native
    if not native.netcdf_found():
        print(f"  OUTPUT_SHARDS {SHARDS}: not run: libnetcdf was not found "
              "on this host (io.native.netcdf_found() is False), and "
              "shards are NetCDF files")
        return
    from vic_tpu_torch.io.native import NetCDFFile
    from vic_tpu_torch.parallel.io_shards import find_shards, merge_shards
    out_dir = os.path.join(tmp, "shards")
    os.makedirs(out_dir)
    gp_s = gp.replace(output_format="NETCDF", output_shards=SHARDS,
                      result_dir=out_dir)
    steps = max(1, gp.out_step // gp.dt)
    t0 = time.perf_counter()
    driver.write_outputs(gp_s, domain, res.timeaxis, res.outputs, steps)
    base = os.path.join(out_dir, gp_s.netcdf_output_filename)
    n_files = len(find_shards(base))
    merged = merge_shards(base, os.path.join(out_dir, "merged.nc"))
    t_shards = time.perf_counter() - t0
    driver.write_outputs(gp_s.replace(output_shards=1,
                                      netcdf_output_filename="single.nc"),
                         domain, res.timeaxis, res.outputs, steps)
    worst = 0.0
    with NetCDFFile(merged) as fm, NetCDFFile(os.path.join(
            out_dir, "single.nc")) as fs:
        if fm.var_names() != fs.var_names():
            raise AssertionError("merged shards hold other variables")
        for v in fs.var_names():
            shape = [fs.dim_len(d) for d in fs.var_info(v)[1]]
            a = fs.get(v, [0] * len(shape), shape)
            b = fm.get(v, [0] * len(shape), shape)
            worst = max(worst, float(np.abs(b - a).max()) if a.size else 0.0)
    print(f"  OUTPUT_SHARDS {SHARDS}: {n_files} shard files written and "
          f"merged in {t_shards:.3f} s; largest |difference| of the merge "
          f"from the single writer's file {worst}")
    if n_files != SHARDS or worst != 0.0:
        raise AssertionError("the merged shards differ from the single "
                             "writer's file")


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
        hold_warm_start("ASCII", res, res_c, at_restart, mask, n_first)

        # the same half again with STATE_FORMAT NETCDF (one block): the
        # reference's NetCDF schema where libnetcdf is found, else the npz
        # at the state path + ".npz" (vic_tpu's rule)
        from vic_tpu_torch.io.state_io import npz_path
        gp_n = gp_b.replace(state_format="NETCDF",
                            state_name=os.path.join(tmp, "state_n"))
        t0 = time.perf_counter()
        res_n = driver.run_simulation(gp_n, domain=domain, forcing=first,
                                      chunk_recs=DRIVER_CHUNK,
                                      write_output=False, progress=False)
        st_n = res_n.stage_s
        nc_path = driver._state_path(gp_n, (int(ax.year[last]),
                                            int(ax.month[last]),
                                            int(ax.day[last])))
        written = nc_path if os.path.exists(nc_path) else npz_path(nc_path)
        if not os.path.exists(written):
            raise AssertionError(f"no NETCDF state at {nc_path}(.npz)")
        diff_n = max(float(np.abs(v - res_b.outputs[k]).max())
                     for k, v in res_n.outputs.items())
        print(f"  STATE_FORMAT NETCDF, {n_first} records: "
              f"{time.perf_counter() - t0:.3f} s (model run "
              f"{st_n['run']:.3f}, outputs and state {st_n['write']:.3f}); "
              f"wrote {os.path.basename(written)} ({os.path.getsize(written)}"
              f" bytes; libnetcdf found: {native.netcdf_found()}); largest "
              f"|difference| of its outputs from the blocks' {diff_n}")
        if diff_n != 0.0:
            raise AssertionError("the NETCDF-state run differs from the "
                                 "blocks' run")
        loaded_n = load_state(nc_path, gp, initial_state(domain, gp, "cpu"),
                              domain)
        file_diff = max(float(np.abs(
            getattr(loaded_n, k).numpy()[mask].astype(np.float64)
            - getattr(res_n.final_state, k).numpy()[mask]).max())
            for k in STATE_FILE_FIELDS)
        print(f"  NETCDF state file read back: largest |difference| from the "
              f"run's state over {len(STATE_FILE_FIELDS)} fields {file_diff}")
        if file_diff != 0.0:
            raise AssertionError("the NETCDF state file does not hold the "
                                 "state")
        res_cn = driver.run_simulation(
            gp_c, domain=warm_domain,
            forcing={k: v[n_first:] for k, v in res.forcing.items()},
            init_state_path=nc_path, write_output=False, progress=False)
        hold_warm_start("NETCDF", res, res_cn, res_n.final_state, mask,
                        n_first)

        shards_check(driver, gp, domain, res, tmp)

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


SPLIT_CONFIGS = ("light", "lakes", "heavy")
# tests/test_sharding_driver.py's gate: rtol = atol, and the closure
# residuals' atol
SPLIT_TOL = 1e-5
SPLIT_ERROR_ATOL = 1e-3


def split_devices():
    """Every CUDA device; on a one-card host the card twice, so the split
    (two shares, two steps) runs all the same."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2


def split_outside(one, split):
    """(largest |difference| of the split run from the one-device run over
    every output and state field, the leaves outside the gate)."""
    worst, failed = 0.0, []
    pairs = [(k, v, split.outputs[k], SPLIT_ERROR_ATOL if k.endswith(
        "_ERROR") else SPLIT_TOL) for k, v in one.outputs.items()]
    pairs += [(f.name, getattr(one.final_state, f.name).numpy(),
               getattr(split.final_state, f.name).numpy(), SPLIT_TOL)
              for f in dataclasses.fields(one.final_state)]
    for name, a, b, atol in pairs:
        if a.dtype.kind not in "fc":
            if not np.array_equal(a, b):
                failed.append(name)
            continue
        worst = max(worst, float(np.abs(b - a).max()) if a.size else 0.0)
        if not np.allclose(b, a, rtol=SPLIT_TOL, atol=atol, equal_nan=True):
            failed.append(name)
    return worst, failed


def split_run(driver, kernels, config, gp, domain, forcing, kw):
    """One run of split_phase: (the RunResult, the path kernels' launches,
    K7's sweeps summed over each host thread's calls)."""
    import threading
    restore = guard_plain_solvers()
    sweeps, fd_surface_brent = [], kernels.fd_surface_brent

    def counted(*args, **kwargs):
        res = fd_surface_brent(*args, **kwargs)
        sweeps.append((threading.get_ident(), res.sweeps))
        return res

    kernels.fd_surface_brent = counted
    try:
        kernels.reset_launches()
        res = driver.run_simulation(gp, domain=domain, forcing=dict(forcing),
                                    write_output=False, progress=False, **kw)
        launches = {k: kernels.launches[k] for k in PATH_KERNELS[config]}
    finally:
        kernels.fd_surface_brent = fd_surface_brent
        restore()
    by_thread = collections.defaultdict(int)
    for ident, n in sweeps:
        by_thread[ident] += int(n)
    return res, launches, sorted(by_thread.values())


def split_phase():
    """Light, lakes and heavy through driver.run_simulation split over
    split_devices() against their one-device runs; heavy's CLOSE_ENERGY
    passes, node sweeps and the Brent around them voted over the shares
    (vic_tpu_torch/parallel/votes.py)."""
    from vic_tpu_torch import driver, entry, kernels
    from vic_tpu_torch.testing import synthetic_domain, synthetic_forcing
    devs = split_devices()
    phase(f"6 split: {', '.join(SPLIT_CONFIGS)} through "
          f"driver.run_simulation over {devs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print("  " + "; ".join(smi.stdout.strip().splitlines()))
    for config in SPLIT_CONFIGS:
        gp = getattr(entry, f"{config}_params")(SMOKE_RECS)
        gp = gp.replace(snow_step=gp.dt)
        n_cell = CELLS.get(config, SMOKE_CELLS)
        domain = synthetic_domain(n_cell=n_cell, n_band=2,
                                  with_glacier=True)
        forcing = (entry.heavy_forcing if config == "heavy"
                   else synthetic_forcing)(SMOKE_RECS, n_cell,
                                           dt_hours=gp.dt)
        runs = {}
        for label, kw in (("one device", dict(device="cuda:0")),
                          ("split", dict(devices=devs))):
            res, launches, sweeps = split_run(driver, kernels, config, gp,
                                              domain, forcing, kw)
            shares = len(kw.get("devices", ["cuda:0"]))
            print(f"  {config}, {n_cell} cells x {SMOKE_RECS} records of "
                  f"{gp.dt} h, {label} {kw.get('devices', ['cuda:0'])}: "
                  f"{res.cell_steps_per_s:.1f} cell-steps/s (run "
                  f"{res.elapsed_s:.3f} s), peak device memory "
                  f"{res.peak_device_bytes} bytes (the largest device's); "
                  f"kernel launches, every device together: {launches}")
            idle = [k for k, v in launches.items() if v == 0]
            if idle:
                raise AssertionError(f"{config} {label}: kernels never "
                                     f"launched: {idle}")
            werr_cell = np.abs(res.outputs["OUT_WATER_ERROR"]).max(0)
            if config == "heavy":
                passes = [int(x) for x in
                          res.outputs["OUT_TCANOPY_ITER"][:, 0]]
                print(f"  CLOSE_ENERGY passes per record {passes}; K7's "
                      f"sweeps over the run, each host thread's: {sweeps}")
                # one K9 launch a pass and one final update a record, on
                # every share: each share took every pass
                expect_launches(config, launches,
                                canopy_air_step=shares * sum(passes),
                                canopy_air_final=shares * SMOKE_RECS)
                if len(sweeps) != shares or len(set(sweeps)) != 1:
                    raise AssertionError(f"{config} {label}: the shares "
                                         f"swept apart: {sweeps}")
                runs.setdefault("sweeps", []).append(sweeps[0])
                # vic_tpu's DIST_PRCP closure leaves ~0.1 mm on the raining
                # warm cells (ROADMAP.md queue 3): only the cold ones held
                werr_cell = werr_cell[1::2]
            werr = float(werr_cell.max())
            if not werr <= WATER_TOL:
                raise AssertionError(f"{config} {label}: water balance "
                                     f"error {werr} mm")
            runs[label] = res
        if runs["split"].final_state.swq.shape[0] != n_cell:
            raise AssertionError("the split run's state lacks cells")
        if len(set(runs.get("sweeps", [0]))) != 1:
            raise AssertionError(f"{config}: K7 swept {runs['sweeps']} times "
                                 "on one device and on each share")
        worst, failed = split_outside(runs["one device"], runs["split"])
        print(f"  {config}: largest |difference| of the split run from the "
              f"one-device run {worst:.4g} over every output and state "
              f"field; outside rtol=atol={SPLIT_TOL} ({SPLIT_ERROR_ATOL} on "
              f"OUT_*_ERROR): {failed}")
        if failed:
            raise AssertionError(f"{config}: the split run differs from the "
                                 f"one-device run: {failed}")


def main():
    device = device_phase()
    regs = build_phase()
    results = kernels_phase(device, regs)
    for name, err in nan_profile_checks(device).items():
        row = results[f"{name}/exp_trans_10"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
    for row, err in nan_terms_checks(device).items():
        results[row]["max_abs_err"] = max(results[row]["max_abs_err"], err)
    ref_werr = {config: reference_phase(device, config)
                for config in CONFIG_NAMES}
    launches = {config: slice_phase(device, config, ref_werr[config])
                for config in CONFIG_NAMES}
    for nnode in NODE_COUNTS:
        launches[step_label("frozen_exp", nnode)] = slice_phase(
            device, "frozen_exp", nnode=nnode)
    for config in NAN_SLICES:
        for name, err in nan_slice_phase(device, config).items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
    driver_phase(device)
    split_phase()
    # each row's count from the slice of the path its arguments came from
    for row, (name, config, nnode) in ROWS.items():
        results[row]["launches"] = launches[step_label(config, nnode)][name]
    print(json.dumps({"kernels": [results[row] for row in ROWS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
