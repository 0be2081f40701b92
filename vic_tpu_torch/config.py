"""Run configuration of the port.

A copy of `GlobalParams` (and the `ForcingInput` its `forcing` field
defaults to) from `vic_tpu/config.py:1-220`, field for field and default
for default, so that the port imports nothing of the JAX package. Every
runtime option of the reference's global-parameter file is a typed field
(defaults: initialize_global.c:48-150); options are static Python values
that select which branches the step takes. The global-file parser is not
ported yet; its `snow_step <= dt` clamp is applied on construction.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .constants import (AeroResist, Baseflow, ForceFormat, GroundFlux,
                        LWCloud, LWType, RainSnowMethod, SnowAlbedo,
                        SnowDensity, VPIter)


@dataclass
class ForcingInput:
    """One forcing file group (FORCING1/FORCING2)."""
    prefix: str = ""
    format: ForceFormat = ForceFormat.ASCII
    endian: str = "LITTLE"
    dt: int = 24                       # forcing time step, hours (FORCE_DT)
    n_types: int = 0
    # per supplied variable: (name, sign/format, multiplier, netcdf_name)
    types: list = field(default_factory=list)
    year: int = 0                      # FORCEYEAR
    month: int = 1
    day: int = 1
    hour: int = 0


@dataclass
class GlobalParams:
    # ----- simulation span (get_global_param.c TIME keywords) -----
    dt: int = 24                       # model step, hours (TIME_STEP)
    snow_step: int = 1                 # SNOW_STEP sub-step, hours
    startyear: int = 0
    startmonth: int = 1
    startday: int = 1
    starthour: int = 0
    endyear: int = 0
    endmonth: int = 12
    endday: int = 31
    nrecs: int = -1                    # derived if end date given
    skipyear: int = 0                  # output skip years (SKIPYEAR)

    # ----- grid/layers -----
    nlayer: int = 3                    # Nlayer
    nnode: int = 3                     # Nnode (thermal nodes)
    grid_decimal: int = 2
    snow_band: int = 1                 # number of elevation bands
    root_zones: int = -1
    equal_area: bool = False
    resolution: float = 0.0

    # ----- physics toggles -----
    full_energy: bool = False
    frozen_soil: bool = False
    quick_flux: bool = True
    quick_solve: bool = False
    implicit: bool = False
    exp_trans: bool = False
    noflux: bool = False
    tfallback: bool = True
    snow_albedo: SnowAlbedo = SnowAlbedo.USACE
    snow_density: SnowDensity = SnowDensity.DENS_BRAS
    blowing: bool = False
    dist_prcp: bool = False
    prec_expt: float = 0.6
    corrprec: bool = False
    compute_treeline: bool = False
    above_treeline_veg: int = -1
    july_tavg_supplied: bool = False
    lakes: bool = False
    lake_profile: bool = False
    min_wind_speed: float = 0.0
    mtclim_swe_corr: bool = True
    plapse: bool = True
    sw_prec_thresh: float = 0.0
    vp_iter: VPIter = VPIter.VP_ITER_ALWAYS
    vp_interp: bool = True
    lw_type: LWType = LWType.LW_TVA
    lw_cloud: LWCloud = LWCloud.LW_CLOUD_DEARDORFF
    aero_resist_cansnow: AeroResist = AeroResist.AR_406_FULL
    grnd_flux_type: GroundFlux = GroundFlux.GF_410
    temp_th_type: RainSnowMethod = RainSnowMethod.KIENZLE
    baseflow: Baseflow = Baseflow.ARNO
    organic_fract: bool = False
    vegparam_lai: bool = False
    lai_src: int = 0                   # LAI_FROM_VEGLIB
    close_energy: bool = False         # reference compile-time CLOSE_ENERGY
    spatial_frost: bool = False        # reference compile-time SPATIAL_FROST
    frost_subareas: int = 10           # FROST_SUBAREAS (user_def.h)
    frost_slope: float = 2.0           # frost-distribution spread (C)
    spatial_snow: bool = False

    # ----- glacier (PCIC extension) -----
    glacier_id: int = -1
    glacier_dynamics: bool = False
    glacier_accum_start_year: int = 0
    glacier_accum_start_month: int = 1
    glacier_accum_start_day: int = 1
    glacier_accum_interval: int = 1    # years
    num_gmb_terms: int = 4

    # ----- forcing -----
    forcing: list = field(default_factory=lambda: [ForcingInput(),
                                                   ForcingInput()])
    grid_start_lat: float = 0.0
    grid_start_lon: float = 0.0
    grid_step_lat: float = 0.0
    grid_step_lon: float = 0.0
    output_force: bool = False         # disaggregation-only mode
    disagg_write_chunk_size: int = 1000

    # ----- file paths -----
    soil_file: str = ""
    arc_soil: bool = False
    veg_file: str = ""
    veglib_file: str = ""
    snowband_file: str = ""
    lakeparam_file: str = ""
    result_dir: str = "."

    # ----- output -----
    out_step: int = 0                  # output interval, hours (0 => = dt)
    alma_input: bool = False
    alma_output: bool = False
    moistfract: bool = False
    output_format: str = "ASCII"       # ASCII | BINARY | NETCDF
    netcdf_output_filename: str = "results.nc"
    output_shards: int = 0
    netcdf_attributes: dict = field(default_factory=dict)
    compress: bool = False
    prt_header: bool = False
    prt_snow_band: bool = False
    outfiles: list = field(default_factory=list)
    outvar_specs: dict = field(default_factory=dict)

    # ----- state -----
    init_state: bool = False
    init_state_file: str = ""
    save_state: bool = False
    state_name: str = ""
    state_format: str = "ASCII"        # ASCII | BINARY | NETCDF
    stateyear: int = 0
    statemonth: int = 0
    stateday: int = 0

    # ----- runtime -----
    parallel_threads: int = 1
    max_memory: float = 0.0
    continue_on_error: bool = False
    max_cells: int = -1                # cap number of cells read (debug)
    cell_chunk: int = 0                # max cells per call (0 = all)

    # ----- numerics (not in the reference grammar) -----
    brent_maxiter: int = 60            # iteration budget of every Brent
    # explicit node-sweep budget (reference MAXIT=1000, tol 1e-2, then
    # TFALLBACK-revert, frozen_soil.c:380,486)
    soil_sweep_maxiter: int = 10
    # QUICK_FLUX FALSE + CLOSE_ENERGY: affine two-probe node profile in the
    # intermediate Tcanopy passes' surface Brent (inert without
    # CLOSE_ENERGY)
    fd_affine_residual: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        # get_global_param.c: SNOW_STEP never exceeds the model step
        if self.snow_step > self.dt:
            self.snow_step = self.dt

    @property
    def nf(self) -> int:
        """Number of snow sub-steps per model step."""
        return max(1, self.dt // self.snow_step)

    @property
    def nr(self) -> int:
        """Index of the model-step-mean forcing slot
        (get_global_param.c:969-973)."""
        return 0 if self.nf == 1 else self.nf

    def replace(self, **kw) -> "GlobalParams":
        return dataclasses.replace(self, **kw)
