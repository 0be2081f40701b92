"""Run configuration of the port.

A copy of `vic_tpu/config.py`: `GlobalParams` (and the `ForcingInput` its
`forcing` field defaults to, the OUTFILE/OUTVAR specs) field for field and
default for default, and `parse_global_param_file`, so that the port
imports nothing of the JAX package. Every runtime option of the
reference's global-parameter file is a typed field (defaults:
initialize_global.c:48-150); options are static Python values that select
which branches the step takes. The parser's `snow_step <= dt` clamp is also
applied on construction.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from .constants import (AeroResist, Baseflow, ForceFormat, GroundFlux,
                        LWCloud, LWType, RainSnowMethod, SnowAlbedo,
                        SnowDensity, VPIter)


# Forcing variable names accepted in FORCE_TYPE sections
# (vicNl_def.h:321-349, 24 forcing types).
FORCING_TYPES = (
    "AIR_TEMP", "ALBEDO", "CHANNEL_IN", "CRAINF", "CSNOWF", "DENSITY", "LONGWAVE",
    "LSRAINF", "LSSNOWF", "PREC", "PRESSURE", "QAIR", "RAINF", "REL_HUMID",
    "SHORTWAVE", "SNOWF", "TMAX", "TMIN", "TSKC", "VP", "WIND", "WIND_E", "WIND_N",
    "SKIP",
)


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
class OutVarSpec:
    name: str
    format: str = "*"
    type: str = "*"
    multiplier: float = 1.0


@dataclass
class OutFileSpec:
    prefix: str
    nvars: int = 0
    varnames: list = field(default_factory=list)


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


_BOOL_KEYS = {
    "FULL_ENERGY": "full_energy", "FROZEN_SOIL": "frozen_soil",
    "QUICK_FLUX": "quick_flux", "QUICK_SOLVE": "quick_solve",
    "IMPLICIT": "implicit", "EXP_TRANS": "exp_trans", "NOFLUX": "noflux",
    "TFALLBACK": "tfallback", "BLOWING": "blowing", "DIST_PRCP": "dist_prcp",
    "CORRPREC": "corrprec", "COMPUTE_TREELINE": "_compute_treeline_special",
    "LAKES": "_lakes_special", "LAKE_PROFILE": "lake_profile",
    "MTCLIM_SWE_CORR": "mtclim_swe_corr", "PLAPSE": "plapse",
    "VP_INTERP": "vp_interp", "EQUAL_AREA": "equal_area",
    "ORGANIC_FRACT": "organic_fract", "CONTINUEONERROR": "continue_on_error",
    "GLACIER_DYNAMICS": "glacier_dynamics", "OUTPUT_FORCE": "output_force",
    "ALMA_INPUT": "alma_input", "ALMA_OUTPUT": "alma_output",
    "MOISTFRACT": "moistfract", "COMPRESS": "compress",
    "PRT_HEADER": "prt_header", "PRT_SNOW_BAND": "prt_snow_band",
    "JULY_TAVG_SUPPLIED": "july_tavg_supplied", "ARC_SOIL": "arc_soil",
    "CLOSE_ENERGY": "close_energy",
    "FD_AFFINE_RESIDUAL": "fd_affine_residual",
}

_INT_KEYS = {
    "TIME_STEP": "dt", "SNOW_STEP": "snow_step",
    "STARTYEAR": "startyear", "STARTMONTH": "startmonth", "STARTDAY": "startday",
    "STARTHOUR": "starthour", "ENDYEAR": "endyear", "ENDMONTH": "endmonth",
    "ENDDAY": "endday", "NRECS": "nrecs", "SKIPYEAR": "skipyear",
    "NLAYER": "nlayer", "NODES": "nnode", "GRID_DECIMAL": "grid_decimal",
    "SNOW_BAND": "_snow_band_special", "ROOT_ZONES": "root_zones",
    "GLACIER_ID": "glacier_id",
    "GLACIER_ACCUM_START_YEAR": "glacier_accum_start_year",
    "GLACIER_ACCUM_START_MONTH": "glacier_accum_start_month",
    "GLACIER_ACCUM_START_DAY": "glacier_accum_start_day",
    "GLACIER_ACCUM_INTERVAL": "glacier_accum_interval",
    "OUT_STEP": "out_step", "STATEYEAR": "stateyear", "STATEMONTH": "statemonth",
    "STATEDAY": "stateday", "PARALLEL_THREADS": "parallel_threads",
    "DISAGG_WRITE_CHUNK_SIZE": "disagg_write_chunk_size",
    "MAX_CELLS": "max_cells", "CELL_CHUNK": "cell_chunk",
}

_FLOAT_KEYS = {
    "PREC_EXPT": "prec_expt", "MIN_WIND_SPEED": "min_wind_speed",
    "SW_PREC_THRESH": "sw_prec_thresh", "RESOLUTION": "resolution",
    "MAX_MEMORY": "max_memory",
}

_STR_KEYS = {
    "SOIL": "soil_file", "VEGPARAM": "veg_file", "VEGLIB": "veglib_file",
    "SNOW_BAND_FILE": "snowband_file", "LAKES_FILE": "lakeparam_file",
    "RESULT_DIR": "result_dir", "NETCDF_OUTPUT_FILENAME": "netcdf_output_filename",
    "NETCDF_OUTPUT_SHARDS": "output_shards",
    "INIT_STATE_FILE": "init_state_file", "STATENAME": "_statename_special",
}

_ENUM_KEYS = {
    "SNOW_ALBEDO": ("snow_albedo", {"USACE": SnowAlbedo.USACE, "SUN1999": SnowAlbedo.SUN1999}),
    "SNOW_DENSITY": ("snow_density", {"DENS_BRAS": SnowDensity.DENS_BRAS,
                                      "DENS_SNTHRM": SnowDensity.DENS_SNTHRM}),
    "BASEFLOW": ("baseflow", {"ARNO": Baseflow.ARNO, "NIJSSEN2001": Baseflow.NIJSSEN2001}),
    "AERO_RESIST_CANSNOW": ("aero_resist_cansnow", {
        "AR_406": AeroResist.AR_406, "AR_406_LS": AeroResist.AR_406_LS,
        "AR_406_FULL": AeroResist.AR_406_FULL, "AR_410": AeroResist.AR_410,
        "AR_COMBO": AeroResist.AR_COMBO}),
    "GRND_FLUX_TYPE": ("grnd_flux_type", {
        "GF_406": GroundFlux.GF_406, "GF_410": GroundFlux.GF_410,
        "GF_FULL": GroundFlux.GF_FULL}),
    "LW_TYPE": ("lw_type", {
        "LW_TVA": LWType.LW_TVA, "LW_ANDERSON": LWType.LW_ANDERSON,
        "LW_BRUTSAERT": LWType.LW_BRUTSAERT, "LW_SATTERLUND": LWType.LW_SATTERLUND,
        "LW_IDSO": LWType.LW_IDSO, "LW_PRATA": LWType.LW_PRATA}),
    "LW_CLOUD": ("lw_cloud", {"LW_CLOUD_BRAS": LWCloud.LW_CLOUD_BRAS,
                              "LW_CLOUD_DEARDORFF": LWCloud.LW_CLOUD_DEARDORFF}),
    "VP_ITER": ("vp_iter", {
        "VP_ITER_NONE": VPIter.VP_ITER_NONE, "VP_ITER_ALWAYS": VPIter.VP_ITER_ALWAYS,
        "VP_ITER_ANNUAL": VPIter.VP_ITER_ANNUAL,
        "VP_ITER_CONVERGE": VPIter.VP_ITER_CONVERGE}),
    "TEMP_TH_TYPE": ("temp_th_type", {"VIC_412": RainSnowMethod.VIC_412,
                                      "KIENZLE": RainSnowMethod.KIENZLE}),
}

_TRUE = {"TRUE", "YES", "1", "ON"}


def _as_bool(tok: str) -> bool:
    return tok.upper() in _TRUE


def parse_global_param_file(path: str) -> GlobalParams:
    """Parse a reference-format global parameter file into GlobalParams.

    Grammar per the reference's get_global_param.c: one ``KEYWORD value...`` per line,
    '#' comments, case-insensitive keywords, plus sectioned N_OUTFILES/OUTFILE/OUTVAR
    output definitions (parse_output_info.c:8) and FORCE_TYPE blocks attached to the
    most recent FORCING1/FORCING2 keyword.
    """
    gp = GlobalParams()
    cur_force: Optional[int] = None
    cur_outfile: Optional[OutFileSpec] = None

    with open(path) as f:
        lines = f.readlines()

    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # strip trailing inline comments ("SNOW_BAND 1 #comment" — common in
        # reference sample files, whose parser reads only the leading tokens)
        toks = []
        for t in line.split():
            if t.startswith("#"):
                break
            toks.append(t)
        if not toks:
            continue
        key = toks[0].upper()
        args = toks[1:]
        if not args and key not in ():
            continue

        if key in _BOOL_KEYS:
            dest = _BOOL_KEYS[key]
            if dest == "_compute_treeline_special":
                # COMPUTE_TREELINE FALSE | <default veg id>
                if _as_bool(args[0]):
                    gp.compute_treeline = True
                elif args[0].upper() == "FALSE":
                    gp.compute_treeline = False
                else:
                    gp.compute_treeline = True
                    gp.above_treeline_veg = int(args[0])
            elif dest == "_lakes_special":
                # LAKES FALSE | <lake param file path>
                if args[0].upper() == "FALSE":
                    gp.lakes = False
                else:
                    gp.lakes = True
                    gp.lakeparam_file = args[0]
            else:
                setattr(gp, dest, _as_bool(args[0]))
        elif key in _INT_KEYS:
            dest = _INT_KEYS[key]
            if dest == "_snow_band_special":
                # SNOW_BAND <n> [bandfile]
                gp.snow_band = int(args[0])
                if len(args) > 1:
                    gp.snowband_file = args[1]
            else:
                setattr(gp, dest, int(float(args[0])))
        elif key in _FLOAT_KEYS:
            setattr(gp, _FLOAT_KEYS[key], float(args[0]))
        elif key in _STR_KEYS:
            dest = _STR_KEYS[key]
            if dest == "_statename_special":
                gp.state_name = args[0]
                gp.save_state = True
            else:
                setattr(gp, dest, args[0])
        elif key in _ENUM_KEYS:
            dest, mapping = _ENUM_KEYS[key]
            setattr(gp, dest, mapping[args[0].upper()])
        elif key == "INIT_STATE":
            if args and args[0].upper() != "FALSE":
                gp.init_state = True
                gp.init_state_file = args[0]
        elif key == "STATE_FORMAT":
            gp.state_format = _norm_format(args[0])
        elif key == "BINARY_STATE_FILE":
            gp.state_format = "BINARY" if _as_bool(args[0]) else "ASCII"
        elif key == "OUTPUT_FORMAT":
            gp.output_format = _norm_format(args[0])
        elif key == "BINARY_OUTPUT":
            gp.output_format = "BINARY" if _as_bool(args[0]) else "ASCII"
        elif key == "NETCDF_ATTRIBUTE":
            if len(args) >= 2:
                gp.netcdf_attributes[args[0]] = " ".join(args[1:])
        elif key in ("FORCING1", "FORCING2"):
            cur_force = 0 if key == "FORCING1" else 1
            if args[0].upper() != "FALSE":
                gp.forcing[cur_force].prefix = args[0]
        elif key == "FORCE_FORMAT":
            fmt = args[0].upper()
            gp.forcing[cur_force].format = ForceFormat[fmt if fmt != "NETCDF" else "NETCDF"]
        elif key == "FORCE_ENDIAN":
            gp.forcing[cur_force].endian = args[0].upper()
        elif key == "FORCE_DT":
            gp.forcing[cur_force].dt = int(args[0])
        elif key == "N_TYPES":
            gp.forcing[cur_force].n_types = int(args[0])
        elif key == "FORCE_TYPE":
            name = args[0].upper()
            extra = args[1:]
            gp.forcing[cur_force].types.append((name, extra))
        elif key == "FORCEYEAR":
            gp.forcing[cur_force].year = int(args[0])
        elif key == "FORCEMONTH":
            gp.forcing[cur_force].month = int(args[0])
        elif key == "FORCEDAY":
            gp.forcing[cur_force].day = int(args[0])
        elif key == "FORCEHOUR":
            gp.forcing[cur_force].hour = int(args[0])
        elif key == "GRID_START_LAT":
            gp.grid_start_lat = float(args[0])
        elif key == "GRID_START_LON":
            gp.grid_start_lon = float(args[0])
        elif key == "GRID_STEP_LAT":
            gp.grid_step_lat = float(args[0])
        elif key == "GRID_STEP_LON":
            gp.grid_step_lon = float(args[0])
        elif key == "N_OUTFILES":
            gp.outfiles = []
        elif key == "OUTFILE":
            cur_outfile = OutFileSpec(prefix=args[0],
                                      nvars=int(args[1]) if len(args) > 1 else 0)
            gp.outfiles.append(cur_outfile)
        elif key == "OUTVAR":
            name = args[0]
            spec = OutVarSpec(name=name)
            if len(args) > 1:
                spec.format = args[1]
            if len(args) > 2:
                spec.type = args[2]
            if len(args) > 3:
                try:
                    spec.multiplier = float(args[3])
                except ValueError:
                    pass
            gp.outvar_specs[name] = spec
            if cur_outfile is not None:
                cur_outfile.varnames.append(name)
        # unknown keywords are ignored (reference warns and continues)

    if gp.out_step == 0:
        gp.out_step = gp.dt
    if gp.snow_step > gp.dt:
        gp.snow_step = gp.dt
    return gp


def _norm_format(tok: str) -> str:
    t = tok.upper()
    if t in ("NETCDF", "NETCDF_FORMAT"):
        return "NETCDF"
    if t in ("BINARY", "BINARY_FORMAT"):
        return "BINARY"
    return "ASCII"
