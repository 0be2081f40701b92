"""Physical constants and option enums of the port.

A copy of `vic_tpu/constants.py`, name for name and value for value
(tests/test_torch_params.py holds the two together), so that the port
imports nothing of the JAX package. Values mirror the reference model's
constant block (vicNl_def.h:138-317); option codes are IntEnums;
compile-time array caps are module constants that size the dense state
arrays.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Sentinels (vicNl_def.h:141-150)
# ---------------------------------------------------------------------------
HUGE_RESIST = 1.0e20
SPVAL = 1.0e20
SMALL = 1.0e-12
ERROR_CODE = -999.0

# ---------------------------------------------------------------------------
# Time (vicNl_def.h:243-247)
# ---------------------------------------------------------------------------
DAYS_PER_YEAR = 365.0
HOURS_PER_DAY = 24
SEC_PER_HOUR = 3600.0
SEC_PER_DAY = 86400.0

# ---------------------------------------------------------------------------
# Physical constants (vicNl_def.h:250-283)
# ---------------------------------------------------------------------------
RESID_MOIST = 0.0          # residual moisture content of soil column
ICE_DENSITY = 917.0        # density of ice (kg/m^3)
VON_K = 0.40               # Von Karman constant
KELVIN = 273.15            # C -> K offset
STEFAN_B = 5.6696e-8       # Stefan-Boltzmann (W/m^2/K^4)
LF = 3.337e5               # latent heat of fusion (J/kg) at 0 C
RHO_W = 999.842594         # density of water (kg/m^3) at 0 C
CP = 1013.0                # specific heat of moist air (J/kg/K)
CH_ICE = 2100.0e3          # volumetric heat capacity of ice (J/m^3/C)
CH_WATER = 4186.8e3        # volumetric heat capacity of water (J/m^3/C)
K_SNOW = 2.9302e-6         # snow conductivity coefficient (W/mK, used as f(rho))
SOLAR_CONSTANT = 1400.0    # W/m^2
EPS_RATIO = 0.62196351     # M_water_vapor / M_dry_air
G = 9.81                   # gravity (m/s^2)
RD = 287.0                 # gas constant of dry air (J/kg/K)
JOULES_PER_CAL = 4.1868
GRAMS_PER_KG = 1000.0
KPA_TO_PA = 1000.0
D_TO_R = 0.017453293       # degrees to radians (reference value, not math.pi-derived)
PI = 3.1415927

# Glacier constants (vicNl_def.h:278-283)
GLAC_TEMP = 0.0            # temperature of glacier ice body (C)
GLAC_K_ICE = 2.14          # thermal conductivity of glacier ice (W/mK)
SNOW_SURF_DENSITY = 350.0
CUTOFF_DENSITY = 830.0

# Saturated-vapor-pressure curve constants (kPa) (vicNl_def.h:286-288)
A_SVP = 0.61078
B_SVP = 17.269
C_SVP = 237.3

# Penman constants (vicNl_def.h:291-293)
CP_PM = 1013.0             # specific heat of moist air (J/kg/C)
PS_PM = 101300.0           # sea-level pressure (Pa)
LAPSE_PM = -0.006          # environmental lapse rate (C/m)

# Physical constraints (vicNl_def.h:296-302)
MIN_SOIL_DEPTH = 0.001     # minimum soil layer depth (m)
STORM_THRES = 0.001        # precip threshold declaring a new storm (mm)
SNOW_DT = 5.0              # snow surface T bracket (C)
SURF_DT = 1.0              # soil surface T bracket (C)
SOIL_DT = 0.25             # soil node T bracket (C)
CANOPY_DT = 1.0            # canopy air T bracket (C)
CANOPY_VP = 25.0           # canopy vapor-pressure bracket (Pa)

# Hard-coded veg/surface parameters (vicNl_def.h:228-233)
BARE_SOIL_ALBEDO = 0.2
H2O_SURF_ALBEDO = 0.08
COEF_DRAG = 0.2

# Snow defaults (reference snow.h)
NEW_SNOW_DENSITY = 50.0    # density of fresh snow (kg/m^3)
SNOW_LIQUID_WATER_CAPACITY = 0.035  # LIQUID_WATER_CAPACITY: holding fraction of SWE
LAI_SNOW_MULTIPLIER = 0.0005        # canopy snow interception capacity per LAI (m)
MIN_INTERCEPTION_STORAGE = 0.005    # canopy snow that can only melt off (m)
MAX_SURFACE_SWE = 0.125    # max SWE of snow surface layer (m)
SNDENS_DMLIMIT = 100.0     # density limit for destructive metamorphism (kg/m^3)
SNDENS_ETA0 = 3.6e6        # snow viscosity at T=0, rho=0 (Ns/m^2)
SNDENS_C1 = 0.04
SNDENS_C2 = 2.778e-6
SNDENS_C5 = 0.08
SNDENS_C6 = 0.021
SNDENS_F = 0.6
MIN_SWQ_EB_THRES = 0.0010  # min SWQ (m) for independent snowpack energy balance
SNOW_A1, SNOW_A2 = 0.7, 0.3        # SW attenuation partition in snowpack
SNOW_L1, SNOW_L2 = 6.0, 20.0       # SW attenuation coefficients (1/m)
TRACESNOW = 0.03           # minimum new snow (mm) that resets albedo
# Default new-snow albedo / decay params (read_soilparam.c:695 PCIC per-cell defaults)
SNOW_NEW_SNOW_ALB = 0.85
SNOW_ALB_ACCUM_A = 0.94
SNOW_ALB_ACCUM_B = 0.58
SNOW_ALB_THAW_A = 0.82
SNOW_ALB_THAW_B = 0.46

# Default glacier reservoir parameters (vicNl_def.h:993-995 / read_soilparam.c:69-71)
GLAC_KMIN_DEFAULT = 0.05
GLAC_DK_DEFAULT = 0.45
GLAC_A_DEFAULT = 0.000004
GLAC_SURF_THICK = 200.0    # glacier surface-layer water equivalent (mm) for cold content

# Array capacity caps (user_def.h:110-133) — these size static dense arrays.
MAX_LAYERS = 3
MAX_NODES = 50
MAX_BANDS = 30
MAX_FRONTS = 3
MAX_LAKE_NODES = 20
MAXIT_FE = 25
# CLOSE_ENERGY canopy-air iteration (surface_fluxes.c:8-15: MAX_ITER=250 when
# CLOSE_ENERGY, 0 otherwise; OVER_TOL=0.001). The batched fixed point
# converges in a handful of damped passes; 25 bounds the while_loop.
CLOSE_ENERGY_MAXITER = 25
OVER_TOL = 0.001

# Default lapse rates (vicNl_def.h / read_snowband.c)
T_LAPSE = 6.5              # C per 1000 m, used for snow-band temperature adjustment

# Minimum wind speed
MIN_WIND_SPEED = 0.1       # reference: calc of aerodynamic resistance guards vs 0 wind


# ---------------------------------------------------------------------------
# Option enums (vicNl_def.h:162-226)
# ---------------------------------------------------------------------------
class ForceFormat(enum.IntEnum):
    ASCII = 1
    BINARY = 2
    NETCDF = 3


class SnowAlbedo(enum.IntEnum):
    USACE = 0
    SUN1999 = 1


class SnowDensity(enum.IntEnum):
    DENS_BRAS = 0
    DENS_SNTHRM = 1


class Baseflow(enum.IntEnum):
    ARNO = 0
    NIJSSEN2001 = 1


class AeroResist(enum.IntEnum):
    AR_406 = 0
    AR_406_LS = 1
    AR_406_FULL = 2
    AR_410 = 3
    AR_COMBO = 4


class GroundFlux(enum.IntEnum):
    GF_406 = 0
    GF_410 = 1
    GF_FULL = 2


class VPIter(enum.IntEnum):
    VP_ITER_NONE = 0
    VP_ITER_ALWAYS = 1
    VP_ITER_ANNUAL = 2
    VP_ITER_CONVERGE = 3


class LWType(enum.IntEnum):
    LW_TVA = 0
    LW_ANDERSON = 1
    LW_BRUTSAERT = 2
    LW_SATTERLUND = 3
    LW_IDSO = 4
    LW_PRATA = 5


class LWCloud(enum.IntEnum):
    LW_CLOUD_BRAS = 0
    LW_CLOUD_DEARDORFF = 1


class RainSnowMethod(enum.IntEnum):
    VIC_412 = 0
    KIENZLE = 1


# Potential-evap reference surfaces (vicNl_def.h:212-221, global.h:49-62)
N_PET_TYPES = 6
PET_SATSOIL = 0
PET_H2OSURF = 1
PET_SHORT = 2
PET_TALL = 3
PET_NATVEG = 4
PET_VEGNOCR = 5

# Reference-surface parameters for PET (global.h:49-62)
REF_VEG_OVER = (False, False, False, False)
REF_VEG_RARC = (0.0, 0.0, 25.0, 25.0)
REF_VEG_RMIN = (0.0, 0.0, 100.0, 100.0)
REF_VEG_LAI = (1.0, 1.0, 2.88, 4.45)
REF_VEG_ALBEDO = (BARE_SOIL_ALBEDO, H2O_SURF_ALBEDO, 0.23, 0.23)
REF_VEG_ROUGH = (0.001, 0.001, 0.0148, 0.0615)
REF_VEG_DISPL = (0.0054, 0.0054, 0.08, 0.3333)
REF_VEG_WIND_H = (10.0, 10.0, 10.0, 10.0)
REF_VEG_RGL = (0.0, 0.0, 100.0, 100.0)
REF_VEG_RAD_ATTEN = (0.0, 0.0, 0.0, 0.0)
REF_VEG_WIND_ATTEN = (0.0, 0.0, 0.0, 0.0)
REF_VEG_TRUNK_RATIO = (0.0, 0.0, 0.0, 0.0)
REF_VEG_REF_CROP = (False, False, True, True, False, False)
