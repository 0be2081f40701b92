"""Soil parameter file reader.

A copy of `vic_tpu/io/soil.py`. Parses the reference's one-line-per-cell
soil text format (read_soilparam.c:21-75 column list) into `SoilParams`,
applying every derived-quantity computation of read_soilparam.c:890-1245.
Supports both the legacy column set and the PCIC glacier format's 18 extra
columns (GLACIER_SOIL_FILE_FORMAT).
"""
from __future__ import annotations

import numpy as np

from .. import constants as c
from ..params import SoilParams

# glacier-format extra columns in file order (read_soilparam.c:726-883)
GLACIER_COLS = (
    "new_snow_alb", "snow_alb_accum_a", "snow_alb_accum_b", "snow_alb_thaw_a",
    "snow_alb_thaw_b", "min_rain_temp", "max_snow_temp", "padj_r", "padj_s",
    "t_lapse", "pgrad", "glac_surf_thick", "glac_surf_we", "glac_kmin",
    "glac_dk", "glac_a", "glac_albedo", "glac_rough",
)

# defaults used in legacy (non-glacier) soil format (read_soilparam.c:695-712)
GLACIER_DEFAULTS = {
    "new_snow_alb": 0.85, "snow_alb_accum_a": 0.94, "snow_alb_accum_b": 0.58,
    "snow_alb_thaw_a": 0.82, "snow_alb_thaw_b": 0.46,
    "min_rain_temp": 1.0, "max_snow_temp": 10.0, "padj_r": 1.0, "padj_s": 1.0,
    "t_lapse": 6.5, "pgrad": 0.0, "glac_surf_thick": 100.0, "glac_surf_we": 91.7,
    "glac_kmin": 0.01, "glac_dk": 0.24, "glac_a": 20.0, "glac_albedo": 0.3,
    "glac_rough": 0.002,
}


def great_circle_km(lat1, lon1, lat2, lon2):
    """Distance in km (reference get_dist.c haversine on radius 6371.228 km)."""
    R = 6371.228
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dl = np.radians(lon2 - lon1)
    dp = p2 - p1
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * R * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def cell_area_m2(lat, lng, resolution):
    """Spherical quadrilateral area via the reference's 10-strip integration
    (read_soilparam.c:1090-1111)."""
    lat, lng = abs(lat), abs(lng)
    start_lat = lat - resolution / 2
    right_lng = lng + resolution / 2
    left_lng = lng - resolution / 2
    delta = great_circle_km(lat, lng, lat + resolution / 10.0, lng)
    dist = 0.0
    for _ in range(10):
        dist += great_circle_km(start_lat, left_lng, start_lat, right_lng) * delta
        start_lat += resolution / 10.0
    return dist * 1000.0 * 1000.0


def read_soil_file(path: str, gp, glacier_format: bool = True,
                   max_cells: int = -1) -> SoilParams:
    """Read a soil parameter file into SoilParams.

    gp: GlobalParams (needs nlayer, organic_fract, july_tavg_supplied, baseflow,
    init_state, equal_area, resolution).
    """
    nl = gp.nlayer
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            # leading run-cell flag (read_soilparam.c:203: first int column is a
            # 0/1 run flag in the PCIC format when present as separate token)
            rows.append([float(t) for t in toks])
            if max_cells > 0 and len(rows) >= max_cells:
                break
    if not rows:
        raise ValueError(f"no soil cells in {path}")

    out = {k: [] for k in (
        "gridcel lat lng b_infilt ds dsmax ws c_expt expt ksat phi_s init_moist "
        "elevation depth avg_temp dp bubble quartz organic bulk_density "
        "soil_density off_gmt wcr_fract wpwp_fract rough snow_rough annual_prec "
        "resid_moist fs_active avg_july_air_temp").split()}
    for k in GLACIER_COLS:
        out[k] = []

    for row in rows:
        it = iter(row)
        nxt = lambda: next(it)
        runflag = int(nxt())          # leading RUN_MODEL flag (vicNl.c soil line)
        if not runflag:
            # cell excluded from run; reference skips the line entirely
            continue
        out["gridcel"].append(nxt())
        out["lat"].append(nxt())
        out["lng"].append(nxt())
        out["b_infilt"].append(nxt())
        out["ds"].append(nxt())
        out["dsmax"].append(nxt())
        out["ws"].append(nxt())
        out["c_expt"].append(nxt())
        out["expt"].append([nxt() for _ in range(nl)])
        out["ksat"].append([nxt() for _ in range(nl)])
        out["phi_s"].append([nxt() for _ in range(nl)])
        out["init_moist"].append([nxt() for _ in range(nl)])
        out["elevation"].append(nxt())
        out["depth"].append([nxt() for _ in range(nl)])
        out["avg_temp"].append(nxt())
        out["dp"].append(nxt())
        out["bubble"].append([nxt() for _ in range(nl)])
        out["quartz"].append([nxt() for _ in range(nl)])
        bulk_dens_min = [nxt() for _ in range(nl)]
        soil_dens_min = [nxt() for _ in range(nl)]
        if gp.organic_fract:
            organic = [nxt() for _ in range(nl)]
            bulk_dens_org = [nxt() for _ in range(nl)]
            soil_dens_org = [nxt() for _ in range(nl)]
        else:
            organic = [0.0] * nl
            bulk_dens_org = [0.0] * nl
            soil_dens_org = [0.0] * nl
        # combined densities (read_soilparam.c:895-897)
        out["organic"].append(organic)
        out["bulk_density"].append(
            [(1 - o) * bm + o * bo
             for o, bm, bo in zip(organic, bulk_dens_min, bulk_dens_org)])
        out["soil_density"].append(
            [(1 - o) * sm + o * so
             for o, sm, so in zip(organic, soil_dens_min, soil_dens_org)])
        # soil file stores off_gmt in HOURS; convert to time_zone_lng in
        # degrees of longitude at read time (read_soilparam.c:564,1121:
        # time_zone_lng = off_gmt * 360./24.)
        out["off_gmt"].append(nxt() * 360.0 / 24.0)
        out["wcr_fract"].append([nxt() for _ in range(nl)])
        out["wpwp_fract"].append([nxt() for _ in range(nl)])
        out["rough"].append(nxt())
        out["snow_rough"].append(nxt())
        out["annual_prec"].append(nxt())
        out["resid_moist"].append([nxt() for _ in range(nl)])
        out["fs_active"].append(nxt())
        if gp.july_tavg_supplied:
            out["avg_july_air_temp"].append(nxt())
        else:
            out["avg_july_air_temp"].append(np.nan)
        if glacier_format:
            remaining = list(it)
            if len(remaining) >= len(GLACIER_COLS):
                for k, v in zip(GLACIER_COLS, remaining):
                    out[k].append(v)
            else:
                for k in GLACIER_COLS:
                    out[k].append(GLACIER_DEFAULTS[k])
        else:
            for k in GLACIER_COLS:
                out[k].append(GLACIER_DEFAULTS[k])

    return build_soil_params(out, gp)


def build_soil_params(cols: dict, gp) -> SoilParams:
    """Derived-quantity computation (read_soilparam.c:890-1111)."""
    f = lambda k: np.asarray(cols[k], np.float64)
    nl = gp.nlayer

    organic = f("organic")
    bulk_density = f("bulk_density")
    soil_density = f("soil_density")
    resid_moist = f("resid_moist")
    depth = f("depth")
    init_moist = f("init_moist")

    porosity = 1.0 - bulk_density / soil_density
    max_moist = depth * porosity * 1000.0

    if not gp.init_state:
        init_moist = np.minimum(init_moist, max_moist)
        init_moist = np.maximum(init_moist, resid_moist * depth * 1000.0)

    b_infilt = f("b_infilt")
    if nl == 2:
        max_infil = (1.0 + b_infilt) * max_moist[:, 0]
    else:
        max_infil = (1.0 + b_infilt) * (max_moist[:, 0] + max_moist[:, 1])

    wcr = f("wcr_fract") * max_moist
    wpwp = f("wpwp_fract") * max_moist

    ds, dsmax, ws, c_expt = f("ds"), f("dsmax"), f("ws"), f("c_expt")
    from ..constants import Baseflow
    if gp.baseflow == Baseflow.NIJSSEN2001:
        # NIJSSEN2001 (d1..d4) -> ARNO conversion (read_soilparam.c:1077-1081)
        mm = max_moist[:, nl - 1]
        dsmax_new = dsmax * np.power(1.0 / (mm - ws), -c_expt) + ds * mm
        ds_new = ds * ws / dsmax_new
        ws_new = ws / mm
        ds, dsmax, ws = ds_new, dsmax_new, ws_new

    lat, lng = f("lat"), f("lng")
    if gp.equal_area:
        cell_area = np.full_like(lat, gp.resolution * 1000.0 * 1000.0)
    elif gp.resolution > 0:
        cell_area = np.array([cell_area_m2(la, lo, gp.resolution)
                              for la, lo in zip(lat, lng)])
    else:
        cell_area = np.ones_like(lat)

    return SoilParams(
        lat=lat, lng=lng, gridcel=f("gridcel").astype(np.int32),
        b_infilt=b_infilt, ds=ds, dsmax=dsmax, ws=ws, c_expt=c_expt,
        expt=f("expt"), ksat=f("ksat"), phi_s=f("phi_s"), init_moist=init_moist,
        elevation=f("elevation"), depth=depth, avg_temp=f("avg_temp"), dp=f("dp"),
        bubble=f("bubble"), quartz=f("quartz"), organic=organic,
        bulk_density=bulk_density, soil_density=soil_density,
        off_gmt=f("off_gmt"), rough=f("rough"), snow_rough=f("snow_rough"),
        annual_prec=f("annual_prec"), resid_moist=resid_moist,
        fs_active=f("fs_active").astype(bool),
        avg_july_air_temp=f("avg_july_air_temp"),
        porosity=porosity, max_moist=max_moist, max_infil=max_infil,
        wcr=wcr, wpwp=wpwp, cell_area=cell_area,
        new_snow_alb=f("new_snow_alb"),
        snow_alb_accum_a=f("snow_alb_accum_a"),
        snow_alb_accum_b=f("snow_alb_accum_b"),
        snow_alb_thaw_a=f("snow_alb_thaw_a"),
        snow_alb_thaw_b=f("snow_alb_thaw_b"),
        min_rain_temp=f("min_rain_temp"), max_snow_temp=f("max_snow_temp"),
        padj_r=f("padj_r"), padj_s=f("padj_s"),
        t_lapse=f("t_lapse"), pgrad=f("pgrad"),
        glac_surf_thick=f("glac_surf_thick"), glac_surf_we=f("glac_surf_we"),
        glac_kmin=f("glac_kmin"), glac_dk=f("glac_dk"), glac_a=f("glac_a"),
        glac_albedo=f("glac_albedo"), glac_rough=f("glac_rough"),
        depth_full_snow_cover=np.full_like(lat, 0.1),
    )
