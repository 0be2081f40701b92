"""Reference-schema NetCDF model state files: a copy of
`vic_tpu/io/state_netcdf_ref.py` on the port's ModelState.

The reference's StateIONetCDF layout (StateIONetCDF.c:120-534, variable
registry at :400-534, dimension registry at :384-398; per-variable write
order and semantics from write_model_state.c:76-371): a NetCDF-4 file with
per-variable named arrays over (lat, lon[, hru][, dist][, Nlayers|Nnodes])
dimensions, state_* date/shape attributes, and the "institution/contact/
references" attributes its reader verifies (WriteOutputNetCDF.c:99-108
verifyGlobalAttributes).

The batched ModelState lanes scatter straight onto the (lat, lon, hru)
grid; the reference fills the same arrays one HRU at a time through
notifyDimensionUpdate (write_model_state.c:162). Upstream's own lake block
is flagged "FIXME: not a tested code path, and dimensions are not correctly
set" (StateIONetCDF.c:484); it is written here, as in vic_tpu, with the
dimensions as declared. The reader returns CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..state import ModelState
from .state_legacy import _gmb_terms, _hru_veg_id

FROST_SUBAREAS = 10     # user_def.h:78
MAX_LAKE_NODES = 20     # user_def.h:100
NUM_GMB_TERMS = 4       # write_model_state.c:152

FILL_D = -1.0e36        # distinguishable fill for unused HRU slots
FILL_I = -9999


def _grid(soil):
    lats = np.unique(np.asarray(soil.lat, float))
    lons = np.unique(np.asarray(soil.lng, float))
    li = np.searchsorted(lats, np.asarray(soil.lat, float))
    lo = np.searchsorted(lons, np.asarray(soil.lng, float))
    return lats, lons, li, lo


def _meta(nl, nn, max_hru, ndist):
    """(name, extra-dims, dtype) per StateIONetCDF.c:400-481. All variables
    are additionally indexed by (lat, lon)."""
    D, I = np.float64, np.int32
    return [
        ("GRID_CELL", (), I),
        ("NUM_BANDS", (), I),
        ("VEG_TYPE_NUM", (), I),
        ("GLAC_MASS_BALANCE_EQN_TERMS", ("NgmbTerms",), D),
        ("SOIL_DZ_NODE", ("Nnodes",), D),
        ("SOIL_ZSUM_NODE", ("Nnodes",), D),
        ("HRU_BAND_INDEX", ("hru",), I),
        ("HRU_VEG_INDEX", ("hru",), I),
        ("LAYER_ICE_CONTENT", ("hru", "dist", "Nlayers"), D),
        ("LAYER_MOIST", ("hru", "dist", "Nlayers"), D),
        ("HRU_VEG_VAR_WDEW", ("hru", "dist"), D),
        ("SNOW_CANOPY", ("hru",), D),
        ("SNOW_DENSITY", ("hru",), D),
        ("SNOW_DEPTH", ("hru",), D),
        ("SNOW_PACK_WATER", ("hru",), D),
        ("SNOW_SURF_WATER", ("hru",), D),
        ("SNOW_SWQ", ("hru",), D),
        ("GLAC_WATER_STORAGE", ("hru",), D),
        ("GLAC_CUM_MASS_BALANCE", ("hru",), D),
        ("ENERGY_T", ("hru", "Nnodes"), D),
        ("ENERGY_TFOLIAGE", ("hru",), D),
        ("GLAC_SURF_TEMP", ("hru",), D),
        ("SNOW_COLD_CONTENT", ("hru",), D),
        ("SNOW_PACK_TEMP", ("hru",), D),
        ("SNOW_SURF_TEMP", ("hru",), D),
        ("SNOW_ALBEDO", ("hru",), D),
        ("SNOW_LAST_SNOW", ("hru",), D),
        ("SNOW_MELTING", ("hru",), I),
        ("ENERGY_TCANOPY_FBCOUNT", ("hru",), I),
        ("ENERGY_T_FBCOUNT", ("hru", "Nnodes"), I),
        ("ENERGY_TFOLIAGE_FBCOUNT", ("hru",), I),
        ("ENERGY_TSURF_FBCOUNT", ("hru",), I),
        ("GLAC_SURF_TEMP_FBCOUNT", ("hru",), I),
        ("SNOW_SURF_TEMP_FBCOUNT", ("hru",), I),
        ("GLAC_SURF_TEMP_FBFLAG", ("hru",), I),
        ("GLAC_VAPOR_FLUX", ("hru",), D),
        ("SNOW_CANOPY_ALBEDO", ("hru",), D),
        ("SNOW_SURFACE_FLUX", ("hru",), D),
        ("SNOW_SURF_TEMP_FBFLAG", ("hru",), I),
        ("SNOW_TMP_INT_STORAGE", ("hru",), D),
        ("SNOW_VAPOR_FLUX", ("hru",), D),
    ]


def _lake_meta(nl, ndist):
    """Lake block as declared (StateIONetCDF.c:484-523)."""
    D, I = np.float64, np.int32
    return [
        ("LAKE_LAYER_MOIST", ("dist", "Nlayers"), D),
        ("LAKE_LAYER_ICE_CONTENT", ("dist", "Nlayers"), D),
        ("LAKE_SNOW_LAST_SNOW", (), D),
        ("LAKE_SNOW_MELTING", ("hru",), I),
        ("LAKE_SNOW_COVERAGE", (), D),
        ("LAKE_SNOW_SWQ", (), D),
        ("LAKE_SNOW_SURF_TEMP", (), D),
        ("LAKE_SNOW_SURF_WATER", (), D),
        ("LAKE_SNOW_PACK_TEMP", (), D),
        ("LAKE_SNOW_PACK_WATER", (), D),
        ("LAKE_SNOW_DENSITY", (), D),
        ("LAKE_SNOW_COLD_CONTENT", (), D),
        ("LAKE_SNOW_CANOPY", (), D),
        ("LAKE_ENERGY_T", ("lake_active_nodes",), D),
        ("LAKE_ACTIVENOD", (), D),
        ("LAKE_DZ", (), D),
        ("LAKE_SURFDZ", (), D),
        ("LAKE_LDEPTH", (), D),
        ("LAKE_SURFACE", ("lake_active_nodes",), D),
        ("LAKE_SAREA", (), D),
        ("LAKE_VOLUME", (), D),
        ("LAKE_TEMP", ("lake_active_nodes",), D),
        ("LAKE_TEMPAVG", (), D),
        ("LAKE_AREAI", (), D),
        ("LAKE_NEW_ICE_AREA", (), D),
        ("LAKE_ICE_WATER_EQ", (), D),
        ("LAKE_HICE", (), D),
        ("LAKE_TEMPI", (), D),
        ("LAKE_SWE", (), D),
        ("LAKE_SURF_TEMP", (), D),
        ("LAKE_PACK_TEMP", (), D),
        ("LAKE_SALBEDO", (), D),
        ("LAKE_SDEPTH", (), D),
    ]


def _lake_depth(lake_params, volume) -> np.ndarray:
    """The lakes' depth at their volume (get_depth, initialize_lake.c:412),
    float64. vic_tpu reads a `basin_depth` its LakeParams lacks here, so
    its writer raises when given lake_params."""
    from ..physics.lake import depth_from_volume
    lp = lake_params.to("cpu")
    depth = depth_from_volume(lp, torch.from_numpy(volume).to(
        lp.maxdepth.dtype))
    return depth.numpy().astype(np.float64)


def write_state_netcdf_ref(path: str, state: ModelState, gp, domain,
                           date=None, geom=None, gmb=None, lake_params=None):
    """Write the reference NetCDF state layout."""
    from .native import NetCDFFile
    with NetCDFFile(path, "w", netcdf4=True) as nc:
        _write(nc, state.numpy(), gp, domain, date, geom, gmb, lake_params)


def _write(nc, s, gp, domain, date, geom, gmb, lake_params):
    hru, soil = domain.hru, domain.soil
    n_cell, max_hru = s["swq"].shape
    nl = s["moist"].shape[-1]
    nn = s["node_temp"].shape[-1]
    ndist = 2 if getattr(gp, "dist_prcp", False) else 1
    y, m, d = date if date else (gp.stateyear or gp.startyear,
                                 gp.statemonth or 1, gp.stateday or 1)
    lats, lons, li, lo = _grid(soil)

    # global attributes (addGlobalAttributes + the reader-verified trio,
    # WriteOutputNetCDF.c:99-140; state date/shape attrs StateIONetCDF.c:
    # 131-136)
    nc.put_att("title", "VIC model run output.")
    nc.put_att("institution", "vic-tpu")
    nc.put_att("contact", "vic-tpu")
    nc.put_att("references", "pacificclimate/VIC StateIONetCDF layout")
    nc.put_att("model_start_year", int(gp.startyear))
    nc.put_att("model_start_month", int(gp.startmonth))
    nc.put_att("model_start_day", int(gp.startday))
    nc.put_att("model_start_hour", int(getattr(gp, "starthour", 0)))
    nc.put_att("state_year", int(y))
    nc.put_att("state_month", int(m))
    nc.put_att("state_day", int(d))
    nc.put_att("state_nlayer", int(nl))
    nc.put_att("state_nnode", int(nn))
    nc.put_att("state_nglac_mass_balance_eqn_terms", NUM_GMB_TERMS)

    # dimensions (StateIONetCDF.c:384-398)
    nc.def_dim("lat", len(lats))
    nc.def_dim("lon", len(lons))
    nc.def_dim("bnds", 2)
    nc.def_dim("Nlayers", nl)
    nc.def_dim("Nnodes", nn)
    nc.def_dim("lake_active_nodes", MAX_LAKE_NODES + 1)
    nc.def_dim("frost_layer_subareas", nl * FROST_SUBAREAS)
    nc.def_dim("frost_subareas", FROST_SUBAREAS)
    nc.def_dim("hru", max_hru)
    nc.def_dim("dist", ndist)
    nc.def_dim("NgmbTerms", NUM_GMB_TERMS)

    nc.def_var("lat", np.float32, ("lat",))
    nc.def_var("lon", np.float32, ("lon",))
    metas = _meta(nl, nn, max_hru, ndist)
    if getattr(gp, "lakes", False):
        metas = metas + _lake_meta(nl, ndist)
    dims_len = {"hru": max_hru, "dist": ndist, "Nlayers": nl, "Nnodes": nn,
                "lake_active_nodes": MAX_LAKE_NODES + 1,
                "NgmbTerms": NUM_GMB_TERMS}
    for name, extra, dt in metas:
        nc.def_var(name, dt, ("lat", "lon") + extra)
    nc.enddef()
    nc.put("lat", lats.astype(np.float32))
    nc.put("lon", lons.astype(np.float32))

    def scat(extra_shape, dtype, fill):
        return np.full((len(lats), len(lons)) + extra_shape, fill, dtype)

    mask = np.asarray(hru.mask)

    def put_grid(name, cell_vals, extra=(), dtype=np.float64,
                 fill=FILL_D):
        a = scat(tuple(dims_len[d] for d in extra), dtype, fill)
        a[li, lo] = cell_vals
        nc.put(name, a)

    # cell-level
    put_grid("GRID_CELL", np.asarray(soil.gridcel, np.int32), (), np.int32,
             FILL_I)
    put_grid("NUM_BANDS", np.full(n_cell, gp.snow_band, np.int32), (),
             np.int32, FILL_I)
    put_grid("VEG_TYPE_NUM", mask.sum(1).astype(np.int32), (), np.int32,
             FILL_I)
    gmb_arr = np.stack([np.asarray(_gmb_terms(gmb, ci), np.float64)
                        for ci in range(n_cell)])
    put_grid("GLAC_MASS_BALANCE_EQN_TERMS", gmb_arr, ("NgmbTerms",))
    dz = np.zeros((n_cell, nn)) if geom is None else \
        np.broadcast_to(np.asarray(geom.dz, float), (n_cell, nn))
    zsum = np.zeros((n_cell, nn)) if geom is None else \
        np.broadcast_to(np.asarray(geom.zsum, float), (n_cell, nn))
    put_grid("SOIL_DZ_NODE", dz, ("Nnodes",))
    put_grid("SOIL_ZSUM_NODE", zsum, ("Nnodes",))

    # HRU-level. Lanes are stored at their lane index; invalid lanes carry
    # the fill (the reference writes exactly numHRUs entries, leaving the
    # rest of the hru dimension at the netCDF fill).
    veg_id = np.full((n_cell, max_hru), FILL_I, np.int32)
    for ci in range(n_cell):
        for h in range(max_hru):
            if mask[ci, h]:
                veg_id[ci, h] = _hru_veg_id(hru, domain.veglib, ci, h)
    band = np.where(mask, np.asarray(hru.band), FILL_I).astype(np.int32)
    put_grid("HRU_BAND_INDEX", band, ("hru",), np.int32, FILL_I)
    put_grid("HRU_VEG_INDEX", veg_id, ("hru",), np.int32, FILL_I)

    def dist_stack(wet, dry):
        cols = [wet] + ([dry] if ndist == 2 else [])
        return np.stack(cols, axis=2)       # [c, hru, dist, ...]

    put_grid("LAYER_MOIST", dist_stack(s["moist"], s["moist_dry"]),
             ("hru", "dist", "Nlayers"))
    put_grid("LAYER_ICE_CONTENT", dist_stack(s["ice"], s["ice_dry"]),
             ("hru", "dist", "Nlayers"))
    wdew = dist_stack(s["wdew"], s["wdew_dry"])
    # Wdew only written for non-artificial-bare HRUs
    # (write_model_state.c:235-237)
    wdew = np.where(np.asarray(hru.is_bare)[:, :, None], FILL_D, wdew)
    put_grid("HRU_VEG_VAR_WDEW", wdew, ("hru", "dist"))

    hv = lambda name, arr: put_grid(name, np.where(mask, arr, FILL_D),
                                    ("hru",))
    hv("SNOW_CANOPY", s["snow_canopy"])
    hv("SNOW_DENSITY", s["density"])
    hv("SNOW_DEPTH", s["depth"])
    hv("SNOW_PACK_WATER", s["pack_water"])
    hv("SNOW_SURF_WATER", s["surf_water"])
    hv("SNOW_SWQ", s["swq"])
    hv("GLAC_WATER_STORAGE", s["glac_water_storage"])
    hv("GLAC_CUM_MASS_BALANCE", s["glac_cum_mass_balance"])
    put_grid("ENERGY_T", np.where(mask[:, :, None], s["node_temp"], FILL_D),
             ("hru", "Nnodes"))
    hv("ENERGY_TFOLIAGE", s["tfoliage"])
    hv("GLAC_SURF_TEMP", s["glac_surf_temp"])
    hv("SNOW_COLD_CONTENT", s["cold_content"])
    hv("SNOW_PACK_TEMP", s["pack_temp"])
    hv("SNOW_SURF_TEMP", s["surf_temp"])
    hv("SNOW_ALBEDO", s["albedo"])
    hv("SNOW_LAST_SNOW", s["last_snow"].astype(np.float64))
    put_grid("SNOW_MELTING", np.where(mask, s["melting"], 0).astype(np.int32),
             ("hru",), np.int32, FILL_I)
    iv = lambda name, arr: put_grid(
        name, np.where(mask, arr, 0).astype(np.int32), ("hru",), np.int32,
        FILL_I)
    iv("ENERGY_TCANOPY_FBCOUNT", np.zeros_like(s["surf_temp_fbcount"]))
    put_grid("ENERGY_T_FBCOUNT",
             np.zeros((n_cell, max_hru, nn), np.int32), ("hru", "Nnodes"),
             np.int32, FILL_I)
    iv("ENERGY_TFOLIAGE_FBCOUNT", np.zeros_like(s["surf_temp_fbcount"]))
    iv("ENERGY_TSURF_FBCOUNT", s["surf_temp_fbcount"])
    iv("GLAC_SURF_TEMP_FBCOUNT", s["surf_temp_fbcount"])
    iv("SNOW_SURF_TEMP_FBCOUNT", s["snow_temp_fbcount"])
    iv("GLAC_SURF_TEMP_FBFLAG", np.zeros_like(s["surf_temp_fbcount"]))
    hv("GLAC_VAPOR_FLUX", np.zeros_like(s["swq"]))
    hv("SNOW_CANOPY_ALBEDO", np.zeros_like(s["swq"]))
    hv("SNOW_SURFACE_FLUX", np.zeros_like(s["swq"]))
    iv("SNOW_SURF_TEMP_FBFLAG", np.zeros_like(s["snow_temp_fbcount"]))
    hv("SNOW_TMP_INT_STORAGE", np.zeros_like(s["swq"]))
    hv("SNOW_VAPOR_FLUX", np.zeros_like(s["swq"]))

    if getattr(gp, "lakes", False):
        n_lnode = s["lake_temp"].shape[-1]
        lt = np.full((n_cell, MAX_LAKE_NODES + 1), 0.0)
        lt[:, :n_lnode] = s["lake_temp"]
        put_grid("LAKE_LAYER_MOIST",
                 dist_stack(s["moist"], s["moist_dry"])[:, 0],
                 ("dist", "Nlayers"))
        put_grid("LAKE_LAYER_ICE_CONTENT",
                 dist_stack(s["ice"], s["ice_dry"])[:, 0],
                 ("dist", "Nlayers"))
        sc = lambda name, v: put_grid(name, np.asarray(v, np.float64), ())
        sc("LAKE_SNOW_LAST_SNOW", s["lake_last_snow"])
        put_grid("LAKE_SNOW_MELTING",
                 np.broadcast_to(s["lake_melting"][:, None].astype(np.int32),
                                 (n_cell, max_hru)), ("hru",), np.int32,
                 FILL_I)
        sc("LAKE_SNOW_COVERAGE", (s["lake_swe"] > 0).astype(float))
        sc("LAKE_SNOW_SWQ", s["lake_swe"])
        sc("LAKE_SNOW_SURF_TEMP", s["lake_snow_surf_temp"])
        sc("LAKE_SNOW_SURF_WATER", s["lake_snow_surf_water"])
        sc("LAKE_SNOW_PACK_TEMP", s["lake_snow_pack_temp"])
        sc("LAKE_SNOW_PACK_WATER", s["lake_snow_pack_water"])
        sc("LAKE_SNOW_DENSITY", np.zeros(n_cell))
        sc("LAKE_SNOW_COLD_CONTENT", np.zeros(n_cell))
        sc("LAKE_SNOW_CANOPY", np.zeros(n_cell))
        put_grid("LAKE_ENERGY_T", np.broadcast_to(
            zsum[:, :1] * 0.0, (n_cell, MAX_LAKE_NODES + 1)).copy(),
            ("lake_active_nodes",))
        sc("LAKE_ACTIVENOD", np.full(n_cell, float(n_lnode)))
        depth = (np.zeros(n_cell) if lake_params is None else
                 _lake_depth(lake_params, s["lake_volume"]))
        sc("LAKE_DZ", depth / max(n_lnode, 1))
        sc("LAKE_SURFDZ", np.zeros(n_cell))
        sc("LAKE_LDEPTH", depth)
        put_grid("LAKE_SURFACE", np.zeros((n_cell, MAX_LAKE_NODES + 1)),
                 ("lake_active_nodes",))
        sc("LAKE_SAREA", np.zeros(n_cell))
        sc("LAKE_VOLUME", s["lake_volume"])
        put_grid("LAKE_TEMP", lt, ("lake_active_nodes",))
        sc("LAKE_TEMPAVG", s["lake_temp"].mean(-1))
        sc("LAKE_AREAI", s["lake_ice_area"])
        sc("LAKE_NEW_ICE_AREA", s["lake_ice_area"])
        sc("LAKE_ICE_WATER_EQ", s["lake_ice_we"])
        sc("LAKE_HICE", s["lake_ice_height"])
        sc("LAKE_TEMPI", s["lake_tempi"])
        sc("LAKE_SWE", s["lake_swe"])
        sc("LAKE_SURF_TEMP", s["lake_snow_surf_temp"])
        sc("LAKE_PACK_TEMP", s["lake_snow_pack_temp"])
        sc("LAKE_SALBEDO", s["lake_salbedo"])
        sc("LAKE_SDEPTH", s["lake_swe"] * 1000.0 / 250.0)


def load_state_netcdf_ref(path: str, gp, domain,
                          template: ModelState) -> ModelState:
    """Read a reference-schema NetCDF state back into a ModelState."""
    from .native import NetCDFFile
    hru, soil = domain.hru, domain.soil
    t = {k: v.copy() for k, v in template.numpy().items()}
    n_cell, max_hru = t["swq"].shape
    nl = t["moist"].shape[-1]
    nn = t["node_temp"].shape[-1]
    lats, lons, li, lo = _grid(soil)
    with NetCDFFile(path, "r") as nc:
        ndist_file = nc.dim_len("dist")
        hru_file = nc.dim_len("hru")
        nn_file = nc.dim_len("Nnodes")
        if nn_file != nn or nc.dim_len("Nlayers") != nl:
            raise ValueError("state file Nlayers/Nnodes mismatch")
        nh = min(hru_file, max_hru)

        def g(name, extra, dtype=np.float64):
            a = nc.get(name, [0] * (2 + len(extra)),
                       [len(lats), len(lons)] + list(extra), dtype)
            return a[li, lo]

        lm = g("LAYER_MOIST", [hru_file, ndist_file, nl])
        t["moist"][:, :nh] = lm[:, :nh, 0]
        ic = g("LAYER_ICE_CONTENT", [hru_file, ndist_file, nl])
        t["ice"][:, :nh] = ic[:, :nh, 0]
        wd = g("HRU_VEG_VAR_WDEW", [hru_file, ndist_file])
        bare = np.asarray(hru.is_bare)[:, :nh]
        t["wdew"][:, :nh] = np.where(
            bare | (wd[:, :nh, 0] <= FILL_D / 2), 0.0, wd[:, :nh, 0])
        if ndist_file == 2:
            t["moist_dry"][:, :nh] = lm[:, :nh, 1]
            t["ice_dry"][:, :nh] = ic[:, :nh, 1]
            t["wdew_dry"][:, :nh] = np.where(
                bare | (wd[:, :nh, 1] <= FILL_D / 2), 0.0, wd[:, :nh, 1])

        def hvr(field, name):
            v = g(name, [hru_file])
            t[field][:, :nh] = np.where(v[:, :nh] <= FILL_D / 2,
                                        t[field][:, :nh], v[:, :nh])

        hvr("snow_canopy", "SNOW_CANOPY")
        hvr("density", "SNOW_DENSITY")
        hvr("depth", "SNOW_DEPTH")
        hvr("pack_water", "SNOW_PACK_WATER")
        hvr("surf_water", "SNOW_SURF_WATER")
        hvr("swq", "SNOW_SWQ")
        hvr("glac_water_storage", "GLAC_WATER_STORAGE")
        hvr("glac_cum_mass_balance", "GLAC_CUM_MASS_BALANCE")
        et = g("ENERGY_T", [hru_file, nn])
        t["node_temp"][:, :nh] = np.where(et[:, :nh] <= FILL_D / 2,
                                          t["node_temp"][:, :nh], et[:, :nh])
        hvr("tfoliage", "ENERGY_TFOLIAGE")
        hvr("glac_surf_temp", "GLAC_SURF_TEMP")
        hvr("cold_content", "SNOW_COLD_CONTENT")
        hvr("pack_temp", "SNOW_PACK_TEMP")
        hvr("surf_temp", "SNOW_SURF_TEMP")
        hvr("albedo", "SNOW_ALBEDO")
        ls = g("SNOW_LAST_SNOW", [hru_file])
        t["last_snow"][:, :nh] = np.where(
            ls[:, :nh] <= FILL_D / 2, t["last_snow"][:, :nh],
            ls[:, :nh]).astype(t["last_snow"].dtype)
        ml = g("SNOW_MELTING", [hru_file])
        t["melting"][:, :nh] = ml[:, :nh] > 0
        fb = g("ENERGY_TSURF_FBCOUNT", [hru_file])
        t["surf_temp_fbcount"][:, :nh] = np.maximum(fb[:, :nh], 0).astype(
            t["surf_temp_fbcount"].dtype)
        fb = g("SNOW_SURF_TEMP_FBCOUNT", [hru_file])
        t["snow_temp_fbcount"][:, :nh] = np.maximum(fb[:, :nh], 0).astype(
            t["snow_temp_fbcount"].dtype)

        if getattr(gp, "lakes", False) and "LAKE_VOLUME" in nc.var_names():
            sc = lambda name: g(name, [])
            t["lake_volume"][:] = sc("LAKE_VOLUME")
            lt = g("LAKE_TEMP", [MAX_LAKE_NODES + 1])
            t["lake_temp"][:] = lt[:, :t["lake_temp"].shape[-1]]
            t["lake_ice_we"][:] = sc("LAKE_ICE_WATER_EQ")
            t["lake_ice_area"][:] = sc("LAKE_AREAI")
            t["lake_ice_height"][:] = sc("LAKE_HICE")
            t["lake_swe"][:] = sc("LAKE_SWE")
            t["lake_tempi"][:] = sc("LAKE_TEMPI")
            t["lake_snow_surf_temp"][:] = sc("LAKE_SNOW_SURF_TEMP")
            t["lake_snow_pack_temp"][:] = sc("LAKE_SNOW_PACK_TEMP")
            t["lake_snow_surf_water"][:] = sc("LAKE_SNOW_SURF_WATER")
            t["lake_snow_pack_water"][:] = sc("LAKE_SNOW_PACK_WATER")
            t["lake_salbedo"][:] = sc("LAKE_SALBEDO")
            t["lake_last_snow"][:] = sc("LAKE_SNOW_LAST_SNOW").astype(
                t["lake_last_snow"].dtype)
            t["lake_melting"][:] = g("LAKE_SNOW_MELTING", [hru_file])[:, 0] > 0

    # LongUnderOut is not a reference state variable; re-derive from the
    # restored node-0 temperature (initialize_model_state.c:291-293)
    t["long_under_out"] = (5.6696e-8
                           * (t["node_temp"][..., 0] + 273.15) ** 4
                           ).astype(t["long_under_out"].dtype)

    return ModelState(**{k: torch.from_numpy(v) for k, v in t.items()})


def is_ref_netcdf_state(path: str) -> bool:
    """Sniff: a NetCDF file carrying the reference state schema."""
    from . import native
    if not native.netcdf_found():
        return False
    try:
        with native.NetCDFFile(path, "r") as nc:
            names = nc.var_names()
    except OSError:
        return False
    return "GRID_CELL" in names and "LAYER_MOIST" in names
