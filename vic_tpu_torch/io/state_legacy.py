"""Reference-format ASCII / BINARY model state files.

A copy of `vic_tpu/io/state_legacy.py` on the port's ModelState: the
reference's legacy state formats (StateIOASCII.c:22-219,
StateIOBinary.c:22-180) and the per-cell variable sequence of
write_model_state.c:76-371 / read_initial_model_state.c:10-152, so runs of
the port warm-start from (and produce) state files interchangeable with the
reference and with vic_tpu:

- header: STATEYEAR STATEMONTH STATEDAY then Nlayer Nnode
  (StateIOASCII.c:23-37 two lines; StateIOBinary.c:22-39 five raw int32);
- per cell: gridcel, numHRUs, Nbands (+ binary-only NBytes byte count of the
  remaining record, StateIOBinary.c:156-175), then dz_node[Nnode],
  Zsum_node[Nnode], optional depth_full_snow_cover (SPATIAL_SNOW), the 4
  float32 glacier-mass-balance polynomial terms, one block per HRU in list
  order, and an optional lake block (write_model_state.c:110-371);
- ASCII scalars: ints "%i", doubles "%.18e", bools "%d", space-separated
  with newlines where the reference calls processNewline()
  (StateIOASCII.c:40-105); BINARY: raw little-endian int32 / float64 /
  float32 / 1-byte bool.

Values the reference tracks but the model does not carry across steps
(per-node fallback counters, per-step vapor-flux diagnostics, canopy albedo,
tmp_int_storage) are written as zeros and skipped on read; everything
prognostic round-trips into :class:`~vic_tpu_torch.state.ModelState`.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..state import ModelState

# the state fields the legacy formats carry
LEGACY_FIELDS = (
    "moist", "ice", "wdew", "moist_dry", "ice_dry", "wdew_dry",
    "snow_canopy", "swq", "surf_temp",
    "pack_temp", "surf_water", "pack_water", "density", "depth",
    "albedo", "last_snow", "melting", "cold_content", "node_temp",
    "tfoliage", "glac_water_storage", "glac_cum_mass_balance",
    "glac_surf_temp", "surf_temp_fbcount", "snow_temp_fbcount",
    "lake_volume", "lake_temp", "lake_ice_we", "lake_ice_area",
    "lake_ice_height", "lake_swe", "lake_tempi", "lake_snow_surf_temp",
    "lake_snow_pack_temp", "lake_snow_surf_water",
    "lake_snow_pack_water", "lake_salbedo", "lake_last_snow",
    "lake_melting")


class _AsciiWriter:
    """StateIOASCII.c write semantics: space-separated, %.18e doubles."""

    def __init__(self, fh):
        self.fh = fh
        self.first = True

    def _sep(self):
        if not self.first:
            self.fh.write(" ")
        self.first = False

    def ints(self, *vals):
        for v in vals:
            self._sep()
            self.fh.write("%i" % int(v))

    def dbls(self, *vals):
        for v in vals:
            self._sep()
            self.fh.write("%.18e" % float(v))

    def flts(self, *vals):
        for v in vals:
            self._sep()
            self.fh.write("%.18e" % float(np.float32(v)))

    def bools(self, *vals):
        for v in vals:
            self._sep()
            self.fh.write("%d" % (1 if v else 0))

    def newline(self):
        self.fh.write("\n")
        self.first = True

    def begin_cell_record(self):
        pass

    def end_cell_record(self):
        pass


class _BinaryWriter:
    """StateIOBinary.c write semantics: raw structs buffered per cell record
    with an NBytes count spliced in after the 3 header ints
    (StateIOBinary.c:156-175)."""

    HEADER_INTS = 3

    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()
        self.buffering = False

    def _emit(self, b):
        if self.buffering:
            self.buf += b
        else:
            self.fh.write(b)

    def ints(self, *vals):
        self._emit(struct.pack("<%di" % len(vals), *[int(v) for v in vals]))

    def dbls(self, *vals):
        self._emit(struct.pack("<%dd" % len(vals), *[float(v) for v in vals]))

    def flts(self, *vals):
        self._emit(struct.pack("<%df" % len(vals), *[float(v) for v in vals]))

    def bools(self, *vals):
        self._emit(bytes(1 if v else 0 for v in vals))

    def newline(self):
        pass

    def begin_cell_record(self):
        self.buf = bytearray()
        self.buffering = True

    def end_cell_record(self):
        nbytes = len(self.buf) - self.HEADER_INTS * 4
        rec = self.buf[:self.HEADER_INTS * 4] + struct.pack("<i", nbytes) \
            + self.buf[self.HEADER_INTS * 4:]
        self.buffering = False
        self.fh.write(bytes(rec))


class _AsciiReader:
    def __init__(self, fh):
        self.toks = fh.read().split()
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.toks):
            raise EOFError("End of model state file found unexpectedly")
        out = self.toks[self.pos:self.pos + n]
        self.pos += n
        return out

    def ints(self, n=1):
        # the reference prints some integer-typed state (e.g. the lake
        # snow's last_snow) through a %f format, so "-1.000000e+00" must
        # parse as -1; destabilized C runs can even emit "nan" there
        # (observed in state files from the frozen-soil runaway) — map
        # non-finite to the reference's INVALID_INT sentinel
        import math
        out = []
        for t in self._take(n):
            v = float(t)
            out.append(int(v) if math.isfinite(v) else -(2 ** 31 - 1))
        return out

    def dbls(self, n=1):
        return [float(t) for t in self._take(n)]

    flts = dbls

    def bools(self, n=1):
        return [int(t) != 0 for t in self._take(n)]

    def skip_nbytes(self):
        pass


class _BinaryReader:
    def __init__(self, fh):
        self.data = fh.read()
        self.pos = 0

    def _take(self, nbytes):
        if self.pos + nbytes > len(self.data):
            raise EOFError("End of model state file found unexpectedly")
        out = self.data[self.pos:self.pos + nbytes]
        self.pos += nbytes
        return out

    def ints(self, n=1):
        return list(struct.unpack("<%di" % n, self._take(4 * n)))

    def dbls(self, n=1):
        return list(struct.unpack("<%dd" % n, self._take(8 * n)))

    def flts(self, n=1):
        return list(struct.unpack("<%df" % n, self._take(4 * n)))

    def bools(self, n=1):
        return [b != 0 for b in self._take(n)]

    def skip_nbytes(self):
        self.ints(1)



def _hru_veg_id(hru, veglib, ci, h):
    """State-file veg id of an HRU: its vegClass, or for artificial bare
    soil the veg-library entry count (read_vegparam.c:318 bareSoilVeg.
    vegClass = num_veg_types; the library here carries 4 appended PET
    reference surfaces that the reference's num_veg_types excludes)."""
    if bool(hru.is_bare[ci, h]):
        return int(len(veglib.veg_class) - 4)
    return int(veglib.veg_class[hru.veg_idx[ci, h]])

def _gmb_terms(gmb, ci):
    if gmb is None:
        return (0.0, 0.0, 0.0, 0.0)
    b = np.asarray(gmb)
    return tuple(float(x) for x in b[ci][:4]) if b.ndim == 2 else \
        tuple(float(x) for x in b[:4])


def write_state_legacy(path: str, state: ModelState, gp, domain, date=None,
                       fmt: str = "ASCII", geom=None, gmb=None,
                       lake_params=None):
    """Write the reference-format state file (write_model_state.c:76-371).

    domain: the Domain the run was built from (HRU structure defines the
    per-cell record layout). geom: NodeGeometry for dz/Zsum (zeros if None).
    gmb: optional [n_cell, 4] glacier-mass-balance polynomial terms.
    """
    hru, soil = domain.hru, domain.soil
    s = {k: getattr(state, k).cpu().numpy() for k in LEGACY_FIELDS}
    n_cell = s["swq"].shape[0]
    nl = s["moist"].shape[-1]
    nn = s["node_temp"].shape[-1]
    ndist = 2 if getattr(gp, "dist_prcp", False) else 1
    y, m, d = date if date else (gp.stateyear or gp.startyear,
                                 gp.statemonth or 1, gp.stateday or 1)
    binary = fmt.upper() == "BINARY"
    fh = open(path, "wb" if binary else "w")
    w = _BinaryWriter(fh) if binary else _AsciiWriter(fh)

    # header (StateIOASCII.c:23-37 / StateIOBinary.c:22-39)
    w.ints(y, m, d)
    w.newline()
    w.ints(nl, nn)
    w.newline()

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    dz = np.zeros((n_cell, nn)) if geom is None else \
        np.broadcast_to(host(geom.dz), (n_cell, nn))
    zsum = np.zeros((n_cell, nn)) if geom is None else \
        np.broadcast_to(host(geom.zsum), (n_cell, nn))

    # lake liquid depth for the lake state block (write_model_state.c writes
    # lake_var.ldepth = depth of the LIQUID volume, lakes.eb.c get_depth)
    lake_ldepth = None
    if gp.lakes and lake_params is not None:
        from ..physics.lake import depth_from_volume_plain
        liq = np.maximum(s["lake_volume"] - s["lake_ice_we"], 0.0)
        lake_ldepth = depth_from_volume_plain(
            lake_params.to("cpu"), torch.as_tensor(liq)).numpy()

    for ci in range(n_cell):
        hrus = [h for h in range(hru.mask.shape[1]) if hru.mask[ci, h]]
        w.begin_cell_record()
        w.ints(int(soil.gridcel[ci]), len(hrus), gp.snow_band)
        w.newline()
        w.dbls(*dz[ci])
        w.dbls(*zsum[ci])
        w.newline()
        if getattr(gp, "spatial_snow", False):
            w.dbls(float(soil.depth_full_snow_cover[ci]))
        w.flts(*_gmb_terms(gmb, ci))

        for h in hrus:
            w.ints(int(hru.band[ci, h]),
                   _hru_veg_id(hru, domain.veglib, ci, h))
            w.newline()
            for dist in range(ndist):
                # dist 0 = WET column, dist 1 = DRY column
                # (write_model_state.c:193-235 DIST_DIM loop)
                sfx = "_dry" if dist == 1 else ""
                w.dbls(*s["moist" + sfx][ci, h])
                w.dbls(*s["ice" + sfx][ci, h])
                if not hru.is_bare[ci, h]:
                    w.dbls(float(s["wdew" + sfx][ci, h]))
            w.dbls(s["snow_canopy"][ci, h], s["density"][ci, h],
                   s["depth"][ci, h], s["pack_water"][ci, h],
                   s["surf_water"][ci, h], s["swq"][ci, h])
            w.dbls(s["glac_water_storage"][ci, h],
                   s["glac_cum_mass_balance"][ci, h])
            w.dbls(*s["node_temp"][ci, h])
            w.dbls(s["tfoliage"][ci, h], s["glac_surf_temp"][ci, h],
                   s["cold_content"][ci, h], s["pack_temp"][ci, h],
                   s["surf_temp"][ci, h])
            w.dbls(s["albedo"][ci, h])
            w.ints(int(s["last_snow"][ci, h]))
            w.bools(bool(s["melting"][ci, h]))
            # program terms (write_model_state.c:268-275): Tcanopy, per-node,
            # Tfoliage, Tsurf, glacier, snow fallback counts
            w.ints(0)
            w.ints(*([0] * nn))
            w.ints(0, int(s["surf_temp_fbcount"][ci, h]),
                   int(s["surf_temp_fbcount"][ci, h]),
                   int(s["snow_temp_fbcount"][ci, h]))
            # misc non-mandatory (write_model_state.c:277-285)
            w.bools(False)
            w.dbls(0.0, 0.0, 0.0)
            w.bools(False)
            w.dbls(0.0, 0.0)
            w.newline()

        if gp.lakes:
            n_lnode = s["lake_temp"].shape[-1]
            for _dist in range(ndist):
                w.dbls(*s["moist"][ci, 0])   # lake soil column not separate
                w.dbls(*s["ice"][ci, 0])
            w.ints(int(s["lake_last_snow"][ci]))
            w.bools(bool(s["lake_melting"][ci]))
            w.dbls(1.0 if s["lake_swe"][ci] > 0 else 0.0,  # coverage
                   s["lake_swe"][ci],                      # swq (m)
                   s["lake_snow_surf_temp"][ci],
                   s["lake_snow_surf_water"][ci],
                   s["lake_snow_pack_temp"][ci],
                   s["lake_snow_pack_water"][ci],
                   0.0, 0.0, 0.0)       # density coldcontent snow_canopy
            w.dbls(*s["node_temp"][ci, 0])
            w.ints(n_lnode)
            depth = 0.0 if lake_ldepth is None else float(lake_ldepth[ci])
            w.dbls(depth / max(n_lnode, 1), 0.0, depth)
            w.dbls(*([0.0] * n_lnode))          # surface areas
            w.dbls(0.0, s["lake_volume"][ci])
            w.dbls(*s["lake_temp"][ci])
            w.dbls(float(np.mean(s["lake_temp"][ci])),
                   s["lake_ice_area"][ci], s["lake_ice_area"][ci],
                   s["lake_ice_we"][ci],
                   s["lake_ice_height"][ci], s["lake_tempi"][ci],
                   s["lake_swe"][ci],
                   s["lake_snow_surf_temp"][ci],
                   s["lake_snow_pack_temp"][ci],
                   s["lake_salbedo"][ci],
                   s["lake_swe"][ci] * 1000.0 / 250.0)
            w.newline()
        w.end_cell_record()
    fh.close()


def load_state_legacy(path: str, gp, domain, template: ModelState,
                      fmt: str = "ASCII") -> ModelState:
    """Read a reference-format state file back into a ModelState
    (read_initial_model_state.c:10-152 sequence; header check per
    check_state_file.c:11)."""
    hru = domain.hru
    binary = fmt.upper() == "BINARY"
    fh = open(path, "rb" if binary else "r")
    r = _BinaryReader(fh) if binary else _AsciiReader(fh)
    fh.close()

    _y, _m, _d = r.ints(3)
    nl_f, nn_f = r.ints(2)
    ref = template.numpy()
    tmpl = {k: ref[k].copy() for k in LEGACY_FIELDS}
    nl = tmpl["moist"].shape[-1]
    nn = tmpl["node_temp"].shape[-1]
    if nl_f != nl or nn_f != nn:
        raise ValueError(
            f"state file Nlayer/Nnode {nl_f}/{nn_f} do not match run "
            f"options {nl}/{nn} (check_state_file.c:11)")
    n_cell = tmpl["swq"].shape[0]
    ndist = 2 if getattr(gp, "dist_prcp", False) else 1

    for ci in range(n_cell):
        _gridcel, n_hru, _nband = r.ints(3)
        r.skip_nbytes()
        r.dbls(nn)   # dz_node
        r.dbls(nn)   # Zsum_node
        if getattr(gp, "spatial_snow", False):
            r.dbls(1)
        r.flts(4)    # GMB terms
        hrus = [h for h in range(hru.mask.shape[1]) if hru.mask[ci, h]]
        if n_hru != len(hrus):
            raise ValueError(
                f"cell {ci}: state file has {n_hru} HRUs, domain has "
                f"{len(hrus)}")
        for h in hrus:
            band_f, veg_f = r.ints(2)
            want_veg = _hru_veg_id(hru, domain.veglib, ci, h)
            if band_f != int(hru.band[ci, h]) or veg_f != want_veg:
                raise ValueError(
                    f"cell {ci} HRU {h}: state file (veg={veg_f}, "
                    f"band={band_f}) does not match domain (veg="
                    f"{want_veg}, band={int(hru.band[ci, h])})")
            for dist in range(ndist):
                moist = r.dbls(nl)
                ice = r.dbls(nl)
                wd = r.dbls(1)[0] if not hru.is_bare[ci, h] else 0.0
                sfx = "_dry" if dist == 1 else ""
                tmpl["moist" + sfx][ci, h] = moist
                tmpl["ice" + sfx][ci, h] = ice
                tmpl["wdew" + sfx][ci, h] = wd
                if ndist == 1:
                    # single-dist file: both columns restart identical
                    tmpl["moist_dry"][ci, h] = moist
                    tmpl["ice_dry"][ci, h] = ice
                    tmpl["wdew_dry"][ci, h] = wd
            (tmpl["snow_canopy"][ci, h], tmpl["density"][ci, h],
             tmpl["depth"][ci, h], tmpl["pack_water"][ci, h],
             tmpl["surf_water"][ci, h], tmpl["swq"][ci, h]) = r.dbls(6)
            (tmpl["glac_water_storage"][ci, h],
             tmpl["glac_cum_mass_balance"][ci, h]) = r.dbls(2)
            tmpl["node_temp"][ci, h] = r.dbls(nn)
            (tmpl["tfoliage"][ci, h], tmpl["glac_surf_temp"][ci, h],
             tmpl["cold_content"][ci, h], tmpl["pack_temp"][ci, h],
             tmpl["surf_temp"][ci, h]) = r.dbls(5)
            tmpl["albedo"][ci, h] = r.dbls(1)[0]
            tmpl["last_snow"][ci, h] = r.ints(1)[0]
            tmpl["melting"][ci, h] = r.bools(1)[0]
            r.ints(1)
            r.ints(nn)
            r.ints(2)
            tmpl["surf_temp_fbcount"][ci, h] = r.ints(1)[0]
            tmpl["snow_temp_fbcount"][ci, h] = r.ints(1)[0]
            r.bools(1)
            r.dbls(3)
            r.bools(1)
            r.dbls(2)
        if gp.lakes:
            n_lnode = tmpl["lake_temp"].shape[-1]
            for _dist in range(ndist):
                r.dbls(nl)
                r.dbls(nl)
            tmpl["lake_last_snow"][ci] = r.ints(1)[0]
            tmpl["lake_melting"][ci] = r.bools(1)[0]
            (_cov, _swq9, l_st, l_sw, l_pt, l_pw,
             _dens, _cc, _can) = r.dbls(9)
            tmpl["lake_snow_surf_temp"][ci] = l_st
            tmpl["lake_snow_surf_water"][ci] = l_sw
            tmpl["lake_snow_pack_temp"][ci] = l_pt
            tmpl["lake_snow_pack_water"][ci] = l_pw
            r.dbls(nn)
            activenod = r.ints(1)[0]
            r.dbls(3)
            r.dbls(activenod)
            _sarea, vol = r.dbls(2)
            temps = r.dbls(activenod)
            (_tavg, areai, _new_ice, ice_we, hice, tempi, swe,
             _st, _pt, salb, _sdep) = r.dbls(11)
            tmpl["lake_tempi"][ci] = tempi
            tmpl["lake_salbedo"][ci] = salb
            tmpl["lake_volume"][ci] = vol
            tmpl["lake_temp"][ci, :min(activenod, n_lnode)] = \
                temps[:min(activenod, n_lnode)]
            tmpl["lake_ice_we"][ci] = ice_we
            tmpl["lake_ice_area"][ci] = areai
            tmpl["lake_ice_height"][ci] = hice
            tmpl["lake_swe"][ci] = swe

    fields = {k: tmpl[k].astype(ref[k].dtype) for k in tmpl}
    # derived on restore like the reference (initialize_model_state.c:327ff):
    # snow presence/coverage follow the restored pack; storm history is not
    # in the file (write_model_state.c:187-189) so it restarts clean
    has_snow = tmpl["swq"] > 0.0
    fields["snow_flag"] = has_snow
    fields["coverage"] = np.where(has_snow, 1.0, 0.0).astype(
        ref["coverage"].dtype)
    for k in ("mu", "still_storm", "dry_time", "cell_valid",
              # depletion-curve memory is not in the legacy format
              # (write_model_state.c writes only snow->coverage)
              "snow_store_snow", "snow_store_swq", "snow_max_swq",
              "snow_swq_slope", "snow_store_coverage"):
        fields[k] = ref[k]
    # LongUnderOut is not in the file; the reference re-derives it from the
    # restored node-0 temperature (initialize_model_state.c:291-293)
    fields["long_under_out"] = (
        5.6696e-8 * (tmpl["node_temp"][..., 0] + 273.15) ** 4
    ).astype(ref["long_under_out"].dtype)
    device = template.swq.device
    return ModelState(**{k: torch.as_tensor(v, device=device)
                         for k, v in fields.items()})
