"""ctypes binding for the port's native vicio library
(vic_tpu_torch/native/vicio.cpp, built by native/build.py at first use).

Provides:
- `NetCDFFile` — NetCDF-4 create/read/write through the system libnetcdf
  (the reference's WriteOutputNetCDF.c engine, driven from Python with the
  byte work native);
- `read_ascii_table` — whitespace-separated table parser (forcing files);
- `read_vic_binary` — the reference's int16+multiplier binary forcing format
  (read_atmos_data.c BINARY path).

`available()` is False when the library cannot be built (the readers then
fall back to numpy); `netcdf_found()` is False when it was built without
libnetcdf, and `NetCDFFile` then raises.
"""
from __future__ import annotations

import ctypes as ct
import os
from typing import Optional, Sequence

import numpy as np

_lib = None
_tried = False

NC_CHAR, NC_INT, NC_FLOAT, NC_DOUBLE = 2, 4, 5, 6
_DTYPE_TO_NC = {np.dtype(np.int32): NC_INT, np.dtype(np.float32): NC_FLOAT,
                np.dtype(np.float64): NC_DOUBLE}
_NC_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NC.items()}


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from ..native.build import build
    path = build()
    if path is None:
        return None
    try:
        lib = ct.CDLL(path)
    except OSError:
        # built on another host (a libnetcdf that is not here): rebuild
        path = build(force=True)
        if path is None:
            return None
        lib = ct.CDLL(path)
    lib.vicio_has_netcdf.restype = ct.c_int
    lib.vicio_nc_strerror.restype = ct.c_char_p
    lib.vicio_read_ascii_table.restype = ct.c_longlong
    lib.vicio_read_vic_binary.restype = ct.c_longlong
    lib.vicio_write_doubles.restype = ct.c_longlong
    lib.vicio_read_doubles.restype = ct.c_longlong
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def netcdf_found() -> bool:
    """True when the library was linked against libnetcdf."""
    lib = _load()
    return lib is not None and bool(lib.vicio_has_netcdf())


def _check(err: int):
    if err != 0:
        msg = _lib.vicio_nc_strerror(err).decode()
        raise OSError(f"netcdf error {err}: {msg}")


def _ll_array(vals: Sequence[int]):
    return (ct.c_longlong * len(vals))(*[int(v) for v in vals])


class NetCDFFile:
    """NetCDF4 file handle over the native library."""

    def __init__(self, path: str, mode: str = "r", netcdf4: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native vicio library unavailable")
        if not lib.vicio_has_netcdf():
            raise RuntimeError(
                "NetCDF I/O needs libnetcdf, which was not found when the "
                "native vicio library was built (native/build.py "
                "NETCDF_CANDIDATES)")
        self._lib = lib
        ncid = ct.c_int()
        if mode == "w":
            _check(lib.vicio_nc_create(path.encode(), int(netcdf4),
                                       ct.byref(ncid)))
            self._defining = True
        else:
            _check(lib.vicio_nc_open(path.encode(), int(mode == "a"),
                                     ct.byref(ncid)))
            self._defining = False
        self.ncid = ncid.value
        self.path = path
        self._dims = {}
        self._vars = {}
        self._closed = False

    # ---- definition ----
    def def_dim(self, name: str, length: Optional[int]) -> int:
        did = ct.c_int()
        _check(self._lib.vicio_nc_def_dim(
            self.ncid, name.encode(),
            ct.c_longlong(-1 if length is None else length), ct.byref(did)))
        self._dims[name] = did.value
        return did.value

    def def_var(self, name: str, dtype, dims: Sequence[str],
                deflate: int = 0, attrs: Optional[dict] = None) -> int:
        xtype = _DTYPE_TO_NC[np.dtype(dtype)]
        dimids = (ct.c_int * len(dims))(*[self._dims[d] for d in dims])
        vid = ct.c_int()
        _check(self._lib.vicio_nc_def_var(self.ncid, name.encode(), xtype,
                                          len(dims), dimids, ct.byref(vid)))
        if deflate:
            _check(self._lib.vicio_nc_def_var_deflate(self.ncid, vid.value,
                                                      deflate))
        self._vars[name] = vid.value
        if attrs:
            for k, v in attrs.items():
                self.put_att(k, v, var=name)
        return vid.value

    def put_att(self, name: str, value, var: Optional[str] = None):
        varid = self._vars[var] if var is not None else -1  # NC_GLOBAL
        if isinstance(value, str):
            _check(self._lib.vicio_nc_put_att_text(
                self.ncid, varid, name.encode(), value.encode()))
        elif isinstance(value, (int, np.integer)) and not isinstance(
                value, bool) and hasattr(self._lib, "vicio_nc_put_att_int"):
            _check(self._lib.vicio_nc_put_att_int(
                self.ncid, varid, name.encode(), ct.c_int(int(value))))
        else:
            _check(self._lib.vicio_nc_put_att_double(
                self.ncid, varid, name.encode(), ct.c_double(float(value))))

    def enddef(self):
        if self._defining:
            _check(self._lib.vicio_nc_enddef(self.ncid))
            self._defining = False

    # ---- inquiry ----
    def varid(self, name: str) -> int:
        if name not in self._vars:
            vid = ct.c_int()
            _check(self._lib.vicio_nc_inq_varid(self.ncid, name.encode(),
                                                ct.byref(vid)))
            self._vars[name] = vid.value
        return self._vars[name]

    def dim_len(self, name: str) -> int:
        did = ct.c_int()
        _check(self._lib.vicio_nc_inq_dimid(self.ncid, name.encode(),
                                            ct.byref(did)))
        ln = ct.c_longlong()
        _check(self._lib.vicio_nc_inq_dimlen(self.ncid, did.value,
                                             ct.byref(ln)))
        return ln.value

    def var_names(self):
        n = ct.c_int()
        _check(self._lib.vicio_nc_inq_nvars(self.ncid, ct.byref(n)))
        out = []
        for vid in range(n.value):
            buf = ct.create_string_buffer(256)
            _check(self._lib.vicio_nc_inq_varname(self.ncid, vid, buf))
            out.append(buf.value.decode())
        return out

    def var_info(self, name: str):
        """(numpy dtype, dimension names) of variable `name`."""
        varid = self.varid(name)
        xtype, nd = ct.c_int(), ct.c_int()
        _check(self._lib.vicio_nc_inq_vartype(self.ncid, varid,
                                              ct.byref(xtype)))
        _check(self._lib.vicio_nc_inq_varndims(self.ncid, varid,
                                               ct.byref(nd)))
        dimids = (ct.c_int * max(nd.value, 1))()
        _check(self._lib.vicio_nc_inq_vardimid(self.ncid, varid, dimids))
        dims = []
        for k in range(nd.value):
            buf = ct.create_string_buffer(256)
            _check(self._lib.vicio_nc_inq_dimname(self.ncid, dimids[k], buf))
            dims.append(buf.value.decode())
        return _NC_TO_DTYPE[xtype.value], tuple(dims)

    def attributes(self, var: Optional[str] = None) -> dict:
        """Every attribute of `var` (None: the global ones) by name, in
        the file's order: text as str, numbers as (netCDF type code,
        float64 array of the values)."""
        varid = self.varid(var) if var is not None else -1   # NC_GLOBAL
        n = ct.c_int()
        _check(self._lib.vicio_nc_inq_varnatts(self.ncid, varid,
                                               ct.byref(n)))
        out = {}
        for k in range(n.value):
            buf = ct.create_string_buffer(256)
            _check(self._lib.vicio_nc_inq_attname(self.ncid, varid, k, buf))
            name = buf.value
            xtype, ln = ct.c_int(), ct.c_longlong()
            _check(self._lib.vicio_nc_inq_att(self.ncid, varid, name,
                                              ct.byref(xtype), ct.byref(ln)))
            if xtype.value == NC_CHAR:
                text = ct.create_string_buffer(ln.value + 1)
                _check(self._lib.vicio_nc_get_att_text(self.ncid, varid,
                                                       name, text))
                out[name.decode()] = text.raw[:ln.value].decode()
            else:
                vals = np.empty(max(ln.value, 1), np.float64)
                _check(self._lib.vicio_nc_get_att_double(
                    self.ncid, varid, name,
                    vals.ctypes.data_as(ct.POINTER(ct.c_double))))
                out[name.decode()] = (xtype.value, vals[:ln.value])
        return out

    # ---- data ----
    def put(self, name: str, data: np.ndarray, start: Optional[Sequence[int]]
            = None):
        self.enddef()
        data = np.ascontiguousarray(data)
        varid = self.varid(name)
        if start is None:
            start = [0] * data.ndim
        count = list(data.shape)
        s, cnt = _ll_array(start), _ll_array(count)
        nd = len(count)
        if data.dtype == np.float32:
            fn = self._lib.vicio_nc_put_vara_float
            ptr = data.ctypes.data_as(ct.POINTER(ct.c_float))
        elif data.dtype == np.float64:
            fn = self._lib.vicio_nc_put_vara_double
            ptr = data.ctypes.data_as(ct.POINTER(ct.c_double))
        elif data.dtype == np.int32:
            fn = self._lib.vicio_nc_put_vara_int
            ptr = data.ctypes.data_as(ct.POINTER(ct.c_int))
        else:
            raise TypeError(f"unsupported dtype {data.dtype}")
        _check(fn(self.ncid, varid, s, cnt, nd, ptr))

    def get(self, name: str, start: Sequence[int], count: Sequence[int],
            dtype=np.float64) -> np.ndarray:
        varid = self.varid(name)
        out = np.empty(tuple(count), np.dtype(dtype))
        s, cnt = _ll_array(start), _ll_array(count)
        nd = len(count)
        if out.dtype == np.float32:
            fn = self._lib.vicio_nc_get_vara_float
            ptr = out.ctypes.data_as(ct.POINTER(ct.c_float))
        elif out.dtype == np.float64:
            fn = self._lib.vicio_nc_get_vara_double
            ptr = out.ctypes.data_as(ct.POINTER(ct.c_double))
        else:
            raise TypeError(f"unsupported dtype {out.dtype}")
        _check(fn(self.ncid, varid, s, cnt, nd, ptr))
        return out

    def get_att(self, var: str, name: str) -> float:
        val = ct.c_double()
        _check(self._lib.vicio_nc_get_att_double(
            self.ncid, self.varid(var), name.encode(), ct.byref(val)))
        return val.value

    def close(self):
        if not self._closed:
            _check(self._lib.vicio_nc_close(self.ncid))
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_ascii_table(path: str, ncols: int, max_rows: int = 1 << 22,
                     skip_rows: int = 0) -> np.ndarray:
    """Fast parse of a whitespace-separated numeric table -> [rows, ncols].
    Transparently handles gzip-compressed files (<path>.gz or .gz suffix),
    mirroring the reference's gzip support (compress_files.c, open_file.c)."""
    import gzip
    import os
    import tempfile
    gz = None
    if path.endswith(".gz"):
        gz = path
    elif not os.path.exists(path) and os.path.exists(path + ".gz"):
        gz = path + ".gz"
    if gz is not None:
        with gzip.open(gz, "rb") as fh:
            data = fh.read()
        tmp = tempfile.NamedTemporaryFile(delete=False, suffix=".txt")
        tmp.write(data)
        tmp.close()
        try:
            return read_ascii_table(tmp.name, ncols, max_rows, skip_rows)
        finally:
            os.unlink(tmp.name)
    lib = _load()
    if lib is None:
        # numpy fallback
        data = np.loadtxt(path, comments="#", ndmin=2)
        return data[skip_rows:skip_rows + max_rows, :ncols]
    out = np.empty((max_rows, ncols), np.float64)
    n = lib.vicio_read_ascii_table(
        path.encode(), ct.c_longlong(skip_rows), ct.c_longlong(max_rows),
        ct.c_int(ncols), out.ctypes.data_as(ct.POINTER(ct.c_double)))
    if n < 0:
        raise OSError(f"cannot read {path}")
    return out[:n]


def read_vic_binary(path: str, signed_flags: Sequence[bool],
                    multipliers: Sequence[float], max_recs: int,
                    skip_bytes: int = 0, skip_recs: int = 0,
                    swap_bytes: bool = False) -> np.ndarray:
    """Read the reference's int16-coded binary forcing file -> [nfields, recs]."""
    lib = _load()
    nf = len(signed_flags)
    sf = np.asarray(signed_flags, np.int32)
    mult = np.asarray(multipliers, np.float64)
    if lib is None:
        raw = np.fromfile(path, dtype=np.uint16, offset=skip_bytes)
        raw = raw[skip_recs * nf:]
        n = len(raw) // nf
        raw = raw[:n * nf].reshape(n, nf)
        if swap_bytes:
            raw = raw.byteswap()
        out = np.where(sf[None, :] == 1, raw.astype(np.int16),
                       raw.astype(np.float64))
        return (out.astype(np.float64) / mult[None, :]).T[:, :max_recs]
    out = np.empty((nf, max_recs), np.float64)
    n = lib.vicio_read_vic_binary(
        path.encode(), ct.c_longlong(skip_bytes), ct.c_longlong(skip_recs),
        ct.c_longlong(max_recs), ct.c_int(nf),
        sf.ctypes.data_as(ct.POINTER(ct.c_int)),
        mult.ctypes.data_as(ct.POINTER(ct.c_double)),
        ct.c_int(int(swap_bytes)),
        out.ctypes.data_as(ct.POINTER(ct.c_double)))
    if n < 0:
        raise OSError(f"cannot read {path}")
    return out[:, :n]
