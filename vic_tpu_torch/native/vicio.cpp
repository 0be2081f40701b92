// vicio — native host-side I/O core of vic_tpu_torch (the port's own copy
// of vic_tpu/native/vicio.cpp).
//
// The byte-level hot loops of the reference's I/O (NetCDF ingest/output,
// binary/ASCII forcing parsing — WriteOutputNetCDF.c, read_atmos_data.c)
// run here; the Python layer orchestrates. Exposed as a plain C ABI
// consumed via ctypes.
//
// NetCDF: linked against the system libnetcdf (v4.9 ABI, libnetcdf.so.19)
// with our own minimal prototypes, so no netcdf.h is needed. Only the
// stable C API subset we use is declared. Without libnetcdf the library is
// linked with its NetCDF symbols unresolved (lazy binding): the ASCII and
// binary readers work, and a NetCDF call fails by name.
//
// Build: vic_tpu_torch/native/build.py (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

// ---------------------------------------------------------------------------
// Minimal libnetcdf C API prototypes (stable ABI; see netcdf.h upstream docs)
// ---------------------------------------------------------------------------
// Declared weak: on a host without libnetcdf the library links and loads
// with these left null, and vicio_has_netcdf() says so.
#define NC_WEAK __attribute__((weak))
extern "C" {
NC_WEAK int nc_open(const char *path, int mode, int *ncidp);
NC_WEAK int nc_create(const char *path, int cmode, int *ncidp);
NC_WEAK int nc_close(int ncid);
NC_WEAK int nc_enddef(int ncid);
NC_WEAK int nc_redef(int ncid);
NC_WEAK int nc_sync(int ncid);
NC_WEAK int nc_def_dim(int ncid, const char *name, size_t len, int *idp);
NC_WEAK int nc_def_var(int ncid, const char *name, int xtype, int ndims,
               const int *dimidsp, int *varidp);
NC_WEAK int nc_def_var_deflate(int ncid, int varid, int shuffle, int deflate,
                       int deflate_level);
NC_WEAK int nc_put_att_text(int ncid, int varid, const char *name, size_t len,
                    const char *op);
NC_WEAK int nc_put_att_float(int ncid, int varid, const char *name, int xtype,
                     size_t len, const float *op);
NC_WEAK int nc_put_att_double(int ncid, int varid, const char *name, int xtype,
                      size_t len, const double *op);
NC_WEAK int nc_put_att_int(int ncid, int varid, const char *name, int xtype,
                   size_t len, const int *op);
NC_WEAK int nc_inq_dimid(int ncid, const char *name, int *idp);
NC_WEAK int nc_inq_dimlen(int ncid, int dimid, size_t *lenp);
NC_WEAK int nc_inq_varid(int ncid, const char *name, int *varidp);
NC_WEAK int nc_inq_varndims(int ncid, int varid, int *ndimsp);
NC_WEAK int nc_inq_vardimid(int ncid, int varid, int *dimidsp);
NC_WEAK int nc_inq_vartype(int ncid, int varid, int *typep);
NC_WEAK int nc_inq_nvars(int ncid, int *nvarsp);
NC_WEAK int nc_inq_varname(int ncid, int varid, char *name);
NC_WEAK int nc_get_att_double(int ncid, int varid, const char *name, double *ip);
NC_WEAK int nc_get_att_text(int ncid, int varid, const char *name, char *ip);
NC_WEAK int nc_inq_attlen(int ncid, int varid, const char *name, size_t *lenp);
NC_WEAK int nc_inq_varnatts(int ncid, int varid, int *nattsp);
NC_WEAK int nc_inq_attname(int ncid, int varid, int attnum, char *name);
NC_WEAK int nc_inq_atttype(int ncid, int varid, const char *name, int *xtypep);
NC_WEAK int nc_inq_dimname(int ncid, int dimid, char *name);
NC_WEAK int nc_put_vara_float(int ncid, int varid, const size_t *startp,
                      const size_t *countp, const float *op);
NC_WEAK int nc_put_vara_double(int ncid, int varid, const size_t *startp,
                       const size_t *countp, const double *op);
NC_WEAK int nc_put_vara_int(int ncid, int varid, const size_t *startp,
                    const size_t *countp, const int *op);
NC_WEAK int nc_get_vara_float(int ncid, int varid, const size_t *startp,
                      const size_t *countp, float *ip);
NC_WEAK int nc_get_vara_double(int ncid, int varid, const size_t *startp,
                       const size_t *countp, double *ip);
NC_WEAK int nc_get_vara_int(int ncid, int varid, const size_t *startp,
                    const size_t *countp, int *ip);
NC_WEAK const char *nc_strerror(int ncerr);
}

#define NC_NOWRITE 0x0000
#define NC_WRITE 0x0001
#define NC_CLOBBER 0x0000
#define NC_NETCDF4 0x1000
#define NC_CLASSIC_MODEL 0x0100
#define NC_UNLIMITED 0L
#define NC_GLOBAL (-1)
#define NC_INT 4
#define NC_FLOAT 5
#define NC_DOUBLE 6

extern "C" {

// ---------------------------------------------------------------------------
// thin NetCDF wrappers (typed, size_t-safe across the ctypes boundary)
// ---------------------------------------------------------------------------
int vicio_has_netcdf(void) { return nc_open != nullptr; }

const char *vicio_nc_strerror(int err) { return nc_strerror(err); }

int vicio_nc_open(const char *path, int write, int *ncid) {
  return nc_open(path, write ? NC_WRITE : NC_NOWRITE, ncid);
}
int vicio_nc_create(const char *path, int netcdf4, int *ncid) {
  return nc_create(path, NC_CLOBBER | (netcdf4 ? NC_NETCDF4 : 0), ncid);
}
int vicio_nc_close(int ncid) { return nc_close(ncid); }
int vicio_nc_enddef(int ncid) { return nc_enddef(ncid); }
int vicio_nc_redef(int ncid) { return nc_redef(ncid); }
int vicio_nc_sync(int ncid) { return nc_sync(ncid); }

int vicio_nc_def_dim(int ncid, const char *name, long long len, int *dimid) {
  return nc_def_dim(ncid, name, len < 0 ? NC_UNLIMITED : (size_t)len, dimid);
}
// xtype: 4=int 5=float 6=double
int vicio_nc_def_var(int ncid, const char *name, int xtype, int ndims,
                     const int *dimids, int *varid) {
  return nc_def_var(ncid, name, xtype, ndims, dimids, varid);
}
int vicio_nc_def_var_deflate(int ncid, int varid, int level) {
  return nc_def_var_deflate(ncid, varid, 1, level > 0, level);
}
int vicio_nc_put_att_text(int ncid, int varid, const char *name,
                          const char *value) {
  return nc_put_att_text(ncid, varid, name, strlen(value), value);
}
int vicio_nc_put_att_double(int ncid, int varid, const char *name,
                            double value) {
  return nc_put_att_double(ncid, varid, name, NC_DOUBLE, 1, &value);
}
int vicio_nc_put_att_int(int ncid, int varid, const char *name, int value) {
  return nc_put_att_int(ncid, varid, name, NC_INT, 1, &value);
}
int vicio_nc_inq_dimid(int ncid, const char *name, int *dimid) {
  return nc_inq_dimid(ncid, name, dimid);
}
int vicio_nc_inq_dimlen(int ncid, int dimid, long long *len) {
  size_t l = 0;
  int r = nc_inq_dimlen(ncid, dimid, &l);
  *len = (long long)l;
  return r;
}
int vicio_nc_inq_varid(int ncid, const char *name, int *varid) {
  return nc_inq_varid(ncid, name, varid);
}
int vicio_nc_inq_nvars(int ncid, int *nvars) { return nc_inq_nvars(ncid, nvars); }
int vicio_nc_inq_varname(int ncid, int varid, char *name256) {
  return nc_inq_varname(ncid, varid, name256);
}
int vicio_nc_inq_varndims(int ncid, int varid, int *nd) {
  return nc_inq_varndims(ncid, varid, nd);
}
int vicio_nc_inq_vardimid(int ncid, int varid, int *dimids) {
  return nc_inq_vardimid(ncid, varid, dimids);
}
int vicio_nc_get_att_double(int ncid, int varid, const char *name,
                            double *val) {
  return nc_get_att_double(ncid, varid, name, val);
}
// attribute and variable inquiry (varid -1: the global attributes)
int vicio_nc_inq_varnatts(int ncid, int varid, int *natts) {
  return nc_inq_varnatts(ncid, varid, natts);
}
int vicio_nc_inq_attname(int ncid, int varid, int attnum, char *name256) {
  return nc_inq_attname(ncid, varid, attnum, name256);
}
int vicio_nc_inq_att(int ncid, int varid, const char *name, int *xtype,
                     long long *len) {
  size_t l = 0;
  int r = nc_inq_atttype(ncid, varid, name, xtype);
  if (r == 0) r = nc_inq_attlen(ncid, varid, name, &l);
  *len = (long long)l;
  return r;
}
int vicio_nc_get_att_text(int ncid, int varid, const char *name, char *buf) {
  return nc_get_att_text(ncid, varid, name, buf);
}
int vicio_nc_inq_vartype(int ncid, int varid, int *xtype) {
  return nc_inq_vartype(ncid, varid, xtype);
}
int vicio_nc_inq_dimname(int ncid, int dimid, char *name256) {
  return nc_inq_dimname(ncid, dimid, name256);
}

int vicio_nc_put_vara_float(int ncid, int varid, const long long *start,
                            const long long *count, int ndims,
                            const float *data) {
  std::vector<size_t> s(ndims), c(ndims);
  for (int i = 0; i < ndims; i++) { s[i] = start[i]; c[i] = count[i]; }
  return nc_put_vara_float(ncid, varid, s.data(), c.data(), data);
}
int vicio_nc_put_vara_double(int ncid, int varid, const long long *start,
                             const long long *count, int ndims,
                             const double *data) {
  std::vector<size_t> s(ndims), c(ndims);
  for (int i = 0; i < ndims; i++) { s[i] = start[i]; c[i] = count[i]; }
  return nc_put_vara_double(ncid, varid, s.data(), c.data(), data);
}
int vicio_nc_put_vara_int(int ncid, int varid, const long long *start,
                          const long long *count, int ndims, const int *data) {
  std::vector<size_t> s(ndims), c(ndims);
  for (int i = 0; i < ndims; i++) { s[i] = start[i]; c[i] = count[i]; }
  return nc_put_vara_int(ncid, varid, s.data(), c.data(), data);
}
int vicio_nc_get_vara_float(int ncid, int varid, const long long *start,
                            const long long *count, int ndims, float *data) {
  std::vector<size_t> s(ndims), c(ndims);
  for (int i = 0; i < ndims; i++) { s[i] = start[i]; c[i] = count[i]; }
  return nc_get_vara_float(ncid, varid, s.data(), c.data(), data);
}
int vicio_nc_get_vara_double(int ncid, int varid, const long long *start,
                             const long long *count, int ndims, double *data) {
  std::vector<size_t> s(ndims), c(ndims);
  for (int i = 0; i < ndims; i++) { s[i] = start[i]; c[i] = count[i]; }
  return nc_get_vara_double(ncid, varid, s.data(), c.data(), data);
}

// ---------------------------------------------------------------------------
// fast ASCII table parser (forcing/soil/veg files)
// Replaces per-token Python parsing and the reference's fscanf loops
// (read_atmos_data.c ASCII path). Whitespace-separated doubles; '#'-comment
// and blank lines skipped. Returns number of rows parsed, or -1 on error.
// Rows shorter than ncols are zero-padded; longer rows are truncated.
// ---------------------------------------------------------------------------
long long vicio_read_ascii_table(const char *path, long long skip_rows,
                                 long long max_rows, int ncols, double *out) {
  FILE *f = fopen(path, "r");
  if (!f) return -1;
  std::vector<char> line(1 << 16);
  long long row = 0, skipped = 0;
  while (row < max_rows && fgets(line.data(), (int)line.size(), f)) {
    char *p = line.data();
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '#' || *p == '\n' || *p == '\r' || *p == '\0') continue;
    if (skipped < skip_rows) { skipped++; continue; }
    double *dst = out + row * ncols;
    int col = 0;
    while (col < ncols) {
      char *end = nullptr;
      double v = strtod(p, &end);
      if (end == p) break;
      dst[col++] = v;
      p = end;
    }
    for (; col < ncols; col++) dst[col] = 0.0;
    row++;
  }
  fclose(f);
  return row;
}

// ---------------------------------------------------------------------------
// VIC binary forcing reader (read_atmos_data.c BINARY path):
// interleaved int16 fields, signed flag + multiplier per field, optional
// byte-swap, optional header bytes to skip. Output is column-major per field:
// out[field * max_recs + rec]. Returns records read or -1.
// ---------------------------------------------------------------------------
long long vicio_read_vic_binary(const char *path, long long skip_bytes,
                                long long skip_recs, long long max_recs,
                                int nfields, const int *signed_flags,
                                const double *multipliers, int swap_bytes,
                                double *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  if (skip_bytes > 0) fseek(f, (long)skip_bytes, SEEK_SET);
  if (skip_recs > 0) fseek(f, (long)(skip_recs * nfields * 2), SEEK_CUR);
  std::vector<uint16_t> buf(nfields);
  long long rec = 0;
  while (rec < max_recs &&
         fread(buf.data(), 2, nfields, f) == (size_t)nfields) {
    for (int i = 0; i < nfields; i++) {
      uint16_t u = buf[i];
      if (swap_bytes) u = (uint16_t)(((u & 0xFF) << 8) | ((u >> 8) & 0xFF));
      double v = signed_flags[i] ? (double)(int16_t)u : (double)u;
      out[(long long)i * max_recs + rec] = v / multipliers[i];
    }
    rec++;
  }
  fclose(f);
  return rec;
}

// ---------------------------------------------------------------------------
// VIC binary state stream (StateIOBinary.c shape: raw little-endian doubles /
// ints appended per variable). Simple append/read of typed blocks.
// ---------------------------------------------------------------------------
long long vicio_write_doubles(const char *path, int append, const double *data,
                              long long n) {
  FILE *f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  long long w = (long long)fwrite(data, sizeof(double), (size_t)n, f);
  fclose(f);
  return w;
}

long long vicio_read_doubles(const char *path, long long offset_doubles,
                             double *data, long long n) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, (long)(offset_doubles * (long long)sizeof(double)), SEEK_SET);
  long long r = (long long)fread(data, sizeof(double), (size_t)n, f);
  fclose(f);
  return r;
}

int vicio_abi_version() { return 1; }

}  // extern "C"
