"""NetCDF output in shards: a copy of `vic_tpu/parallel/io_shards.py` on
the port's `output.NetCDFOutputWriter`.

The reference writes one NetCDF file for the whole domain from a single
thread after the cell loop (vicNl.c:596-597, WriteOutputNetCDF.c:387
write_data_all_cells). With OUTPUT_SHARDS > 1 the cell axis is cut into
contiguous blocks and each block is written to a shard file of its own
(`<root>.shard<i>of<n><ext>`); `merge_shards`
(tools/merge_output_shards_torch.py) gathers them offline onto one
reference-layout file. The port runs in one process, which writes every
shard; `process_index`/`process_count` keep vic_tpu's shard-to-process
mapping (block i -> process i*P/N) for a caller that runs several.
"""
from __future__ import annotations

import os
import re

import numpy as np


def shard_ranges(n_cell: int, n_shards: int):
    """Contiguous cell blocks per shard: equal blocks, the remainder
    spread over the leading shards (vic_tpu's layout)."""
    base, rem = divmod(n_cell, n_shards)
    out, start = [], 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def shard_path(base_path: str, i: int, n: int) -> str:
    root, ext = os.path.splitext(base_path)
    return f"{root}.shard{i}of{n}{ext or '.nc'}"


def write_sharded_netcdf(base_path: str, lats, lons, agg: dict, tvals,
                         n_shards: int, *, nlayer=3, nnode=3, nband=1,
                         global_attrs=None, compress=0,
                         process_index: int = 0, process_count: int = 1):
    """Write the shard files of the cell blocks this process owns (every
    shard in a one-process run); returns their paths. With several
    processes, block i goes to process i*P/N, the contiguous order of the
    devices' shares."""
    from ..output import NetCDFOutputWriter

    lats = np.asarray(lats)
    lons = np.asarray(lons)
    paths = []
    for i, (s, e) in enumerate(shard_ranges(len(lats), n_shards)):
        if n_shards >= process_count and \
                (i * process_count) // n_shards != process_index:
            continue
        if e <= s:
            continue
        path = shard_path(base_path, i, n_shards)
        attrs = dict(global_attrs or {})
        attrs["vic_tpu_shard"] = f"{i} of {n_shards} cells {s}:{e}"
        w = NetCDFOutputWriter(path, lats[s:e], lons[s:e],
                               list(agg.keys()), nlayer=nlayer, nnode=nnode,
                               nband=nband, global_attrs=attrs,
                               compress=compress)
        w.write_all({k: v[:, s:e] for k, v in agg.items()}, tvals)
        w.close()
        paths.append(path)
    return paths


def find_shards(base_path: str):
    """All shard files belonging to base_path, sorted by shard index."""
    root, ext = os.path.splitext(base_path)
    ext = ext or ".nc"
    d = os.path.dirname(root) or "."
    pat = re.compile(re.escape(os.path.basename(root))
                     + r"\.shard(\d+)of(\d+)" + re.escape(ext) + "$")
    hits = []
    for fn in os.listdir(d):
        m = pat.match(fn)
        if m:
            hits.append((int(m.group(1)), os.path.join(d, fn)))
    return [p for _, p in sorted(hits)]


def merge_shards(base_path: str, out_path: str = None) -> str:
    """Merge shard files into one reference-layout NetCDF (offline gather).

    Scatters every shard's cells onto the union lat/lon grid; the merged
    file matches a single-writer run and feeds the same comparator
    (tools/vic_output_compare_netcdf_universal equivalent).
    """
    from ..io.native import NetCDFFile
    from ..output import OUTVAR_META, NetCDFOutputWriter

    paths = find_shards(base_path)
    if not paths:
        raise FileNotFoundError(f"no shards found for {base_path}")
    out_path = out_path or base_path

    by_ncname = {m.nc_name: (k, m) for k, m in OUTVAR_META.items()}
    FILL = 1.0e20

    lats, lons, series = [], [], []
    var_names = None
    tvals = None
    dims_kn = {}
    for p in paths:
        with NetCDFFile(p) as f:
            nlat, nlon = f.dim_len("lat"), f.dim_len("lon")
            lat = f.get("lat", [0], [nlat], np.float64)
            lon = f.get("lon", [0], [nlon], np.float64)
            nt = f.dim_len("time")
            if tvals is None:
                tvals = f.get("time", [0], [nt], np.float64)
            for d in ("depth", "node", "band", "front"):
                dims_kn[d] = f.dim_len(d)
            present = [v for v in f.var_names() if v in by_ncname]
            if var_names is None:
                var_names = present
            data = {}
            probe = None
            for v in present:
                out_name, m = by_ncname[v]
                k = (dims_kn["depth"] if m.dim == "layer" else
                     dims_kn["node"] if m.dim == "node" else
                     dims_kn["band"] if m.dim == "band" else
                     dims_kn["front"] if m.dim == "front" else 0)
                shape = [nt] + ([k] if k else []) + [nlat, nlon]
                arr = f.get(v, [0] * len(shape), shape, np.float64)
                data[out_name] = arr
                if probe is None and not k:
                    probe = arr
            valid = np.abs(probe[0]) < FILL * 0.5
            for il in range(nlat):
                for jl in range(nlon):
                    if valid[il, jl]:
                        lats.append(lat[il])
                        lons.append(lon[jl])
                        series.append({n: a[..., il, jl]
                                       for n, a in data.items()})

    agg = {}
    for v in var_names:
        out_name = by_ncname[v][0]
        stacked = np.stack([cv[out_name] for cv in series], axis=-1)
        if stacked.ndim == 3:                     # [time, k, cell]
            stacked = np.moveaxis(stacked, 1, -1)  # -> [time, cell, k]
        agg[out_name] = stacked
    tmp = out_path + ".merge_tmp"
    w = NetCDFOutputWriter(tmp, np.array(lats), np.array(lons),
                           list(agg.keys()), nlayer=dims_kn["depth"],
                           nnode=dims_kn["node"], nband=dims_kn["band"])
    w.write_all(agg, tvals)
    w.close()
    os.replace(tmp, out_path)
    return out_path
