#!/usr/bin/env python
"""Merge the NetCDF output shards of a vic_tpu_torch run into one
reference-layout file.

Usage: python tools/merge_output_shards_torch.py <base_output.nc> [-o merged.nc]

A run with OUTPUT_SHARDS N > 1 writes <base>.shardKofN.nc next to the base
path (vic_tpu_torch.parallel.io_shards.write_sharded_netcdf); this gathers
them onto the union lat/lon grid, the file a single writer would have
written. Imports only vic_tpu_torch.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("base", help="base output path (e.g. results.nc)")
    ap.add_argument("-o", "--out", default=None,
                    help="merged output path (default: the base path)")
    args = ap.parse_args()
    from vic_tpu_torch.parallel.io_shards import merge_shards
    out = merge_shards(args.base, args.out)
    print(f"merged -> {out}")


if __name__ == "__main__":
    main()
