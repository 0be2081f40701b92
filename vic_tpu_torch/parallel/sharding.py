"""The cell axis split over several devices: the port's counterpart of
`vic_tpu/parallel/sharding.py`'s 1-D cell mesh.

The reference's only parallelism is OpenMP threads over grid cells
(vicNl.c:514-517): cells are independent columns with no halo exchange.
vic_tpu shards the leading cell axis of every array over a mesh; the port
gives each device a contiguous share of the block and its own step
(`driver.run_simulation(devices=[...])`), and runs the shares from one
host thread, or, where the step stops a loop on a test over the whole
batch, from a thread each, voting those tests (`parallel/votes.py`).
A block of cells is padded to a multiple of the device count with clones
of its last cell (`cells.pad_cell_tree`), device d takes cells
[d*k, (d+1)*k), and the shares' outputs and state are joined on the host
(`gather_cell_axis`) and unpadded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cells import _on_cells, slice_cell_tree


def pad_cells(n_cell: int, n_devices: int) -> int:
    """Cells must divide the devices: the count rounded up to a multiple
    of n_devices (the rest are clone cells)."""
    rem = n_cell % n_devices
    return n_cell if rem == 0 else n_cell + (n_devices - rem)


def shard_cell_axis(tree, n_cell: int, n_devices: int, axis: int = 0):
    """The n_devices shares of `tree`'s cell axis (n_cell, a multiple of
    n_devices): share d holds cells [d*k, (d+1)*k), k = n_cell //
    n_devices, as views on the tree's own device."""
    if n_cell % n_devices:
        raise ValueError(f"{n_cell} cells do not split over {n_devices} "
                         "devices; pad them first (pad_cells)")
    k = n_cell // n_devices
    return [slice_cell_tree(tree, d * k, (d + 1) * k, n_cell, axis)
            for d in range(n_devices)]


def gather_cell_axis(trees, n_share: int, axis: int = 0):
    """Join the shares `trees` (one per device, each leaf with n_share
    cells along `axis`) into one tree on the host: tensors move to the CPU
    and are concatenated, numpy arrays too; a leaf without the cell axis is
    taken from the first share."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        trees = [t.cpu() for t in trees]
        if len(trees) == 1 or not _on_cells(first, n_share, axis):
            return trees[0]
        return torch.cat(trees, axis)
    if isinstance(first, np.ndarray):
        if len(trees) == 1 or not _on_cells(first, n_share, axis):
            return first
        return np.concatenate(trees, axis)
    if isinstance(first, dict):
        return {k: gather_cell_axis([t[k] for t in trees], n_share, axis)
                for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: gather_cell_axis([getattr(t, f.name) for t in trees],
                                     n_share, axis)
            for f in dataclasses.fields(first)})
    return first
