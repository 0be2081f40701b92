"""Cell-axis blocks: slice, pad and unpad every per-cell array of a
parameter, state or forcing tree.

A copy of `vic_tpu/parallel/sharding.py:55-105` for the driver's cell
blocks and their device shares (`parallel/sharding.py`). A tree is a
tensor or numpy array, a dataclass or dict of them, or None; a leaf is
touched when its `axis` dimension has the cell count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply `fn` to every tensor/array leaf of `tree`."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _on_cells(x, n_cell, axis):
    return x.ndim > axis and x.shape[axis] == n_cell


def pad_cell_tree(tree, n_cell: int, n_pad: int, axis: int = 0):
    """Pad every leaf whose `axis` dim equals n_cell with n_pad copies of its
    last cell. Padding cells are real-valued clones of an existing cell, so
    every physics kernel stays well-conditioned on them; their outputs are
    sliced off by `unpad_cell_tree`."""
    if tree is None or n_pad == 0:
        return tree

    def pad(x):
        if not _on_cells(x, n_cell, axis):
            return x
        idx = [n_cell - 1] * n_pad
        if isinstance(x, torch.Tensor):
            edge = x.index_select(axis, torch.tensor(idx, device=x.device))
            return torch.cat([x, edge], axis)
        return np.concatenate([x, np.take(x, idx, axis=axis)], axis=axis)

    return tree_map(pad, tree)


def slice_cell_tree(tree, start: int, stop: int, n_cell: int, axis: int = 0):
    """Slice [start:stop) of the cell axis from every leaf whose `axis` dim
    equals n_cell (the same leaf-selection rule as pad/unpad): the driver
    streams a large domain through the step block by block, as the
    reference loops over cells (vicNl.c:514-517)."""
    def f(x):
        if not _on_cells(x, n_cell, axis):
            return x
        idx = tuple(slice(start, stop) if d == axis else slice(None)
                    for d in range(x.ndim))
        return x[idx]

    return tree_map(f, tree)


def unpad_cell_tree(tree, n_padded: int, n_cell: int, axis: int = 0):
    """Inverse of pad_cell_tree: slice leaves back to the real cell count."""
    if tree is None or n_padded == n_cell:
        return tree
    return slice_cell_tree(tree, 0, n_cell, n_padded, axis)
