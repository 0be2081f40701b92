"""Interpolation helpers, plain PyTorch.

Counterpart of `vic_tpu/ops/interp.py`: the cubic Hermite interpolation of
sub-daily air temperature (calc_air_temperature.c:20-69 `hermite`) and the
linear and exponential interpolation of modify_Ksat.c:7-15. Elementwise on
tensors that broadcast; no loop and no kernel.
"""
from __future__ import annotations

import torch


def hermite(x, x1, x2, y1, y2, dy1, dy2):
    """Cubic Hermite basis interpolation between (x1, y1, dy1) and
    (x2, y2, dy2) (calc_air_temperature.c:20-44)."""
    h = x2 - x1
    t = (x - x1) / h
    t2 = t * t
    t3 = t2 * t
    h01 = -2.0 * t3 + 3.0 * t2
    h00 = 1.0 - h01
    h10 = t3 - 2.0 * t2 + t
    h11 = t3 - t2
    return h00 * y1 + h01 * y2 + h * (h10 * dy1 + h11 * dy2)


def linear_interp(x, lx, ux, ly, uy):
    """(modify_Ksat.c linear_interp)"""
    return (x - lx) / (ux - lx) * (uy - ly) + ly


def exp_interp(x, lx, ux, ly, uy):
    """Exponential interpolation of cold-start soil temperature profiles
    (modify_Ksat.c exp_interp); ly = 0 reads as 1e-12 in the logarithm."""
    ly = torch.as_tensor(ly)
    safe_ly = torch.where(ly == 0.0, 1e-12, ly)
    return ly * torch.exp((x - lx) / (ux - lx) * torch.log(uy / safe_ly))
