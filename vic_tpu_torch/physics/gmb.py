"""Glacier mass-balance accumulation and the GMB-vs-elevation polynomial fit.

A copy of `vic_tpu/physics/gmb.py`, the PCIC RGM-coupling machinery:
- accumulation bookkeeping — accumulateGlacierMassBalance.c:13-67
  (per glacier HRU, cum_mass_balance += mass_balance once past the configured
  start date; reset at each interval boundary);
- per-step mass balance — surface_fluxes_glac.c:478:
  mass_balance = precip_in - liquid_out - snow_sublimation - ice_sublimation (m);
- quadratic fit b0 + b1*z + b2*z^2 of cumulative mass balance vs band
  elevation over a cell's glacier HRUs — GraphingEquation.c
  (least squares for >=3 points; a line through 2; a horizontal through 1).

The fit happens host-side at interval boundaries (a handful of points per
cell); `fit_gmb_polynomials` is vectorized over cells with numpy lstsq.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class GmbResult:
    """Per-cell polynomial b0 + b1*z + b2*z^2 (GlacierMassBalanceResult.h)."""
    b0: np.ndarray
    b1: np.ndarray
    b2: np.ndarray
    fit_error: np.ndarray     # rms residual of the fit
    n_points: np.ndarray
    date: tuple = None


def fit_gmb_polynomials(cum_mass_balance: np.ndarray, band_elev: np.ndarray,
                        is_glacier: np.ndarray, date=None) -> GmbResult:
    """Fit the GMB elevation polynomial for every cell.

    cum_mass_balance: [n_cell, max_hru] (m of water equivalent)
    band_elev:        [n_cell, max_hru] elevation of each HRU's band
    is_glacier:       [n_cell, max_hru] bool
    Duplicate elevations are merged by summation (GlacierMassBalanceResult.c
    constructor behavior).
    """
    n_cell = cum_mass_balance.shape[0]
    b0 = np.zeros(n_cell)
    b1 = np.zeros(n_cell)
    b2 = np.zeros(n_cell)
    err = np.zeros(n_cell)
    npts = np.zeros(n_cell, np.int32)

    for ci in range(n_cell):
        mask = is_glacier[ci]
        if not mask.any():
            continue
        z = band_elev[ci][mask].astype(np.float64)
        y = cum_mass_balance[ci][mask].astype(np.float64)
        # merge duplicate elevations by summing mass balance
        zu, inv = np.unique(z, return_inverse=True)
        yu = np.zeros_like(zu)
        np.add.at(yu, inv, y)
        n = len(zu)
        npts[ci] = n
        if n == 1:
            b0[ci] = yu[0]
        elif n == 2:
            slope = (yu[1] - yu[0]) / (zu[1] - zu[0])
            b1[ci] = slope
            b0[ci] = yu[0] - slope * zu[0]
        else:
            A = np.stack([np.ones_like(zu), zu, zu * zu], 1)
            coef, *_ = np.linalg.lstsq(A, yu, rcond=None)
            b0[ci], b1[ci], b2[ci] = coef
            resid = A @ coef - yu
            err[ci] = float(np.sqrt(np.mean(resid ** 2)))
    return GmbResult(b0=b0, b1=b1, b2=b2, fit_error=err, n_points=npts,
                     date=date)


class GmbAccumulator:
    """Drives the accumulation schedule across a run
    (accumulateGlacierMassBalance.c): call `maybe_emit` after each record with
    the current cumulative mass-balance state; returns a GmbResult at interval
    boundaries (and the caller resets the model's accumulator)."""

    def __init__(self, gp):
        self.start = (gp.glacier_accum_start_year,
                      gp.glacier_accum_start_month,
                      gp.glacier_accum_start_day)
        self.interval = max(1, gp.glacier_accum_interval)
        self.started = False
        self.results: List[GmbResult] = []

    def record_started(self, year, month, day) -> bool:
        if (year, month, day) == self.start:
            self.started = True
        return self.started

    def boundary(self, next_year, next_month, next_day) -> bool:
        """True when the NEXT record begins a new accumulation interval
        (accumulateGlacierMassBalance.c:40-47)."""
        y0 = self.start[0]
        return (next_year > y0
                and (next_year - y0) % self.interval == 0
                and next_month == self.start[1]
                and next_day == self.start[2])

    def maybe_emit(self, timeaxis, rec: int, cum_mb: np.ndarray,
                   band_elev: np.ndarray, is_glacier: np.ndarray
                   ) -> Optional[GmbResult]:
        self.record_started(int(timeaxis.year[rec]), int(timeaxis.month[rec]),
                            int(timeaxis.day[rec]))
        if rec + 1 >= timeaxis.nrecs:
            return None
        if not self.boundary(int(timeaxis.year[rec + 1]),
                             int(timeaxis.month[rec + 1]),
                             int(timeaxis.day[rec + 1])):
            return None
        res = fit_gmb_polynomials(
            cum_mb, band_elev, is_glacier,
            date=(int(timeaxis.year[rec]), int(timeaxis.month[rec]),
                  int(timeaxis.day[rec])))
        self.results.append(res)
        return res
