"""Simulation time axis (make_dmy.c: year/month/day/hour/day_in_year of
every record, leap years included).

A copy of `make_time_axis` and its helpers from `vic_tpu/timeaxis.py`, so
that the port imports nothing of the JAX package. Built host-side once; the
step receives month and day-of-year as host ints.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def is_leap(year: int) -> bool:
    # Gregorian leap rule (make_dmy.c LEAPYR macro)
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def days_in_month(year: int, month: int) -> int:
    if month == 2 and is_leap(year):
        return 29
    return DAYS_IN_MONTH[month - 1]


@dataclass(frozen=True)
class TimeAxis:
    """Struct-of-arrays date vector for all model records."""
    year: np.ndarray        # int32 [nrecs]
    month: np.ndarray       # int32 [nrecs], 1-based
    day: np.ndarray         # int32 [nrecs], 1-based
    hour: np.ndarray        # int32 [nrecs], 0-23
    day_in_year: np.ndarray  # int32 [nrecs], 1-based

    @property
    def nrecs(self) -> int:
        return len(self.year)


def make_time_axis(startyear: int, startmonth: int, startday: int,
                   starthour: int, nrecs: int, dt_hours: int) -> TimeAxis:
    """The record time axis (make_dmy.c: fixed dt in hours, no calendar
    gaps, leap days included)."""
    years = np.empty(nrecs, np.int32)
    months = np.empty(nrecs, np.int32)
    days = np.empty(nrecs, np.int32)
    hours = np.empty(nrecs, np.int32)
    doys = np.empty(nrecs, np.int32)

    y, m, d, h = startyear, startmonth, startday, starthour
    doy = sum(days_in_month(y, mm) for mm in range(1, m)) + d
    for i in range(nrecs):
        years[i], months[i], days[i], hours[i], doys[i] = y, m, d, h, doy
        h += dt_hours
        while h >= 24:
            h -= 24
            d += 1
            doy += 1
            if d > days_in_month(y, m):
                d = 1
                m += 1
                if m > 12:
                    m = 1
                    y += 1
                    doy = 1
    return TimeAxis(years, months, days, hours, doys)
