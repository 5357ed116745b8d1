"""Calendar / pentad helpers (host side).

Port of ``glomargridding_tpu/utils/calendar.py:15-92``, on the stdlib;
pandas is imported inside ``get_month_midpoint``, the one function that
takes a series.
"""

from calendar import isleap, monthrange
from datetime import date, timedelta
from enum import IntEnum

import numpy as np


class MonthName(IntEnum):
    """Month number from name."""

    JANUARY = 1
    FEBRUARY = 2
    MARCH = 3
    APRIL = 4
    MAY = 5
    JUNE = 6
    JULY = 7
    AUGUST = 8
    SEPTEMBER = 9
    OCTOBER = 10
    NOVEMBER = 11
    DECEMBER = 12


def days_since_by_month(year: int, day: int) -> np.ndarray:
    """Days since `year`-01-`day` for the same day of each month of `year`.

    Used to populate netCDF monthly time axes with 'days since' units.

    Examples
    --------
    >>> days_since_by_month(1988, 14)
    array([  0,  31,  60,  91, 121, 152, 182, 213, 244, 274, 305, 335])
    """
    start = date(year, 1, day)
    return np.array(
        [(date(year, m, day) - start).days for m in range(1, 13)],
        dtype=np.int64,
    )


def get_date_index(year: int, month: int, start_year: int) -> int:
    """Index of (year, month) in a monthly series starting January of
    `start_year`."""
    return 12 * (year - start_year) + (month - 1)


def get_pentad_range(centre_date: date) -> tuple[date, date]:
    """Start/end dates of the pentad centred on `centre_date`.

    The 29th of February extends the containing pentad to six days: in a
    leap year the window is computed in a fixed non-leap year and mapped
    back, and a centre of 29 Feb yields 27 Feb - 2 Mar.
    """
    centre_year = centre_date.year
    if isleap(centre_year) and not (
        centre_date.month == 2 and centre_date.day == 29
    ):
        fake_non_leap_year = 2003
        current = centre_date.replace(year=fake_non_leap_year)
        start = (current - timedelta(days=2)).replace(year=centre_year)
        end = (current + timedelta(days=2)).replace(year=centre_year)
    else:
        start = centre_date - timedelta(days=2)
        end = centre_date + timedelta(days=2)
    return start, end


def get_month_midpoint(dates):
    """Exact half-way timestamp of the month for each datetime in the
    pandas series `dates`, e.g. January 1990 -> 1990-01-16 12:00."""
    import pandas as pd

    if not pd.api.types.is_datetime64_any_dtype(dates):
        raise TypeError("Input is not a datetime series")
    ts = pd.to_datetime(dates)
    starts = ts.dt.to_period("M").dt.start_time
    ndays = ts.dt.daysinmonth
    return starts + pd.to_timedelta(ndays * 12, unit="h")


def days_in_month(year: int, month: int) -> int:
    """Number of days in a given month."""
    return monthrange(year, month)[1]
