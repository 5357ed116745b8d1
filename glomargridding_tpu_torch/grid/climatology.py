"""Climatology joins and anomaly computation.

Port of ``glomargridding_tpu/grid/climatology.py:17-114``: merge a 365-day daily
climatology into an observation frame by day-of-year + nearest gridpoint
(29 Feb handled as the mean of DOY 59/60), compute anomalies, and load
bounded climatology files. Host code; pandas is imported by the join.
"""

import numpy as np

from ..core.labeled import Dataset, _host, select_bounds
from ..io.netcdf import load_dataset
from ..utils.arrays import find_nearest


def join_climatology_by_doy(
    obs_df,
    climatology_365,
    lat_col: str = "lat",
    lon_col: str = "lon",
    date_col: str = "date",
    var_col: str = "sst",
    clim_lat: str = "latitude",
    clim_lon: str = "longitude",
    clim_doy: str = "doy",
    clim_var: str = "climatology",
    temp_from_kelvin: bool = True,
):
    """Join a daily (365-day) climatology by day-of-year and position.

    Observations dated 29 Feb get the mean of the 28 Feb / 1 Mar
    climatology. Adds ``{var}_climatology`` and ``{var}_anomaly`` columns.
    """
    import pandas as pd

    clim_var_name = f"{var_col}_climatology"
    anom_var_name = f"{var_col}_anomaly"

    clim_arr = climatology_365[clim_var]
    clim_values = _host(clim_arr.values).astype(float)
    if temp_from_kelvin:
        clim_values = clim_values - 273.15
    dims = clim_arr.dims
    # bring to (doy, lat, lon) order
    order = [dims.index(d) for d in (clim_doy, clim_lat, clim_lon)]
    clim_values = np.transpose(clim_values, order)

    lat_vals_grid = np.asarray(clim_arr.coords[clim_lat])
    lon_vals_grid = np.asarray(clim_arr.coords[clim_lon])
    doy_vals = np.asarray(clim_arr.coords[clim_doy])
    if np.issubdtype(doy_vals.dtype, np.datetime64):
        doy_vals = (
            pd.to_datetime(doy_vals).dayofyear.to_numpy()  # type: ignore
        )
    doy_pos = {int(d): i for i, d in enumerate(doy_vals)}

    obs_df = obs_df.copy()
    lat_idx, _ = find_nearest(lat_vals_grid, obs_df[lat_col].to_numpy())
    lon_idx, _ = find_nearest(lon_vals_grid, obs_df[lon_col].to_numpy())

    dates = pd.to_datetime(obs_df[date_col])
    is_leap_day = dates.dt.is_leap_year & (dates.dt.dayofyear == 60)

    # non-leap-day obs: day-of-year in a fixed non-leap calendar
    doy = pd.to_datetime(
        {
            "year": 2009,
            "month": dates.dt.month.where(~is_leap_day, 3),
            "day": dates.dt.day.where(~is_leap_day, 1),
        }
    ).dt.dayofyear.to_numpy()
    doy_idx = np.array([doy_pos.get(int(d), -1) for d in doy])

    clim = np.full(len(obs_df), np.nan)
    ok = doy_idx >= 0
    clim[ok] = clim_values[doy_idx[ok], lat_idx[ok], lon_idx[ok]]

    # 29 Feb: mean of DOY 59 and 60
    if is_leap_day.any():
        i59 = doy_pos.get(59)
        i60 = doy_pos.get(60)
        leap_sel = is_leap_day.to_numpy()
        pair = 0.5 * (
            clim_values[i59, lat_idx[leap_sel], lon_idx[leap_sel]]
            + clim_values[i60, lat_idx[leap_sel], lon_idx[leap_sel]]
        )
        clim[leap_sel] = pair

    obs_df[clim_var_name] = clim
    obs_df[anom_var_name] = obs_df[var_col] - obs_df[clim_var_name]
    return obs_df


def read_climatology(
    clim_path: str,
    min_lat: float = -90,
    max_lat: float = 90,
    min_lon: float = -180,
    max_lon: float = 180,
    lat_var: str = "lat",
    lon_var: str = "lon",
    **kwargs,
) -> Dataset:
    """Load a climatology netCDF bounded by lat/lon limits.

    Path may be a str.format template resolved with kwargs.
    """
    clim_ds = load_dataset(clim_path, **kwargs)
    return select_bounds(
        clim_ds,
        bounds=[(min_lat, max_lat), (min_lon, max_lon)],
        variables=[lat_var, lon_var],
    )
