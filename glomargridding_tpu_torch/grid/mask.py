"""Masks: apply grid masks to observation frames and gridded arrays.

Port of ``glomargridding_tpu/grid/mask.py:19-203`` (mask_observations,
mask_array, mask_dataset, mask_from_obs_frame, mask_from_obs_array,
get_mask_idx), on pandas frames (pandas is imported by the functions
that build one) and the labeled-array containers, on the host.
"""

from typing import Any
from warnings import warn

import numpy as np
import torch

from ..core.labeled import DataArray, Dataset, _host, align_exact
from ..utils.frames import check_cols
from .grid import map_to_grid


def mask_observations(
    obs,
    mask,
    varnames: str | list[str],
    masked_value: Any = np.nan,
    mask_value: Any = True,
    obs_coords: list[str] = ["lat", "lon"],
    mask_coords: list[str] = ["latitude", "longitude"],
    align_to_mask: bool = False,
    drop: bool = False,
    mask_grid_prefix: str = "_mask_grid_",
):
    """Mask observation-frame variables by a mask grid.

    Observations are snapped to the mask's grid; rows landing on cells
    whose mask equals `mask_value` get `masked_value` written into each of
    `varnames` (or are dropped with `drop=True`). With `align_to_mask` the
    snapped grid coordinates are kept, effectively adopting the mask's
    grid as the output grid.
    """
    varnames = [varnames] if isinstance(varnames, str) else varnames
    check_cols(obs, varnames)

    grid_idx_name = mask_grid_prefix + "idx"
    if grid_idx_name in obs.columns:
        warn(
            f"Mask grid idx column '{grid_idx_name}' already in "
            "observational DataFrame, values will be overwritten"
        )
    obs = map_to_grid(
        obs=obs,
        grid=mask,
        obs_coords=obs_coords,
        grid_coords=mask_coords,
        grid_prefix=mask_grid_prefix,
        sort=False,
        add_grid_pts=align_to_mask,
    )

    mask_flat = _host(mask.values).flatten(order="C")
    obs = obs.copy()
    obs["_mask"] = mask_flat[obs[grid_idx_name].to_numpy()]

    if mask_value is np.nan:
        is_masked = obs["_mask"].isna()
    else:
        is_masked = obs["_mask"] == mask_value

    if drop:
        out = obs[~is_masked].drop(
            columns=[grid_idx_name, "_mask"]
        )
        return out.reset_index(drop=True)
    for var in varnames:
        obs.loc[is_masked, var] = masked_value
    return obs.drop(columns=[grid_idx_name, "_mask"])


def mask_array(
    grid: DataArray,
    mask: DataArray,
    masked_value: Any = np.nan,
    mask_value: Any = True,
) -> DataArray:
    """Apply a mask grid to a DataArray (coordinate systems must align
    exactly)."""
    if not isinstance(grid, DataArray):
        raise TypeError("Input 'grid' must be a DataArray")
    align_exact(grid, mask)
    masked_idx = np.unravel_index(
        get_mask_idx(mask, mask_value), mask.shape
    )
    grid.values[masked_idx] = masked_value
    return grid


def mask_dataset(
    dataset: Dataset,
    mask: DataArray,
    varnames: str | list[str],
    masked_value: Any = np.nan,
    mask_value: Any = True,
) -> Dataset:
    """Apply a mask grid to chosen variables of a Dataset.


    """
    if not isinstance(dataset, Dataset):
        raise TypeError("Input 'dataset' must be a Dataset")
    varnames = [varnames] if isinstance(varnames, str) else varnames
    masked_idx = np.unravel_index(
        get_mask_idx(mask, mask_value), mask.shape
    )
    for var in varnames:
        align_exact(dataset[var], mask)
        dataset[var].values[masked_idx] = masked_value
    return dataset


def mask_from_obs_frame(
    obs,
    coords: str | list[str],
    value_col: str,
    datetime_col: str | None = None,
    grid=None,
    grid_coords: str | list[str] | None = None,
):
    """Mask = positions with NO observations at ANY datetime.

    With a grid, observations are first snapped to it so empty grid cells
    are included; without one, the frame is assumed to already cover the
    full grid (nulls marking empties). Returns coords + boolean "mask"
    column.
    """
    import pandas as pd

    if isinstance(coords, str):
        coords = [coords]
    if isinstance(grid_coords, str):
        grid_coords = [grid_coords]

    if grid is not None:
        if grid_coords is None:
            raise ValueError("grid_coords must be set if grid is set.")
        obs = map_to_grid(
            obs, grid, obs_coords=coords, grid_coords=grid_coords
        )
        # Adopt the snapped grid positions as the authoritative coords.
        obs = obs.drop(columns=coords).rename(
            columns={f"grid_{c}": c for c in coords}
        )
        # Full cross product of the grid coordinates, named like the obs.
        mesh = np.meshgrid(
            *[np.asarray(grid.coords[c]) for c in grid_coords],
            indexing="ij",
        )
        grid_df = pd.DataFrame(
            {c: m.ravel() for c, m in zip(coords, mesh)}
        )
        obs = grid_df.merge(obs, on=coords, how="left")

    datetime_col = datetime_col or "datetime"
    if datetime_col not in obs.columns:
        obs = obs.copy()
        obs[datetime_col] = 1

    pivot = obs.pivot_table(
        index=coords,
        columns=datetime_col,
        values=value_col,
        aggfunc="first",
        dropna=False,
    )
    out = pivot.isna().all(axis=1).rename("mask").reset_index()
    return out


def mask_from_obs_array(obs, datetime_idx: int):
    """Mask from an array: True where all values along the time axis are
    NaN (e.g. land points in an SST cube).
   """
    values = _host(obs.values if isinstance(obs, DataArray) else obs)
    mask = np.isnan(values).all(axis=datetime_idx)
    if isinstance(obs, DataArray):
        coords = {
            k: v
            for i, (k, v) in enumerate(obs.coords.items())
            if i != datetime_idx
        }
        return DataArray(mask, coords, name="mask")
    return mask


def get_mask_idx(
    mask, mask_val: Any = np.nan, masked: bool = True
) -> np.ndarray:
    """1-d (C-order) indices of (un)masked cells of a mask grid.


    """
    values = _host(mask if isinstance(mask, torch.Tensor)
                   or not hasattr(mask, "values") else mask.values)
    if mask_val is np.nan:
        condition = np.isnan(values)
    else:
        condition = values == mask_val
    flat = condition.flatten(order="C")
    return np.argwhere(flat if masked else ~flat)
