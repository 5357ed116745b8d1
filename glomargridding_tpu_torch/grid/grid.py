"""Grid construction and observation -> grid alignment.

Port of ``glomargridding_tpu/grid/grid.py:25-238``: regular lat/lon grid
build, snapping observations to their nearest grid points with a
row-major 1-d ``grid_idx`` (numpy "C" ravel order, the index convention
every solver consumes), scattering results back onto the grid, and the
grid's pairwise distance matrix. Frames are pandas (imported by the
functions that take one); grids are the ``core.labeled`` containers. The
raw-observation ingest (``aggregate_observations``) and the distance
matrix run on a device, by default the card; the rest is host code.
"""

import inspect
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..constants import RADIUS_OF_EARTH_KM
from ..core.labeled import Coordinates, DataArray, _host, select_bounds
from ..ops.distances import calculate_distance_matrix, haversine_matrix
from ..utils.arrays import find_nearest
from ..utils.device import resolve_device
from ..utils.frames import filter_bounds


def grid_from_resolution(
    resolution: float | list[float],
    bounds: list[tuple[float, float]],
    coord_names: list[str],
) -> DataArray:
    """Build a regular grid from per-coordinate resolutions and bounds.

    Bounds are ``(first_centre, open_upper)`` as in ``range``, e.g. a
    global 5-degree grid: ``bounds=[(-87.5, 90), (-177.5, 180)]``.
    """
    if not isinstance(resolution, Iterable):
        resolution = [resolution] * len(bounds)
    if len(resolution) != len(coord_names) or len(bounds) != len(coord_names):
        raise ValueError("Input lists must have the same length")
    coords = Coordinates(
        {
            name: np.arange(lo, hi, res)
            for name, (lo, hi), res in zip(coord_names, bounds, resolution)
        }
    )
    return DataArray(coords=coords)


def map_to_grid(
    obs,
    grid,
    obs_coords: list[str] = ["lat", "lon"],
    grid_coords: list[str] = ["latitude", "longitude"],
    sort: bool = True,
    bounds: list[tuple[float, float]] | None = None,
    add_grid_pts: bool = True,
    grid_prefix: str = "grid_",
):
    """Align an observation frame to a grid: nearest gridpoint per obs and
    its 1-d index.

    Adds ``{grid_prefix}idx`` (row-major C-order raveled index) and,
    optionally, the snapped grid coordinates per observation; sorts by
    grid index, stably, so downstream gridbox reductions see contiguous
    groups in the frame's own order.
    """
    if bounds is not None:
        grid = select_bounds(grid, bounds, grid_coords)
        obs = filter_bounds(obs, bounds, obs_coords)

    grid_size = grid.shape

    dim_idx: list[np.ndarray] = []
    snapped: list[np.ndarray] = []
    for grid_coord, obs_coord in zip(grid_coords, obs_coords):
        grid_pos = np.asarray(grid.coords[grid_coord])
        idx, vals = find_nearest(grid_pos, obs[obs_coord].to_numpy())
        dim_idx.append(idx)
        snapped.append(vals)

    flattened_idx = np.ravel_multi_index(dim_idx, grid_size, order="C")

    obs = obs.copy()
    obs[grid_prefix + "idx"] = flattened_idx
    if add_grid_pts:
        for vals, obs_coord in zip(snapped, obs_coords):
            obs[grid_prefix + obs_coord] = vals

    if sort:
        obs = obs.sort_values(
            grid_prefix + "idx", kind="stable"
        ).reset_index(drop=True)
    return obs


def aggregate_observations(
    lats,
    lons,
    values,
    grid,
    lat_coord: str | None = None,
    lon_coord: str | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw-observation ingest for REGULAR grids: snap + per-box mean.

    Maps millions of raw observations to gridboxes and reduces them to
    one averaged value per occupied box, the (idx, obs) pair the kriging
    solvers consume, on `device` (with none, on the inputs' if one is a
    tensor, else on the card). Returns (unique_idx, means, counts) as
    int64, float64 and int64 tensors.

    For irregular grids or when per-record frames are needed (error
    covariance grouping), use ``map_to_grid`` + ``get_weights``.
    """
    from ..native import bin_mean, snap_to_grid

    device = resolve_device(device, lats, lons, values)
    names = list(grid.coords.keys())
    lat_coord = lat_coord or names[0]
    lon_coord = lon_coord or names[1]
    glat = np.asarray(grid.coords[lat_coord], dtype=float)
    glon = np.asarray(grid.coords[lon_coord], dtype=float)
    for name, axis in ((lat_coord, glat), (lon_coord, glon)):
        steps = np.diff(axis)
        if len(steps) and not np.allclose(steps, steps[0]):
            raise ValueError(
                f"grid axis '{name}' is not regular; use map_to_grid"
            )
    lat_step = float(glat[1] - glat[0]) if len(glat) > 1 else 1.0
    lon_step = float(glon[1] - glon[0]) if len(glon) > 1 else 1.0
    idx = snap_to_grid(
        lats, lons, float(glat[0]), lat_step, len(glat), float(glon[0]),
        lon_step, len(glon), device=device,
    )
    return bin_mean(idx, values, grid.size, device=device)


def assign_to_grid(
    values,
    grid_idx,
    grid,
    fill_value: Any = np.nan,
) -> DataArray:
    """Scatter a result vector (numpy, or a tensor on any device) onto the
    grid by 1-d C-order index, on the host."""
    values = _host(values)
    out = np.full(grid.shape, fill_value=fill_value, dtype=values.dtype)
    coords_to_assign = np.unravel_index(_host(grid_idx), grid.shape, "C")
    out[coords_to_assign] = values
    coords = grid.coords
    if not isinstance(coords, Coordinates):
        coords = Coordinates({k: np.asarray(v) for k, v in coords.items()})
    return DataArray(out, coords)


def cross_coords(coords, lat_coord: str, lon_coord: str) -> Coordinates:
    """Cross-product coordinate system for a distance matrix.

    Produces index_1/index_2 plus per-index lat/lon coordinate vectors
    (row-major over the grid).
    """
    if hasattr(coords, "coords") and not isinstance(coords, Coordinates):
        coords = coords.coords
    keys = list(coords.keys())
    if len(keys) != 2:
        raise ValueError(
            "Input grid must have 2 indexes - "
            "specifying latitude and longitude, in decimal degree."
        )
    if lat_coord not in keys:
        raise KeyError(
            f"Cannot find latitude coordinate {lat_coord} in the grid."
        )
    if lon_coord not in keys:
        raise KeyError(
            f"Cannot find longitude coordinate {lon_coord} in the grid."
        )
    first, second = keys
    a = np.asarray(coords[first])
    b = np.asarray(coords[second])
    # Row-major cross product in grid dimension order.
    aa = np.repeat(a, len(b))
    bb = np.tile(b, len(a))
    n = len(aa)
    per_dim = {first: aa, second: bb}
    out: dict[str, np.ndarray] = {
        "index_1": np.arange(n),
        "index_2": np.arange(n),
    }
    for i in (1, 2):
        for name in keys:
            out[f"{name}_{i}"] = per_dim[name]
    return Coordinates(out)


def haversine_tensor_from_frame(df, radius: float = RADIUS_OF_EARTH_KM,
                                device=None) -> torch.Tensor:
    """Pairwise haversine matrix of a frame's 'lat'/'lon' columns, as a
    tensor left on `device` (``haversine_matrix`` places it)."""
    return haversine_matrix(np.array(df["lat"], dtype=float),
                            np.array(df["lon"], dtype=float),
                            radius=radius, device=device)


def grid_to_distance_matrix(
    grid,
    dist_func: Callable = haversine_tensor_from_frame,
    lat_coord: str = "lat",
    lon_coord: str = "lon",
    device=None,
    **dist_kwargs,
) -> DataArray:
    """Pairwise distance matrix between all grid positions, on `device`
    (by default the card).

    Returns a DataArray over (index_1, index_2) whose values are a tensor
    on the device, with the crossed lat/lon kept in
    ``attrs['crossed_coords']``. A `dist_func` that takes ``device`` gets
    it; one that returns numpy has its matrix moved there.
    """
    device = resolve_device(device)
    out_coords = cross_coords(grid.coords, lat_coord, lon_coord)
    frame = {
        lat_coord: np.asarray(out_coords[f"{lat_coord}_1"]),
        lon_coord: np.asarray(out_coords[f"{lon_coord}_1"]),
    }
    if "device" in inspect.signature(dist_func).parameters:
        dist_kwargs = {"device": device, **dist_kwargs}
    dist = calculate_distance_matrix(
        frame,
        dist_func=dist_func,
        lat_col=lat_coord,
        lon_col=lon_coord,
        **dist_kwargs,
    )
    dist = torch.as_tensor(dist, device=device)
    n = dist.shape[0]
    main = Coordinates(
        {"index_1": np.arange(n), "index_2": np.arange(n)}
    )
    arr = DataArray(dist, main, name="dist")
    # Keep crossed coordinates available for consumers.
    arr.attrs["crossed_coords"] = {
        k: np.asarray(v)
        for k, v in out_coords.items()
        if k not in ("index_1", "index_2")
    }
    return arr
