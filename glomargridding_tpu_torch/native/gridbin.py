"""Observation -> grid binning on the device.

Port of ``glomargridding_tpu/native/gridbin.py:27-92``. ``snap_to_grid``
maps raw observation positions to row-major gridbox indices on a REGULAR
grid (irregular grids go through ``grid.map_to_grid``'s nearest-point
path); ``bin_mean`` reduces observation values to per-gridbox means.
Together they are the ingest of millions of raw observations a month.
The reference runs them on the host, in C or numpy; here the card does
the scatter itself, in float64: ``torch.round`` rounds half to even as
``np.rint`` does, and the sums are accumulated with ``index_add_``, whose
atomics on the card add in an order of their own (the means agree with a
host sum to rounding, the boxes and counts exactly).
"""

import torch

from ..utils.device import resolve_device


def snap_to_grid(
    lats,
    lons,
    lat0: float,
    lat_step: float,
    n_lat: int,
    lon0: float,
    lon_step: float,
    n_lon: int,
    device=None,
) -> torch.Tensor:
    """Nearest-gridbox C-order index (int64 tensor) per observation on a
    regular grid: round((x - x0) / step) per axis, clamped to the axis.
    On `device`; with none, on the inputs' if one is a tensor, else on the
    card."""
    device = resolve_device(device, lats, lons)
    lats = torch.as_tensor(lats, device=device).to(torch.float64)
    lons = torch.as_tensor(lons, device=device).to(torch.float64)
    i = torch.round((lats - lat0) / lat_step).long().clamp_(0, n_lat - 1)
    j = torch.round((lons - lon0) / lon_step).long().clamp_(0, n_lon - 1)
    return i * n_lon + j


def bin_mean(idx, values, n_boxes: int, device=None):
    """(unique_idx, means, counts) per occupied gridbox, as int64, float64
    and int64 tensors.

    `idx` are C-order gridbox indices (from ``snap_to_grid``), `values`
    the observation values. One scatter-add pass instead of a sort and a
    group-by. Placed as ``snap_to_grid`` places it.
    """
    device = resolve_device(device, idx, values)
    idx = torch.as_tensor(idx, device=device).long()
    values = torch.as_tensor(values, device=device).to(torch.float64)
    if idx.numel() and bool((idx.min() < 0) | (idx.max() >= n_boxes)):
        raise ValueError("gridbox index out of range")
    sums = torch.zeros(n_boxes, dtype=torch.float64, device=device)
    sums.index_add_(0, idx, values)
    counts = torch.bincount(idx, minlength=n_boxes)
    occupied = torch.nonzero(counts)[:, 0]
    n = counts[occupied]
    return occupied, sums[occupied] / n, n
