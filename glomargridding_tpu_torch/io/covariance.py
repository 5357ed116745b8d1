"""Load/save covariance matrices and factored covariances from/to netCDF.

Port of ``glomargridding_tpu/io/covariance.py:13-83``. ``save_lowrank``
and ``load_lowrank`` round-trip the port's ``LowRankPSD``; the loader
puts its factors on a device (by default the card).
"""

import numpy as np
import torch

from ..core.labeled import Coordinates, DataArray, Dataset, _host
from ..utils.device import resolve_device
from .netcdf import load_array, load_dataset, _resolve_path, save_dataset


def load_covariance(
    path: str, cov_var_name: str = "covariance", **kwargs
) -> np.ndarray:
    """Load a covariance matrix from a netCDF file.

    `path` may be a literal filename or a str.format template resolved with
    kwargs, e.g. ``/path/to/covariance_{month:02d}.nc``.
    """
    return np.asarray(load_array(path, cov_var_name, **kwargs).values)


def save_covariance(
    cov,
    path: str,
    cov_var_name: str = "covariance",
    **kwargs,
) -> None:
    """Persist a covariance matrix (numpy, or a tensor on any device) to
    netCDF, indices as coordinates."""
    cov = _host(cov)
    if kwargs:
        path = path.format(**kwargs)
    n, m = cov.shape
    coords = Coordinates(
        {"index_1": np.arange(n), "index_2": np.arange(m)}
    )
    arr = DataArray(cov, coords, name=cov_var_name)
    save_dataset(Dataset({cov_var_name: arr}, coords), path)


def save_lowrank(psd, path: str, **kwargs) -> None:
    """Persist a factored (clipped) covariance ``LowRankPSD`` to netCDF.

    The 1-degree production artifact is the FACTORED repaired covariance
    (diag(floor) + V diag(gains) V', ~n r floats), not the n x n matrix.
    `path` may be a str.format template resolved with kwargs.
    """
    if kwargs:
        path = path.format(**kwargs)
    V = _host(psd.vectors)
    g = _host(psd.gains)
    f = _host(psd.floor)
    n, r = V.shape
    coords = Coordinates({"index": np.arange(n), "mode": np.arange(r)})
    ds = Dataset(
        {
            "vectors": DataArray(V, coords, name="vectors"),
            "gains": DataArray(
                g, Coordinates({"mode": np.arange(r)}), name="gains"
            ),
            "floor": DataArray(
                f, Coordinates({"index": np.arange(n)}), name="floor"
            ),
        },
        coords,
    )
    save_dataset(ds, path)


def load_lowrank(path: str, device=None, **kwargs):
    """Load a ``LowRankPSD`` persisted by :func:`save_lowrank` onto
    `device` (by default the card), in the stored dtype."""
    from ..ops.covariance_tools import LowRankPSD

    device = resolve_device(device)
    ds = load_dataset(_resolve_path(path, **kwargs))
    return LowRankPSD(
        *(torch.as_tensor(np.asarray(ds[name].values), device=device)
          for name in ("vectors", "gains", "floor"))
    )
