"""Array helpers shared by the kriging classes, the covariance builder
and the ellipse estimation, the unit conversions, and the entry points'
device rule."""

from .arrays import (
    adjust_small_negative,
    cor_2_cov,
    cov_2_cor,
    find_nearest,
    get_spatial_mean,
    intersect_mtlb,
    is_iter,
    mask_array,
    sizeof_fmt,
    uncompress_masked,
)
from .device import resolve_device
from .frames import (
    ColumnNotFoundError,
    check_cols,
    deg_to_km,
    deg_to_nm,
    km_to_deg,
)

__all__ = [
    "ColumnNotFoundError",
    "adjust_small_negative",
    "check_cols",
    "cor_2_cov",
    "cov_2_cor",
    "deg_to_km",
    "deg_to_nm",
    "find_nearest",
    "get_spatial_mean",
    "intersect_mtlb",
    "is_iter",
    "km_to_deg",
    "mask_array",
    "resolve_device",
    "sizeof_fmt",
    "uncompress_masked",
]
