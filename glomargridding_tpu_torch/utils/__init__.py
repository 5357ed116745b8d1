"""Array helpers shared by the kriging classes and the covariance builder,
and the entry points' device rule."""

from .arrays import (
    adjust_small_negative,
    cor_2_cov,
    cov_2_cor,
    get_spatial_mean,
    intersect_mtlb,
)
from .device import resolve_device

__all__ = [
    "adjust_small_negative",
    "cor_2_cov",
    "cov_2_cor",
    "get_spatial_mean",
    "intersect_mtlb",
    "resolve_device",
]
