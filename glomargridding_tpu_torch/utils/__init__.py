"""Array helpers shared by the kriging classes and the covariance builder."""

from .arrays import (
    adjust_small_negative,
    cov_2_cor,
    get_spatial_mean,
    intersect_mtlb,
)

__all__ = [
    "adjust_small_negative",
    "cov_2_cor",
    "get_spatial_mean",
    "intersect_mtlb",
]
