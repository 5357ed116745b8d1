"""Non-stationary covariance from per-gridpoint ellipse parameters."""

from .covariance import (
    EllipseCovarianceBuilder,
    build_ellipse_covariance,
    ellipse_covariance_block,
    ellipse_covariance_operator,
)

__all__ = [
    "EllipseCovarianceBuilder",
    "build_ellipse_covariance",
    "ellipse_covariance_block",
    "ellipse_covariance_operator",
]
