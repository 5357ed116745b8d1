"""Non-stationary covariance from per-gridpoint ellipse parameters, and
the estimation of those parameters from a training cube."""

from .covariance import (
    EllipseCovarianceBuilder,
    build_ellipse_covariance,
    ellipse_covariance_block,
    ellipse_covariance_operator,
)
from .estimate import CellFits, EllipseBuilder, init_parameter_set
from .model import EllipseModel, cov_ij_anisotropic, cov_ij_isotropic

__all__ = [
    "CellFits",
    "EllipseBuilder",
    "EllipseCovarianceBuilder",
    "EllipseModel",
    "build_ellipse_covariance",
    "cov_ij_anisotropic",
    "cov_ij_isotropic",
    "ellipse_covariance_block",
    "ellipse_covariance_operator",
    "init_parameter_set",
]
