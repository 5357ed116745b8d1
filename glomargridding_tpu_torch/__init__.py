"""PyTorch/CUDA port of glomargridding_tpu: kriging on a GPU.

Two paths. Streamed kriging (``models.kernel_kriging``) builds every
stationary covariance tile with a hand-written CUDA kernel. The
non-stationary path (``models.ellipse``) assembles the Paciorek-Schervish
covariance, or its matvec operator, with three more, and the dense
kriging classes (``models.kriging``) krige against it. On the card the
kernels (``ops.cuda``) run; on the CPU, their plain PyTorch twins.
Imports torch and numpy only; importing it builds nothing and changes
no global state.
"""

from .constants import RADIUS_OF_EARTH_KM
from .models.ellipse import (
    EllipseCovarianceBuilder,
    build_ellipse_covariance,
    ellipse_covariance_operator,
)
from .models.kernel_kriging import (
    CrossValResult,
    KrigingResult,
    VariogramKernel,
    crossval_from_covariance,
    ensemble_from_kernel,
    kriging_crossval,
    kriging_from_kernel,
    months_scan_kriging,
    pad_month_observations,
    variogram_kernel,
)
from .models.kriging import OrdinaryKriging, SimpleKriging
from .ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
    Variogram,
    variogram_to_covariance,
)

__all__ = [
    "RADIUS_OF_EARTH_KM",
    "CrossValResult",
    "EllipseCovarianceBuilder",
    "KrigingResult",
    "OrdinaryKriging",
    "SimpleKriging",
    "VariogramKernel",
    "build_ellipse_covariance",
    "crossval_from_covariance",
    "ellipse_covariance_operator",
    "ensemble_from_kernel",
    "kriging_crossval",
    "kriging_from_kernel",
    "months_scan_kriging",
    "pad_month_observations",
    "variogram_kernel",
    "ExponentialVariogram",
    "GaussianVariogram",
    "MaternVariogram",
    "SphericalVariogram",
    "Variogram",
    "variogram_to_covariance",
]
