"""PyTorch/CUDA port of glomargridding_tpu: streamed kriging on a GPU.

Runs the kernel-functional kriging path (``models.kernel_kriging``) with
every pairwise covariance tile built by a hand-written CUDA kernel for
Hopper (``ops.cuda``) when the tensors are on the card, and by its plain
PyTorch twin when they are on the CPU. Imports torch and numpy only;
importing it builds nothing and changes no global state.
"""

from .constants import RADIUS_OF_EARTH_KM
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
    "KrigingResult",
    "VariogramKernel",
    "crossval_from_covariance",
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
