from .kernel_kriging import (
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

__all__ = [
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
]
