"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch twin. Sources live in ``csrc/`` and are built with nvcc at first
use (``build.py``); importing this package builds nothing."""

from .ellipse import (
    ellipse_covariance_cuda,
    ellipse_matvec,
    ellipse_sym,
    ellipse_tile,
    pack_points,
)
from .ellipse_nll import fisher_z_nll
from .pairwise import (
    DISTANCES,
    TILE_N,
    matern_covariance_cuda,
    pairwise_covariance,
    pairwise_covariance_torch,
)

__all__ = [
    "DISTANCES",
    "TILE_N",
    "ellipse_covariance_cuda",
    "ellipse_matvec",
    "ellipse_sym",
    "ellipse_tile",
    "fisher_z_nll",
    "matern_covariance_cuda",
    "pairwise_covariance",
    "pack_points",
    "pairwise_covariance_torch",
]
