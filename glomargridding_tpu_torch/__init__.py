"""PyTorch/CUDA port of glomargridding_tpu: kriging on a GPU.

Four paths. Streamed kriging (``models.kernel_kriging``) builds every
stationary covariance tile with a hand-written CUDA kernel. The
non-stationary path (``models.ellipse``) assembles the Paciorek-Schervish
covariance, or its matvec operator, with three more, and the dense
kriging classes (``models.kriging``, ``models.stochastic``) krige against
it. The factored path repairs the covariance operator to a positive
semi-definite low-rank form (``ops.eigsh``, ``ops.covariance_tools``) and
kriges and draws ensembles straight off the factors (``models.lowrank``).
The estimation path fits the per-gridpoint ellipse parameters that the
non-stationary path consumes from a training cube
(``models.ellipse.EllipseBuilder`` and ``EllipseModel``, on the batched
optimisers of ``ops.optim``), in plain PyTorch. Sampling and fitting:
exact stationary draws on a regular grid by spherical-harmonic synthesis
(``ops.sphere``), matrix-free Gaussian draws by Chebyshev matvecs
(``ops.sampling``) and variogram parameters by maximum likelihood
(``ops.variogram_fit``); Matern orders that are not half-integer take the
general-order K_nu of ``ops.special``. The host side: grids, masks and
climatology (``grid``), netCDF (``io``), the raw-observation binning on
the card (``native``), the observation-error covariance
(``ops.error_covariance``) and the host utilities (``utils``, ``config``).
On the card the kernels (``ops.cuda``) run; on the CPU, their plain
PyTorch twins.
Imports torch and numpy only (pandas and h5py are imported by the
functions that need them); importing it builds nothing and changes no
global state.
"""

from .constants import RADIUS_OF_EARTH_KM
from .core.labeled import Coordinates, DataArray, Dataset
from .grid.grid import (
    aggregate_observations,
    assign_to_grid,
    cross_coords,
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)
from .models.ellipse import (
    CellFits,
    EllipseBuilder,
    EllipseCovarianceBuilder,
    EllipseModel,
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
from .models.lowrank import (
    LowRankKrigingResult,
    lowrank_crossval,
    lowrank_ensemble_step,
    lowrank_kriging,
    lowrank_members_from_states,
    lowrank_months_scan,
)
from .models.stochastic import (
    StochasticKriging,
    batched_ensemble_step,
    mv_normal_draw,
    precompute_states,
)
from .ops.covariance_tools import (
    LowRankPSD,
    eigenvalue_clip,
    explained_variance_clip,
    explained_variance_clip_lowrank,
    laloux_clip,
    laloux_clip_lowrank,
    simple_clipping,
)
from .ops.error_covariance import (
    correlated_components,
    dist_weight,
    get_weights,
    gridbox_error_covariance,
    uncorrelated_components,
)
from .ops.eigsh import PartialSpectrumError, adaptive_topk_eigh, topk_eigh
from .ops.sampling import (
    Matvec,
    chebyshev_apply,
    dense_matvec,
    estimate_spectral_range,
    kernel_matvec,
    sample_mvn_chebyshev,
)
from .ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
    Variogram,
    variogram_to_covariance,
)
from .ops.variogram_fit import fit_variogram_mle, gp_negative_log_likelihood

__all__ = [
    "RADIUS_OF_EARTH_KM",
    "CellFits",
    "Coordinates",
    "CrossValResult",
    "DataArray",
    "Dataset",
    "EllipseBuilder",
    "EllipseCovarianceBuilder",
    "EllipseModel",
    "KrigingResult",
    "LowRankKrigingResult",
    "LowRankPSD",
    "Matvec",
    "OrdinaryKriging",
    "PartialSpectrumError",
    "SimpleKriging",
    "StochasticKriging",
    "VariogramKernel",
    "adaptive_topk_eigh",
    "aggregate_observations",
    "assign_to_grid",
    "batched_ensemble_step",
    "build_ellipse_covariance",
    "chebyshev_apply",
    "correlated_components",
    "cross_coords",
    "crossval_from_covariance",
    "dense_matvec",
    "dist_weight",
    "eigenvalue_clip",
    "ellipse_covariance_operator",
    "ensemble_from_kernel",
    "estimate_spectral_range",
    "explained_variance_clip",
    "explained_variance_clip_lowrank",
    "fit_variogram_mle",
    "get_weights",
    "gp_negative_log_likelihood",
    "grid_from_resolution",
    "grid_to_distance_matrix",
    "gridbox_error_covariance",
    "kernel_matvec",
    "kriging_crossval",
    "kriging_from_kernel",
    "laloux_clip",
    "laloux_clip_lowrank",
    "lowrank_crossval",
    "lowrank_ensemble_step",
    "lowrank_kriging",
    "lowrank_members_from_states",
    "lowrank_months_scan",
    "map_to_grid",
    "months_scan_kriging",
    "mv_normal_draw",
    "pad_month_observations",
    "precompute_states",
    "sample_mvn_chebyshev",
    "simple_clipping",
    "topk_eigh",
    "uncorrelated_components",
    "variogram_kernel",
    "ExponentialVariogram",
    "GaussianVariogram",
    "MaternVariogram",
    "SphericalVariogram",
    "Variogram",
    "variogram_to_covariance",
]
