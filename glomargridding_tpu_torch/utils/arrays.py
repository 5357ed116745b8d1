"""Array utilities, for numpy arrays and tensors.

Port of ``glomargridding_tpu/utils/arrays.py`` (``adjust_small_negative``
``:24``, ``intersect_mtlb`` ``:80``, ``cov_2_cor`` ``:125``,
``cor_2_cov`` ``:159``, ``get_spatial_mean`` ``:179``). A numpy array takes the reference's numpy
branch. A tensor stays on its device: ``adjust_small_negative`` keeps the
numpy branch's warnings, and ``cov_2_cor`` the branch-free form that the
reference applies to device arrays.
"""

from warnings import warn

import numpy as np
import torch


def adjust_small_negative(mat, atol: float = 1e-8):
    """Clamp tiny negative values (|x| < atol) to zero.

    Warns if small negatives were clamped, and again if genuinely
    negative values remain.
    """
    small_negative = (mat < 0.0) & (abs(mat) < atol)
    ret = mat.clone() if isinstance(mat, torch.Tensor) else mat.copy()
    if small_negative.any():
        warn("Small negative vals are detected. Setting to 0.")
        ret[small_negative] = 0.0
    if (ret < 0).any():
        warn("Negative values are detected")
    return ret


def intersect_mtlb(a, b):
    """Matlab-style intersect: sorted common values and the indices of
    their FIRST occurrences in `a` and in `b` (numpy, host side)."""
    a = np.asarray(a)
    b = np.asarray(b)
    a1, ia = np.unique(a, return_index=True)
    b1, ib = np.unique(b, return_index=True)
    c, ca, cb = np.intersect1d(a1, b1, assume_unique=True,
                               return_indices=True)
    return c, ia[ca], ib[cb]


def cov_2_cor(cov, rounding: int | None = None):
    """Covariance matrix -> correlation matrix; zeros stay zero.

    numpy: validates that the diagonal is 1 within 1e-6 and sets it to 1
    exactly. Tensor: the diagonal is set to 1 without the check, as the
    reference does for device arrays.
    """
    if not isinstance(cov, torch.Tensor):
        stdevs = np.sqrt(np.diag(cov))
        cor = cov / np.outer(stdevs, stdevs)
        diag = np.diag(cor)
        if not np.all(diag == 1.0):
            bad_val = np.max(np.abs(diag - 1.0))
            if bad_val > 1e-6:
                raise ValueError(
                    "Correlation Diagonal contains values not close to 1. "
                    + f"With difference to 1: {bad_val}"
                )
            np.fill_diagonal(cor, 1.0)
        cor[cov == 0] = 0
        if rounding is not None:
            cor = np.round(cor, rounding)
        return cor
    stdevs = torch.sqrt(torch.diagonal(cov))
    cor = cov / torch.outer(stdevs, stdevs)
    cor.diagonal().fill_(1.0)
    cor = torch.where(cov == 0, torch.zeros_like(cor), cor)
    if rounding is not None:
        cor = torch.round(cor, decimals=rounding)
    return cor


def cor_2_cov(cor, variances, rounding: int | None = None):
    """Correlation matrix + variances -> covariance matrix; zeros stay
    zero (numpy or tensor)."""
    if not isinstance(cor, torch.Tensor):
        stdevs = np.sqrt(variances)
        cov = cor * np.outer(stdevs, stdevs)
        cov[cor == 0] = 0
        if rounding is not None:
            cov = np.round(cov, rounding)
        return cov
    stdevs = torch.sqrt(torch.as_tensor(variances, dtype=cor.dtype,
                                        device=cor.device))
    cov = cor * torch.outer(stdevs, stdevs)
    cov = torch.where(cor == 0, torch.zeros_like(cov), cov)
    if rounding is not None:
        cov = torch.round(cov, decimals=rounding)
    return cov


def get_spatial_mean(grid_obs, covx) -> float:
    """GLS spatial mean ``(1'C^{-1}1)^{-1} 1'C^{-1}z`` by a solve (no
    explicit inverse)."""
    if not isinstance(covx, torch.Tensor):
        u = np.linalg.solve(covx, np.ones(len(grid_obs)))
        return float((u @ np.asarray(grid_obs)) / u.sum())
    ones = torch.ones((covx.shape[0], 1), dtype=covx.dtype, device=covx.device)
    u = torch.cholesky_solve(ones, torch.linalg.cholesky(covx))[:, 0]
    z = torch.as_tensor(grid_obs, dtype=covx.dtype, device=covx.device)
    return float((u @ z) / torch.sum(u))
