"""Array utilities, for numpy arrays and tensors.

Port of ``glomargridding_tpu/utils/arrays.py`` (``adjust_small_negative``
``:24``, ``intersect_mtlb`` ``:80``, ``cov_2_cor`` ``:125``,
``cor_2_cov`` ``:159``, ``get_spatial_mean`` ``:179``; the host-side
helpers ``find_nearest`` ``:45``, ``uncompress_masked`` ``:98``,
``is_iter`` ``:196``, ``sizeof_fmt`` ``:205``, ``mask_array`` ``:214``).
A numpy array takes the reference's numpy branch. A tensor stays on its
device: ``adjust_small_negative`` keeps the numpy branch's warnings, and
``cov_2_cor`` the branch-free form that the reference applies to device
arrays.
"""

from typing import Any
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


def find_nearest(array, values) -> tuple[np.ndarray, np.ndarray]:
    """Indices and values in `array` nearest to each element of `values`
    (numpy, host side). Exact midpoints between two elements resolve to
    the lower one on the ascending grids used throughout."""
    array = np.asarray(array)
    values = np.asarray(values)
    order = np.argsort(array, kind="stable")
    sorted_arr = array[order]
    pos = np.searchsorted(sorted_arr, values)
    pos = np.clip(pos, 1, len(sorted_arr) - 1)
    left = sorted_arr[pos - 1]
    right = sorted_arr[pos]
    take_right = np.abs(values - right) < np.abs(values - left)
    nearest = np.clip(np.where(take_right, pos, pos - 1), 0,
                      len(sorted_arr) - 1)
    idx = order[nearest]
    return idx.astype(np.int64), array[idx]


def uncompress_masked(
    compressed_array,
    mask,
    fill_value: Any = 0.0,
    apply_mask: bool = False,
    dtype=None,
):
    """Scatter a compressed (unmasked-only) vector back to full length
    (numpy, host side; a tensor comes to the host first). With
    `apply_mask` a ``numpy.ma.MaskedArray`` is returned; otherwise masked
    slots hold `fill_value`."""
    mask = np.asarray(mask, dtype=bool)
    if isinstance(compressed_array, torch.Tensor):
        compressed_array = compressed_array.detach().cpu().numpy()
    compressed_array = np.asarray(compressed_array)
    not_mask = ~mask
    if int(not_mask.sum()) != len(compressed_array):
        raise ValueError("Length of compressed_array does not align with mask")
    dtype = dtype or compressed_array.dtype
    uncompressed = np.empty_like(mask, dtype=dtype)
    uncompressed[not_mask] = compressed_array
    if apply_mask:
        return np.ma.masked_where(mask, uncompressed)
    uncompressed[mask] = fill_value
    return uncompressed


def is_iter(val: Any) -> bool:
    """True if the value is iterable."""
    try:
        iter(val)
        return True
    except TypeError:
        return False


def sizeof_fmt(num: float, suffix: str = "B") -> str:
    """Human-readable byte count (power-of-1024 units)."""
    for unit in ("", "Ki", "Mi", "Gi", "Ti", "Pi", "Ei", "Zi"):
        if abs(num) < 1024.0:
            return f"{num:3.1f}{unit}{suffix}"
        num /= 1024.0
    return f"{num:.1f}Yi{suffix}"


def mask_array(arr: np.ndarray) -> np.ma.MaskedArray:
    """Coerce a numpy array to a MaskedArray."""
    if isinstance(arr, np.ma.MaskedArray):
        return arr
    if isinstance(arr, np.ndarray):
        return np.ma.MaskedArray(arr)
    raise TypeError("Input is not a numpy array.")
