"""Observation-error covariance assembly.

Port of ``glomargridding_tpu/ops/error_covariance.py:21-162``:
uncorrelated (diagonal) and correlated (group-block) components from
group sigma assignments, within-gridbox distance matrices, and
gridbox-averaging weight matrices, built on the host from pandas frames
(pandas is imported by the functions that read one), and their reduction
to gridbox level, W E W', on a device (by default the card).
"""

from typing import Callable
from warnings import warn

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.frames import check_cols


def uncorrelated_components(
    df,
    group_col: str = "data_type",
    obs_sig_col: str | None = None,
    obs_sig_map: dict[str, float] | None = None,
) -> np.ndarray:
    """Diagonal (uncorrelated) error-covariance component.

    If `obs_sig_col` exists in the frame its values form the diagonal
    directly; otherwise the `group_col` values are mapped through
    `obs_sig_map` (sigma -> sigma^2, default 0 with warnings).
    """
    from ..utils.frames import ColumnNotFoundError

    if obs_sig_col is not None and obs_sig_col in df.columns:
        return np.diag(np.asarray(df[obs_sig_col], dtype=float))
    elif obs_sig_col is not None:
        raise ColumnNotFoundError(
            f"Observation Bias Column {obs_sig_col} not found."
        )

    obs_sig_map = obs_sig_map or {}
    sq_map = {k: v**2 for k, v in obs_sig_map.items()}
    s = (
        df[group_col]
        .map(lambda g: sq_map.get(g, 0.0))
        .to_numpy(dtype=float)
    )
    if (s == 0.0).all():
        warn("No values in obs_covariance set")
    elif (s == 0.0).any():
        warn("Some values in obs_covariance not set")
    return np.diag(s)


def correlated_components(
    df,
    group_col: str,
    bias_sig_col: str | None = None,
    bias_sig_map: dict[str, float] | None = None,
) -> np.ndarray:
    """Correlated (bias) error-covariance component.

    Produces a matrix that is block-diagonal under permutation by the group:
    entry (i, j) is the group's squared bias sigma when rows i and j share a
    group, else 0. Values come from `bias_sig_col` if present (first value
    per group, used as-is) or from `bias_sig_map` (sigma -> sigma^2).
    """
    import pandas as pd

    check_cols(df, [group_col])
    n = len(df)
    groups = df[group_col].to_numpy()

    if bias_sig_col is not None and bias_sig_col in df.columns:
        bias_vals = df[bias_sig_col].to_numpy(dtype=float)
        # first value per group
        first_per_group: dict = {}
        for g, b in zip(groups, bias_vals):
            first_per_group.setdefault(g, b)
        per_row = np.array([first_per_group[g] for g in groups], dtype=float)
    else:
        bias_sig_map = bias_sig_map or {}
        sq_map = {k: v**2 for k, v in bias_sig_map.items()}
        per_row = np.array(
            [sq_map.get(g, 0.0) for g in groups], dtype=float
        )
        if (per_row == 0.0).all():
            warn("No bias uncertainty values set")
        elif (per_row == 0.0).any():
            warn("Some bias uncertainty values not set")

    # One-hot group membership; the outer same-group test is vectorised.
    codes = pd.factorize(pd.Series(groups))[0]
    same_group = codes[:, None] == codes[None, :]
    covx = np.where(same_group, per_row[:, None], 0.0)
    assert covx.shape == (n, n)
    return covx


def dist_weight(
    df,
    dist_fn: Callable,
    grid_idx: str = "grid_idx",
    **dist_kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Within-gridbox distance matrix + gridbox-averaging weight matrix.

    `dist_fn(sub_frame, **kwargs)` produces the distance matrix for the
    records of a single gridbox; blocks are scattered into the full
    n_obs x n_obs matrix. `weights` is n_gridboxes x n_obs with rows equal
    to 1/count over the gridbox's records (rows ordered by sorted gridbox
    value).
    """
    gridboxes = sorted(df[grid_idx].unique())
    n_obs = len(df)
    weights = np.zeros((len(gridboxes), n_obs))
    dist = np.zeros((n_obs, n_obs))

    positions = np.arange(n_obs)
    df = df.reset_index(drop=True)
    for i, gb in enumerate(gridboxes):
        sel = df[grid_idx].to_numpy() == gb
        idcs = positions[sel]
        weights[i, idcs] = 1.0 / len(idcs)
        if dist_fn is not None:
            sub = df.loc[sel]
            dist[np.ix_(idcs, idcs)] = dist_fn(sub, **dist_kwargs)

    return dist, weights


def get_weights(
    df,
    grid_idx: str = "grid_idx",
) -> np.ndarray:
    """Gridbox-averaging weight matrix only (rows: sorted gridbox order).
    """
    import pandas as pd

    n_obs = len(df)
    codes, uniques = pd.factorize(df[grid_idx], sort=True)
    counts = np.bincount(codes)
    weights = np.zeros((len(uniques), n_obs))
    weights[codes, np.arange(n_obs)] = 1.0 / counts[codes]
    return weights


def gridbox_error_covariance(weights, obs_error_cov, device=None):
    """Reduce a per-record error covariance to gridbox level: W E W'.

    `weights` is the (n_gridboxes x n_obs) averaging matrix from
    ``get_weights``/``dist_weight``; `obs_error_cov` the per-record error
    covariance (uncorrelated + correlated + distance components summed),
    cast to the weights' dtype. Two products with ``torch.matmul`` on
    `device` (with none, on the inputs' if one is a tensor, else on the
    card) in the weights' own dtype; the result feeds a solve, so no
    product may run in TF32 (the port never changes
    ``torch.get_float32_matmul_precision()``). Returns a tensor there.
    """
    device = resolve_device(device, weights, obs_error_cov)
    W = torch.as_tensor(weights, device=device)
    E = torch.as_tensor(obs_error_cov, device=device).to(W.dtype)
    return torch.matmul(torch.matmul(W, E), W.T)
