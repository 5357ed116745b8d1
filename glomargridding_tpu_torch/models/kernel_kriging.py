r"""Kernel-functional kriging: the large-N path (covariance never
materialised), on tensors.

Port of ``glomargridding_tpu/models/kernel_kriging.py``. The covariance
is a *kernel function* of coordinates. The solver takes one Cholesky
factor of :math:`K = C_{obs} + E`, then walks column blocks of the grid:
each block's :math:`C_{cross}` tile comes from the kernel (on the card,
the hand-written tile kernel in ``ops/cuda``), the precomputed
:math:`L^{-1}` times the tile gives the uncertainty quadratic form, and
the block's slice of the field, uncertainty and constraint mask is
reduced. :math:`L^{-1}` is lower-triangular, so that product is taken in
row panels that each stop at the diagonal (``_tri_colsq``): the zero
half above it is never multiplied, and the panels a block takes are
counted in ``kriging.tri_panels``. Peak memory is O(n^2 + n * block)
whatever the grid size.

The numerics follow the reference: the field solves are
``cholesky_solve``; only the quadratic form ``sv = ||L^{-1} C_cross||^2``
goes through the explicit inverse. No product here may run in TF32: the
port never changes ``torch.get_float32_matmul_precision()`` from
"highest".

Inputs may be numpy arrays or tensors. ``device`` places the call; with
no device a tensor input keeps its device, and numpy inputs go to the
card (``cuda``; without one the call raises, so a CPU run names
``device="cpu"``). Block widths are rounded to the tile
kernel's column tile; results do not depend on the block count.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..constants import RADIUS_OF_EARTH_KM
from ..ops.cuda.pairwise import DISTANCES, TILE_N, pairwise_covariance
from ..ops.distances import radians
from ..utils.device import resolve_device
from ..utils.profiling import count, span


class KrigingResult(NamedTuple):
    """Kriged field + diagnostics (uncertainty = sqrt of clamped var)."""

    field: torch.Tensor
    uncertainty: torch.Tensor
    constraint_mask: torch.Tensor


class CrossValResult(NamedTuple):
    """Leave-one-out kriging cross-validation diagnostics."""

    residuals: torch.Tensor  # (n,) y_i - LOO prediction at obs i
    std_residuals: torch.Tensor  # (n,) residual / LOO predictive stdev
    loo_variance: torch.Tensor  # (n,) LOO predictive variance
    rmse: torch.Tensor  # scalar sqrt(mean residual^2)
    mssr: torch.Tensor  # scalar mean squared std residual (~1)


class VariogramKernel(nn.Module):
    """Covariance kernel ``variance - variogram(d)`` of radian coordinates.

    ``forward(la1, lo1, la2, lo2)`` returns the (len(la1), len(la2)) tile
    through ``ops.cuda.pairwise_covariance``: the CUDA kernel for tensors
    on the card, its plain PyTorch twin for tensors on the CPU.
    """

    def __init__(
        self,
        variogram,
        distance: str = "haversine",
        variance: float | None = None,
        radius: float = RADIUS_OF_EARTH_KM,
    ):
        super().__init__()
        if distance not in DISTANCES:
            raise ValueError(f"Unknown distance: {distance}")
        self.variogram = variogram
        self.distance = distance
        self.var = (
            variogram.psill + variogram.nugget if variance is None else variance
        )
        self.radius = radius

    def forward(self, la1, lo1, la2, lo2):
        return pairwise_covariance(
            la1, lo1, la2, lo2, self.variogram, self.distance, self.var,
            self.radius,
        )


def variogram_kernel(
    variogram,
    distance: str = "haversine",
    variance: float | None = None,
    radius: float = RADIUS_OF_EARTH_KM,
) -> VariogramKernel:
    """Covariance kernel (lat1, lon1, lat2, lon2 in RADIANS) from a
    variogram model. `distance` is "haversine" (great-circle km),
    "chordal" (tunnel km) or "cartesian" (planar degrees)."""
    return VariogramKernel(variogram, distance, variance, radius)


def _blocks(m: int, n_blocks: int) -> list[tuple[int, int]]:
    """[start, stop) column ranges: about m / n_blocks wide, rounded up
    to the tile kernel's column tile; the last block is ragged."""
    block = -(-m // n_blocks)
    block = -(-block // TILE_N) * TILE_N
    return [(s, min(s + block, m)) for s in range(0, m, block)]


# Rows of L^-1 in one panel of the uncertainty product, a multiple of the
# GEMM's 128-row tile: 512 was fastest or within 2.2% of it at n = 1,574,
# 3,000 and 5,000 against 4,096 columns on an H100, among 256-1,536
# (tools/tri_panel_sweep.py).
_TRI_PANEL_ROWS = 512


def _tri_colsq(Linv, Cc, panel: int):
    """Column sums of squares of ``Linv @ Cc`` for a lower-triangular
    (n, n) `Linv`, in row panels of `panel` rows.

    Panel [r0, r1) of ``Linv`` is zero beyond column r1, so its rows of
    the product are ``Linv[r0:r1, :r1] @ Cc[:r1]``, written in place into
    one (n, b) buffer: n^2 b (1 + 1/P) flops for P panels against the
    dense product's 2 n^2 b, the same terms summed. With n <= `panel`
    this is the one dense product.
    """
    n = Linv.shape[0]
    U = torch.empty((n, Cc.shape[1]), dtype=Cc.dtype, device=Cc.device)
    for r0 in range(0, n, panel):
        r1 = min(r0 + panel, n)
        torch.matmul(Linv[r0:r1, :r1], Cc[:r1], out=U[r0:r1])
    # squared in place: U is not needed afterwards
    return torch.sum(U.square_(), dim=0)


def _grid(grid_lats, grid_lons, device, *inputs):
    """Radian grid tensors on the call's device (``resolve_device`` over
    the grid and the other `inputs`)."""
    device = resolve_device(device, grid_lats, grid_lons, *inputs)
    la = radians(torch.as_tensor(grid_lats, device=device))
    lo = radians(torch.as_tensor(grid_lons, device=la.device, dtype=la.dtype))
    return la, lo


def _like(x, la):
    if x is None:
        return None
    return torch.as_tensor(x, dtype=la.dtype, device=la.device)


def _index(idx, la):
    return torch.as_tensor(idx, device=la.device).long()


def _factor(kernel_fn, la, lo, idx, y, error_cov):
    """Observation system: coordinates, L = chol(K), u = K^-1 1, w = K^-1 y."""
    with span("kriging.factor"):
        la_o = la[idx]
        lo_o = lo[idx]
        K = kernel_fn(la_o, lo_o, la_o, lo_o)
        if error_cov is not None:
            K = K + error_cov
        L = torch.linalg.cholesky(K)
        uw = torch.cholesky_solve(torch.stack([torch.ones_like(y), y], dim=1),
                                  L)
    return la_o, lo_o, L, uw[:, 0], uw[:, 1]


class _ObsSystem(NamedTuple):
    """The factored observation system the column blocks are solved
    against: u = K^-1 1, w = K^-1 y, s = sum(u), uy = u'y and, for the
    diagnostics, Linv = L^-1 (None for fields only)."""

    u: torch.Tensor
    w: torch.Tensor
    s: torch.Tensor
    uy: torch.Tensor
    Linv: torch.Tensor | None


def _obs_system(kernel_fn, la, lo, idx, y, error_cov, fields_only=False):
    """Observation coordinates and the ``_ObsSystem`` of K = C_obs + E."""
    la_o, lo_o, L, u, w = _factor(kernel_fn, la, lo, idx, y, error_cov)
    Linv = None
    if not fields_only:
        with span("kriging.inverse"):
            eye = torch.eye(idx.shape[0], dtype=L.dtype, device=L.device)
            Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return la_o, lo_o, _ObsSystem(u, w, torch.sum(u), u @ y, Linv)


def _grid_columns(
    kernel_fn, system, la_o, lo_o, la, lo, variance: float, mean: float,
    method: str, n_blocks: int,
):
    """Field, uncertainty^2 and constraint mask of the grid columns
    (la, lo), a block of columns at a time, against `system`; with the
    diagnostics, each block's ``||L^-1 C_cross||^2`` is ``_tri_colsq``'s
    row-panelled product, its ceil(n / ``_TRI_PANEL_ROWS``) panels
    counted in ``kriging.tri_panels``."""
    u, w, s, uy, Linv = system
    fields_only = Linv is None
    # u and w stacked into one (2, n) left operand: one pass over each tile
    M2 = torch.stack([u, w], dim=0)
    m = la.shape[0]
    field = torch.empty(m, dtype=la.dtype, device=la.device)
    if fields_only:
        uncert2 = cmask = None
    else:
        uncert2 = torch.empty_like(field)
        cmask = torch.empty_like(field)

    blocks = _blocks(m, n_blocks)
    count("kriging.column_blocks", len(blocks))
    if not fields_only:
        panel = _TRI_PANEL_ROWS
        count("kriging.tri_panels", len(blocks) * -(-u.shape[0] // panel))
    with span("kriging.columns"):
        for start, stop in blocks:
            Cc = kernel_fn(la_o, lo_o, la[start:stop], lo[start:stop])
            R = M2 @ Cc  # rows: u@Cc, w@Cc
            if method == "ordinary":
                t = R[0]
                lam = (t - 1.0) / s
                field[start:stop] = R[1] - lam * uy
            else:
                field[start:stop] = R[1] + mean
            if fields_only:
                continue
            sv = _tri_colsq(Linv, Cc, panel)
            if method == "ordinary":
                wc = sv - lam * t
                uncert2[start:stop] = variance - (wc + lam) - lam
            else:
                uncert2[start:stop] = variance - sv
            cmask[start:stop] = sv / variance
    return field, uncert2, cmask


def _kernel_kriging(
    kernel_fn, la, lo, idx, y, error_cov, variance: float, mean: float,
    method: str, n_blocks: int, fields_only: bool = False,
):
    la_o, lo_o, system = _obs_system(kernel_fn, la, lo, idx, y, error_cov,
                                     fields_only)
    return _grid_columns(kernel_fn, system, la_o, lo_o, la, lo, variance,
                         mean, method, n_blocks)


def kriging_from_kernel(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov=None,
    variance: float = 1.0,
    method: str = "ordinary",
    mean: float = 0.0,
    n_blocks: int = 16,
    device=None,
) -> KrigingResult:
    """Simple/ordinary kriging against a covariance *kernel*.

    `kernel_fn(la1, lo1, la2, lo2)` (radians) produces covariance tiles;
    `grid_lats`/`grid_lons` are the output grid positions in degrees;
    `variance` is the kernel's value at zero distance (diag(C)).
    Memory never exceeds O(n^2 + n * M/n_blocks).
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    with span("kriging.call"):
        with span("kriging.inputs"):
            la, lo = _grid(grid_lats, grid_lons, device, idx, obs, error_cov)
            idx, y, E = _index(idx, la), _like(obs, la), _like(error_cov, la)
        field, uncert2, cmask = _kernel_kriging(
            kernel_fn, la, lo, idx, y, E, float(variance), float(mean),
            method, n_blocks,
        )
        uncert = torch.sqrt(torch.clamp(uncert2, min=0.0))
    return KrigingResult(field, uncert, cmask)


def ensemble_from_kernel(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov,
    generator: torch.Generator | None = None,
    n_members: int = 100,
    n_blocks: int = 16,
    noise=None,
    device=None,
):
    """Observation-perturbation ensemble around the kernel-kriged field.

    One factorisation of K = C_obs + E; `n_members` draws of simulated
    observation noise are simple-kriged through the column blocks.
    The standard-normal draws come from `generator`, or are given as
    `noise` of shape (n_members, n_obs). Returns (field (M,),
    members (n_members, M)).
    """
    with span("kriging.call"):
        with span("kriging.inputs"):
            la, lo = _grid(grid_lats, grid_lons, device, idx, obs,
                           error_cov, noise)
            idx, y, E = _index(idx, la), _like(obs, la), _like(error_cov, la)
            z = None if noise is None else _like(noise, la)
        la_o, lo_o, L, u, w = _factor(kernel_fn, la, lo, idx, y, E)
        n = idx.shape[0]
        with span("kriging.members"):
            s = torch.sum(u)
            uy = u @ y
            if z is None:
                z = torch.randn(
                    (n_members, n), generator=generator, dtype=la.dtype,
                    device=la.device,
                )
            elif z.shape != (n_members, n):
                raise ValueError(f"noise has shape {tuple(z.shape)}, "
                                 f"expected {(n_members, n)}")
            sim_obs = z @ L.T
            S = torch.cholesky_solve(sim_obs.T, L).T  # (members, n)
            # u, w and the member weights as ONE left operand per tile
            M = torch.cat([u[None, :], w[None, :], S], dim=0)

        m = la.shape[0]
        field = torch.empty(m, dtype=la.dtype, device=la.device)
        members = torch.empty((n_members, m), dtype=la.dtype,
                              device=la.device)
        blocks = _blocks(m, n_blocks)
        count("kriging.column_blocks", len(blocks))
        with span("kriging.columns"):
            for start, stop in blocks:
                Cc = kernel_fn(la_o, lo_o, la[start:stop], lo[start:stop])
                R = M @ Cc  # rows: u@Cc, w@Cc, then S@Cc
                lam = (R[0] - 1.0) / s
                f = R[1] - lam * uy
                field[start:stop] = f
                members[:, start:stop] = f[None, :] + R[2:]
    return field, members


def pad_month_observations(
    idx_months,
    obs_months,
    err_months,
    bucket: int | None = None,
    pad_error: float = 1e8,
):
    """Pad variable-length monthly observation sets to one bucket size.

    Dummy observations sit at grid index 0 with value 0 and a huge
    uncorrelated error variance (`pad_error`), so their kriging weight is
    ~variance/pad_error. Returns stacked numpy (T, bucket) idx/obs and
    (T, bucket, bucket) error covariance for ``months_scan_kriging``.
    """
    if bucket is None:
        bucket = max(len(i) for i in idx_months)
    T = len(idx_months)
    idx_out = np.zeros((T, bucket), dtype=np.asarray(idx_months[0]).dtype)
    obs_out = np.zeros((T, bucket), dtype=float)
    err_out = np.zeros((T, bucket, bucket), dtype=float)
    for t in range(T):
        n = len(idx_months[t])
        if n > bucket:
            raise ValueError(f"month {t} has {n} obs > bucket size {bucket}")
        idx_out[t, :n] = np.asarray(idx_months[t])
        obs_out[t, :n] = np.asarray(obs_months[t])
        err_out[t, :n, :n] = np.asarray(err_months[t])
        pad_sl = np.arange(n, bucket)
        err_out[t, pad_sl, pad_sl] = pad_error
    return idx_out, obs_out, err_out


def months_scan_kriging(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx_months,
    obs_months,
    error_cov_months,
    variance: float = 1.0,
    n_blocks: int = 8,
    diagnostics: bool = True,
    device=None,
):
    """Ordinary kriging over a stack of months, one month at a time.

    `idx_months` (T, n), `obs_months` (T, n), `error_cov_months`
    (T, n, n). Returns (fields, uncertainties, constraint_masks), each
    (T, M); with ``diagnostics=False`` only the (T, M) fields, computed
    without the triangular inverse or the quadratic form.
    """
    la, lo = _grid(grid_lats, grid_lons, device, idx_months, obs_months,
                   error_cov_months)
    idx_m = _index(idx_months, la)
    obs_m = _like(obs_months, la)
    err_m = _like(error_cov_months, la)
    out = [
        _kernel_kriging(
            kernel_fn, la, lo, idx_m[t], obs_m[t], err_m[t],
            float(variance), 0.0, "ordinary", n_blocks,
            fields_only=not diagnostics,
        )
        for t in range(idx_m.shape[0])
    ]
    fields = torch.stack([o[0] for o in out])
    if not diagnostics:
        return fields
    uncert2 = torch.stack([o[1] for o in out])
    cmask = torch.stack([o[2] for o in out])
    return fields, torch.sqrt(torch.clamp(uncert2, min=0.0)), cmask


def _loo_from_K(K, y, mean: float, method: str):
    """Dubrule LOO identity off the dense (n, n) observation system."""
    n = K.shape[0]
    if method == "ordinary":
        ones = torch.ones((n, 1), dtype=K.dtype, device=K.device)
        zero = torch.zeros((1, 1), dtype=K.dtype, device=K.device)
        Kx = torch.cat(
            [torch.cat([K, ones], dim=1), torch.cat([ones.T, zero], dim=1)]
        )
        rhs = torch.cat([y, zero[0]])
        # the bordered system is symmetric INDEFINITE: lu, not cholesky
        Kinv = torch.linalg.inv(Kx)
        alpha = (Kinv @ rhs)[:n]
        d = torch.diagonal(Kinv)[:n]
    else:
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve((y - mean)[:, None], L)[:, 0]
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        d = torch.diagonal(torch.cholesky_solve(eye, L))
    loo_var = 1.0 / d
    resid = alpha * loo_var
    stdres = alpha * torch.sqrt(loo_var)
    rmse = torch.sqrt(torch.mean(resid**2))
    mssr = torch.mean(stdres**2)
    return CrossValResult(resid, stdres, loo_var, rmse, mssr)


def _add_error(K, E):
    if E is None:
        return K
    return K + (torch.diag(E) if E.dim() == 1 else E)


def kriging_crossval(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov=None,
    mean: float = 0.0,
    method: str = "ordinary",
    device=None,
) -> CrossValResult:
    r"""Leave-one-out cross-validation of a kriging model in ONE solve.

    Dubrule (1983): with :math:`K = C_{obs} + E` and
    :math:`\alpha = K^{-1}(y - \mu)`, the LOO residual at observation i
    is :math:`\alpha_i / (K^{-1})_{ii}` and the LOO variance
    :math:`1 / (K^{-1})_{ii}`. For ``method="ordinary"`` the identity is
    applied to the Lagrange-bordered system. `error_cov` accepts the (n,)
    diagonal or the (n, n) matrix.
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    la, lo = _grid(grid_lats, grid_lons, device, idx, obs, error_cov)
    idx = _index(idx, la)
    la_o, lo_o = la[idx], lo[idx]
    K = _add_error(kernel_fn(la_o, lo_o, la_o, lo_o), _like(error_cov, la))
    return _loo_from_K(K, _like(obs, la), float(mean), method)


def crossval_from_covariance(
    covariance,
    idx,
    obs,
    error_cov=None,
    mean: float = 0.0,
    method: str = "ordinary",
    device=None,
) -> CrossValResult:
    """:func:`kriging_crossval` for a precomputed dense covariance.

    `error_cov` may be obs-sized (m or m x m) or full-grid (n or n x n,
    then subset to `idx`).
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    cov = torch.as_tensor(covariance, device=resolve_device(
        device, covariance, idx, obs, error_cov))
    idx = _index(idx, cov)
    E = _like(error_cov, cov)
    m = int(idx.shape[0])
    if E is not None and E.shape[0] != m:
        if E.shape[0] != cov.shape[0]:
            raise ValueError(
                f"error_cov dimension {E.shape[0]} matches neither the "
                f"observation count {m} nor the grid size {cov.shape[0]}"
            )
        E = E[idx] if E.dim() == 1 else E[idx[:, None], idx[None, :]]
    K = _add_error(cov[idx[:, None], idx[None, :]], E)
    return _loo_from_K(K, _like(obs, cov), float(mean), method)
