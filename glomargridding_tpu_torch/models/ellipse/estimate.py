r"""Ellipse parameter estimation from a (time, lat, lon) training cube.

Port of ``glomargridding_tpu/models/ellipse/estimate.py``
(``EllipseBuilder``: empirical covariance/correlation, per-gridpoint
training-set selection, MLE ellipse fits with QC codes, whole-grid
parameter fields):

- the empirical correlation is one matmul of the variance-normalised
  samples;
- per-gridpoint training-set selection is a *mask*, not a ragged gather:
  every point keeps a fixed-length (N,) row of displacements and
  correlations with 0/1 weights, so all fits of a chunk share one shape;
- ``fit_cells`` fits a chosen set of cells in one call of the batched
  optimisers of ``ops.optim``; ``compute_params`` fits ALL unmasked grid
  points, a chunk of rows at a time to bound memory, each chunk as
  ``fit_cells`` fits its cells.

Everything runs eagerly: there is no compiled program to cache and no
grouped dispatch (``dispatch_chunks`` is accepted and changes nothing).
The multi-device fit (``mesh=``) splits each chunk's lanes over the
slots of a ``parallel`` mesh.
"""

import functools
import json
import logging
import math
import os
from typing import Any, NamedTuple
from warnings import warn

import numpy as np
import torch

from ...constants import RADIUS_OF_EARTH_KM
from ...core.labeled import Coordinates, DataArray, Dataset
from ...ops.cuda import ellipse_nll
from ...ops.distances import displacements, haversine_matrix
from ...ops.optim import (
    batched_lbfgs,
    batched_levenberg_marquardt,
    batched_nelder_mead,
    stacked_objective,
)
from ...types import DeltaXMethod
from ...utils.arrays import cov_2_cor, is_iter, uncompress_masked
from ...utils.device import resolve_device
from ...utils.profiling import count, span
from .model import ARCTANH_THRESHOLD, EllipseModel

logger = logging.getLogger(__name__)

# (B, N)-shaped values alive at the peak of one chunk's training-data
# build (displacements, the haversine's temporaries, the selection
# distances and top-k's buffers), in the working dtype: 8.00 measured at
# 2,048 x 64,800 in f32 on an NVIDIA H100 80GB HBM3 (chip_smoke.py
# phase 16, build_values_per_pair)
_CHUNK_VALUES_PER_PAIR = 8
# share of the device's free memory a chunk's build may take; on the CPU
# there is nothing to ask, so a fixed budget
_CHUNK_MEMORY_SHARE = 0.5
_CPU_CHUNK_BUDGET_BYTES = 10e9
# cor_mode="auto": the dense (n, n) correlation is kept while it takes at
# most this share of the device's total memory (an 80 GB card: up to
# 89,442 points in f32, so 64,800 is dense at 16.8 GB and 100,000 is
# lazy); on the CPU, up to this many points
_DENSE_COR_MEMORY_SHARE = 0.4
_CPU_DENSE_COR_POINTS = 100_000
# lanes per vmapped Hessian call of the standard-error pass: reverse over
# forward mode keeps ~(1 + d) x the objective's intermediates per lane
_SE_LANES = 512
# the batched optimiser of each accepted opt_method
_OPTIMISER_LANES = {"Nelder-Mead": "nm", "L-BFGS-B": "lbfgs",
                    "L-BFGS": "lbfgs", "lbfgs": "lbfgs", "lm": "lm",
                    "Levenberg-Marquardt": "lm"}


def _padded(cells: np.ndarray, lanes: int) -> np.ndarray:
    """`cells` and, up to `lanes`, copies of the first: a chunk's lanes."""
    return np.concatenate([cells, np.full(lanes - cells.size, cells[0])])


def _k5_takes(model: EllipseModel, lane: str, device: torch.device,
              dtype: torch.dtype) -> bool:
    """Whether a chunk's objective runs on K5 (``ops.cuda.ellipse_nll``):
    for the Nelder-Mead lane on a CUDA device, where the kernel takes the
    model's order, form and dtype (``ellipse_nll.takes``). Everything
    else, and the gradient lanes, keep the vmapped ``_nll_fit_z``."""
    return (lane == "nm" and device.type == "cuda"
            and ellipse_nll.takes(model.v, model.n_params, dtype))


def _optimiser_lane(opt_method: str) -> str:
    """"nm", "lm" or "lbfgs" for `opt_method`; raises on any other."""
    if opt_method not in _OPTIMISER_LANES:
        raise ValueError(
            "opt_method must be 'Nelder-Mead', 'L-BFGS-B' or 'lm'"
        )
    return _OPTIMISER_LANES[opt_method]


class CellFits(NamedTuple):
    """``EllipseBuilder.fit_cells``' result, one row a given cell, on the
    builder's device."""

    x: torch.Tensor  # (B, d) raw optima, before canonicalisation
    fun: torch.Tensor  # (B,) the objective at the optimum
    nit: torch.Tensor  # (B,) the lane's iterations
    success: torch.Tensor  # (B,) bool: converged within maxiter
    has_data: torch.Tensor  # (B,) bool: the distance window held a point


def _normalised_samples(x):
    """Variance-normalise centred (T, n) samples so xn'xn is the
    empirical correlation."""
    var = torch.einsum("tn,tn->n", x, x)
    inv_s = torch.where(var > 0, 1.0 / torch.sqrt(var),
                        torch.zeros_like(var))
    return x * inv_s[None, :]


def _cor_matmul(x):
    xn = _normalised_samples(x)
    return xn.T @ xn


def _correlation_from_centred(x):
    """(n, n) correlation from centred (T, n) samples.

    Normalising the samples FIRST means the correlation needs a single
    n x n buffer (no dense covariance is ever formed); the exact unit
    diagonal is written into it in place.
    """
    cor = _cor_matmul(x)
    cor.fill_diagonal_(1.0)
    return cor


def _train_geometry_arrays(
    lats_all,
    lons_all,
    centre_sel,
    *,
    min_distance: float,
    max_distance: float,
    anisotropic: bool,
    delta_x_method,
    physical_distance: bool,
    physical_distance_selection: bool,
):
    """Displacements/selection geometry for a batch of centre points.

    Returns (X, weights): X is (B, N, 2) for anisotropic models or (B, N)
    distances for isotropic ones; weights the (B, N) 0/1 selection mask.
    Three selection regimes: by degree distance (no `delta_x_method`, or
    `physical_distance_selection` off), where X is in degrees or, with
    `physical_distance`, in km; or by great-circle distance in km.
    """
    if physical_distance and (delta_x_method is None):
        raise ValueError(
            "Cannot have physical_distance with unset delta_x_method"
        )
    lat_c = lats_all[centre_sel]
    lon_c = lons_all[centre_sel]

    def from_centres(method):
        # displacement from every point to each centre, (B, N): the
        # negation of centre-to-point, exactly, wrap and all
        dy, dx = displacements(lat_c, lon_c, lats_all, lons_all,
                               delta_x_method=method)
        return -dy, -dx

    dy, dx = from_centres(delta_x_method)

    def window(distance):
        return (
            (distance <= max_distance)
            & (distance >= min_distance)
            & (distance != 0.0)
        ).to(dy.dtype)

    if delta_x_method is None or not physical_distance_selection:
        if delta_x_method is not None:
            dyd, dxd = from_centres(None)
            deg_distance = torch.sqrt(dxd**2 + dyd**2)
            del dyd, dxd
        else:
            deg_distance = torch.sqrt(dx**2 + dy**2)
        weights = window(deg_distance)
        if anisotropic:
            X = torch.stack([dx, dy], dim=-1)
            if physical_distance:
                X = X * RADIUS_OF_EARTH_KM
            return X, weights
        if physical_distance:
            dist = haversine_matrix(lat_c, lon_c, lats_all, lons_all)
            return dist, weights
        return deg_distance, weights

    dist = haversine_matrix(lat_c, lon_c, lats_all, lons_all)  # (B, N)
    weights = window(dist)
    if anisotropic:
        del dist
        X = RADIUS_OF_EARTH_KM * torch.stack([dx, dy], dim=-1)
        return X, weights
    return dist, weights


def _chunk_train_data(
    lats_all,
    lons_all,
    cor,
    centre_sel,
    *,
    min_distance: float,
    max_distance: float,
    anisotropic: bool,
    delta_x_method,
    physical_distance: bool,
    physical_distance_selection: bool,
    max_train_cols,
    fisher_z: bool = False,
    lazy_cor: bool = False,
):
    """One chunk's full training data (X, y, w), in `cor`'s dtype.

    The geometry is computed in the coordinates' dtype, as the reference
    computes it, and X and w are cast to the correlation's afterwards, so
    that an objective sees one dtype.

    With ``fisher_z=True`` the returned observations are
    ``arctanh(clip(y))`` (masked lanes zeroed first, matching ``nll``'s
    masking order) for the ``_nll_fit_z`` / ``_residuals_fit_z``
    objectives: the transform is constant across optimiser iterations,
    so computing it here removes it from every candidate evaluation.

    With ``lazy_cor=True``, `cor` is NOT the (n, n) correlation but the
    (T, n) variance-normalised centred samples, and the chunk's
    correlation rows are rebuilt as one (B, T) x (T, n) matmul: the
    (n, n) matrix never exists, which is what makes whole-grid fits
    possible where it does not fit. Exact unit self-correlation is
    re-imposed at [b, centre_sel[b]] for parity with the dense path.
    """
    X, w = _train_geometry_arrays(
        lats_all,
        lons_all,
        centre_sel,
        min_distance=min_distance,
        max_distance=max_distance,
        anisotropic=anisotropic,
        delta_x_method=delta_x_method,
        physical_distance=physical_distance,
        physical_distance_selection=physical_distance_selection,
    )
    if lazy_cor:
        xn = cor  # (T, n) normalised samples
        y = xn[:, centre_sel].T @ xn  # (B, n) correlation rows
        y[torch.arange(centre_sel.shape[0], device=y.device),
          centre_sel] = 1.0
    else:
        y = cor[centre_sel, :]
    if max_train_cols is not None and max_train_cols < y.shape[1]:
        X, y, w = _nearest_train_cols(X, y, w, max_train_cols, anisotropic)
    X, w = X.to(y.dtype), w.to(y.dtype)
    if fisher_z:
        y = torch.arctanh(
            torch.clamp(
                torch.where(w > 0, y, torch.zeros_like(y)),
                -ARCTANH_THRESHOLD,
                ARCTANH_THRESHOLD,
            )
        )
    return X, y, w


def _lazy_cor_row(xn, i: int):
    """One correlation row from the normalised samples, exact unit
    self-correlation."""
    row = xn[:, i] @ xn
    row[i] = 1.0
    return row


class _LazyCorrelation:
    """Row-on-demand empirical correlation: cor[i, j] = xn[:, i].xn[:, j].

    Holds only the (T, n) variance-normalised centred samples; a row is
    one (T,) x (T, n) matvec on the device. Supports the row-access
    patterns the estimation pipeline uses (``cor[i, :]``, ``cor[i, j]``);
    whole-matrix reads raise rather than silently materialising n^2
    values (269 GB in f32 at the 259,200-point half-degree grid, the size
    this class exists to avoid).
    """

    def __init__(self, xn) -> None:
        self._xn = xn
        n = int(xn.shape[1])
        self.shape = (n, n)
        self.dtype = xn.dtype
        self.device = xn.device

    @property
    def normalised_samples(self):
        """The (T, n) variance-normalised centred samples."""
        return self._xn

    def row(self, i: int):
        """Correlation row i as an (n,) tensor on the samples' device."""
        return _lazy_cor_row(self._xn, int(i))

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            i, j = key
            if isinstance(i, (int, np.integer)):
                r = self.row(int(i))
                if isinstance(j, slice) and j == slice(None):
                    return r
                return r[j]
        raise TypeError(
            "lazy correlation supports cor[i, :] / cor[i, j] row access "
            "only; use .normalised_samples for bulk computation or "
            "cor_mode='dense' to materialise the full matrix"
        )

    def __array__(self, dtype=None, copy=None):
        raise MemoryError(
            f"refusing to materialise the {self.shape} lazy correlation "
            "(use cor_mode='dense' if it fits in memory)"
        )


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


class EllipseBuilder:
    """Build spatial covariance/correlation and fit ellipse parameters.

    `data_array` is a (time, lat, lon) cube (numpy or numpy.ma masked;
    NaNs also count as masked). `coords` must contain "time", "latitude",
    "longitude" with time as dimension 0. Points masked at ANY time are
    dropped.

    A ``torch.Tensor`` cube stays ON ITS DEVICE end to end: the mask is
    detected by a device reduction (NaN = masked; only the small
    (lat, lon) bool map comes to the host), the kept columns are a device
    gather, and ``self.data`` remains the tensor. A numpy cube does its
    mask bookkeeping on the host and its kept columns go to `device` (by
    default the card) in their own dtype.

    `cor_mode` controls the empirical correlation representation:
    ``"dense"`` materialises the (n, n) matrix on the device, ``"lazy"``
    keeps only the (T, n) normalised samples and rebuilds correlation
    rows on demand inside the fit (the same values; the only path that
    scales past the device's memory), ``"auto"`` (default) picks dense
    while the matrix takes at most 40% of the device's memory (on the
    CPU: up to 100,000 points).
    """

    def __init__(
        self, data_array, coords, cor_mode: str = "auto", device=None
    ) -> None:
        if cor_mode not in ("auto", "dense", "lazy"):
            raise ValueError("cor_mode must be 'auto', 'dense' or 'lazy'")
        self.cor_mode = cor_mode
        self.device = resolve_device(device, data_array)
        if isinstance(data_array, torch.Tensor):
            self.data = data_array  # device-resident path
        elif isinstance(data_array, np.ma.MaskedArray):
            self.data = data_array
        else:
            self.data = np.ma.MaskedArray(data_array)
        self.coords = coords
        self.xy_shape = tuple(self.data.shape[1:])
        if len(self.xy_shape) != 2:
            raise ValueError(
                "Time slice maps should be 2D; check extra dims (ensemble?)"
            )
        self.big_covar_size = int(np.prod(self.xy_shape))

        self._parse_coords()
        self._detect_mask()
        self.calc_cov()

    # -- setup ---------------------------------------------------------------
    def _parse_coords(self) -> None:
        names = list(self.coords.keys())
        if "time" not in names:
            raise ValueError("Input cube needs a time dimension")
        if names.index("time") != 0:
            raise ValueError("Input cube time dimension not at 0")
        missing = [
            c for c in ("latitude", "longitude") if c not in names
        ]
        if missing:
            raise ValueError(
                "Input cube need two spatial dimensions "
                "('latitude' and 'longitude')"
            )
        lons = np.asarray(self.coords["longitude"])
        lats = np.asarray(self.coords["latitude"])
        self.xx, self.yy = np.meshgrid(lons, lats)
        self.xi, self.yi = np.meshgrid(
            np.arange(len(lons)), np.arange(len(lats))
        )
        self.time_n = len(np.asarray(self.coords["time"]))

    def _detect_mask(self) -> None:
        if isinstance(self.data, torch.Tensor):
            # device cube: NaN = masked; fetch only the (lat, lon) map
            self.mask = torch.isnan(self.data).any(dim=0).cpu().numpy()
            self.data_has_mask = bool(self.mask.any())
            self.mask_1D = self.mask.flatten()
            self.small_covar_size = int(np.sum(~self.mask))
        else:
            nan_mask = np.isnan(np.ma.getdata(self.data))
            base_mask = np.ma.getmaskarray(self.data) | nan_mask
            self.data = np.ma.masked_where(base_mask, self.data)
            self.data_has_mask = bool(base_mask.any())
            if self.data_has_mask:
                # time-varying masks (sea ice): any-time-masked dropped
                self.mask = np.any(base_mask, axis=0)
                self.mask_1D = self.mask.flatten()
                self._self_mask()
                self.small_covar_size = int(np.sum(~self.mask))
            else:
                self.mask = np.zeros(self.xy_shape, dtype=bool)
                self.mask_1D = self.mask.flatten()
                self.small_covar_size = self.big_covar_size
        self.x_masked = np.ma.masked_where(self.mask, self.xx)
        self.y_masked = np.ma.masked_where(self.mask, self.yy)
        self.xi_masked = np.ma.masked_where(self.mask, self.xi).compressed()
        self.yi_masked = np.ma.masked_where(self.mask, self.yi).compressed()
        self.xy_masked = np.column_stack(
            [self.x_masked.compressed(), self.y_masked.compressed()]
        )
        self.xy_full = np.column_stack(
            [self.x_masked.flatten(), self.y_masked.flatten()]
        )

    def _self_mask(self) -> None:
        broadcasted = np.broadcast_to(self.mask, self.data.shape)
        self.data = np.ma.masked_where(broadcasted, self.data)

    def _dense_cor_fits(self, itemsize: int) -> bool:
        """cor_mode="auto": whether the (n, n) correlation is kept."""
        n = self.small_covar_size
        if self.device.type != "cuda":
            return n <= _CPU_DENSE_COR_POINTS
        total = torch.cuda.get_device_properties(self.device).total_memory
        return n * n * itemsize <= _DENSE_COR_MEMORY_SHARE * total

    def calc_cov(self, rounding: int | None = None) -> None:
        """Empirical covariance/correlation over time: one matmul.

        cov = X'X/(T-1) with the temporal mean removed, over unmasked
        points only. Only the CORRELATION is materialised (directly, from
        variance-normalised samples), it stays on the device, and ``cov``
        is a lazy property recomputed from the retained (T, n) centred
        samples on access. Where even the single correlation buffer is
        too big (``cor_mode`` "auto"/"lazy"), ``self.cor`` becomes a
        :class:`_LazyCorrelation` that rebuilds rows on demand, and the
        batched fit rebuilds each chunk's rows itself.
        """
        if isinstance(self.data, torch.Tensor):
            flat = self.data.reshape((self.time_n, self.big_covar_size))
            if self.data_has_mask:
                # device gather of the kept columns (host index)
                keep = torch.as_tensor(np.where(~self.mask_1D)[0],
                                       device=flat.device)
                x = flat[:, keep]
            else:
                x = flat
        else:
            flat = self.data.reshape(
                (self.time_n, self.big_covar_size)
            )
            kept = np.ma.getdata(flat)[:, ~self.mask_1D]
            x = torch.as_tensor(kept, device=self.device)
        if not x.is_floating_point():
            x = x.to(torch.get_default_dtype())
        x = x - torch.mean(x, dim=0, keepdim=True)
        self._x_centered = x
        self._rounding = rounding
        self._cov_diagonal = None  # derived cache: invalidate on recompute
        lazy = self.cor_mode == "lazy" or (
            self.cor_mode == "auto"
            and not self._dense_cor_fits(x.element_size())
        )
        if rounding is not None:
            if lazy:
                # covers cor_mode="auto" past the size threshold too:
                # falling through would attempt the dense (n, n)
                # materialisation this mode exists to avoid
                raise ValueError(
                    "rounding requires the dense correlation "
                    "(cor_mode='dense')"
                )
            # rare parity path: the covariance is rounded before it is
            # normalised
            self.cor = cov_2_cor(self._cov_matrix(), rounding=rounding)
            return
        if lazy:
            self.cor = _LazyCorrelation(_normalised_samples(x))
            return
        self.cor = _correlation_from_centred(x)

    def _cov_matrix(self):
        x = self._x_centered
        cov = (x.T @ x) / (self.time_n - 1)
        if getattr(self, "_rounding", None) is not None:
            cov = torch.round(cov, decimals=self._rounding)
        return cov

    @property
    def cov(self):
        """Empirical covariance (lazy: rebuilt from the centred samples
        on access, one matmul, so the n x n tensor is not pinned in
        memory alongside ``cor``)."""
        return self._cov_matrix()

    @property
    def cov_diagonal(self) -> np.ndarray:
        """diag of the empirical covariance without forming it, cached on
        the host: the per-point path reads one entry per fit."""
        cached = getattr(self, "_cov_diagonal", None)
        if cached is None:
            x = self._x_centered
            cached = _host(
                torch.einsum("tn,tn->n", x, x) / (self.time_n - 1)
            )
            self._cov_diagonal = cached
        return cached

    # -- training data -------------------------------------------------------
    def _point_coords(self):
        """(lats, lons) of the unmasked points on the device, in the
        coordinates' dtype."""
        return (torch.as_tensor(self.xy_masked[:, 1], device=self.device),
                torch.as_tensor(self.xy_masked[:, 0], device=self.device))

    def _train_geometry(
        self,
        centre_sel,
        min_distance: float,
        max_distance: float,
        anisotropic: bool,
        delta_x_method: DeltaXMethod | None,
        physical_distance: bool,
        physical_distance_selection: bool,
    ):
        """Displacements/selection geometry for a batch of centre points:
        :func:`_train_geometry_arrays` on this object's points."""
        return _train_geometry_arrays(
            *self._point_coords(),
            torch.as_tensor(centre_sel, device=self.device),
            min_distance=min_distance,
            max_distance=max_distance,
            anisotropic=anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=physical_distance,
            physical_distance_selection=physical_distance_selection,
        )

    def _get_train_data(
        self,
        xy_point: int,
        min_distance: float,
        max_distance: float,
        anisotropic: bool,
        delta_x_method: DeltaXMethod | None,
        physical_distance: bool = True,
        physical_distance_selection: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(X_train, y_train) for one centre point, as numpy."""
        X, w = self._train_geometry(
            [xy_point],
            min_distance,
            max_distance,
            anisotropic,
            delta_x_method,
            physical_distance,
            physical_distance_selection,
        )
        sel = _host(w[0]) > 0
        y = _host(self.cor[xy_point, :])[sel]
        X0 = _host(X[0])
        return (X0[sel, :] if anisotropic else X0[sel]), y

    # -- fitting --------------------------------------------------------------
    def fit_ellipse_model(
        self,
        xy_point: int,
        matern_ellipse: EllipseModel,
        max_distance: float = 6000,
        min_distance: float = 0.3,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float = 0.001,
        estimate_SE: str | None = None,
        n_jobs: int | None = None,
        n_sim: int = 500,
        physical_distance_selection: bool = True,
    ) -> dict[str, Any] | None:
        """Fit the ellipse model at one grid point, on this object's
        device.

        Returns a dict with the fitted parameters (ModelParams ordered as
        the model's supercategory fields), QC code, iteration count,
        standard deviation, and the observed correlation map, or None
        when no training data falls in the distance window.
        """
        R2 = uncompress_masked(
            _host(self.cor[xy_point, :]),
            self.mask_1D,
            fill_value=np.nan,
        ).reshape(self.xy_shape)

        X_train, y_train = self._get_train_data(
            xy_point=xy_point,
            min_distance=min_distance,
            max_distance=max_distance,
            anisotropic=matern_ellipse.anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=matern_ellipse.physical_distance,
            physical_distance_selection=physical_distance_selection,
        )
        if len(y_train) == 0:
            warn(f"No training data for idx {xy_point}")
            return None

        # the objective runs in the correlation's dtype, as the batched
        # fit's does
        results, SE, bounds_out = matern_ellipse.fit(
            X_train.astype(y_train.dtype),
            y_train,
            guesses=guesses,
            bounds=bounds,
            opt_method=opt_method,
            tol=tol,
            estimate_SE=estimate_SE,
            n_sim=n_sim,
            device=self.device,
        )

        model_params = _host(results.x).tolist()
        self._check_params(matern_ellipse, model_params)

        stdev = None
        if not matern_ellipse.unit_sigma:
            stdev = model_params.pop()

        if bool(results.success):
            fit_success = _get_fit_score(
                model_params, bounds_out, int(results.nit)
            )
        else:
            fit_success = 9

        std_dev = float(np.sqrt(self.cov_diagonal[xy_point]))
        model_params.append(std_dev)
        model_params.append(fit_success)
        model_params.append(int(results.nit))

        return {
            "Correlation": R2,
            "Results": results,
            "ModelParams": model_params,
            "Success": fit_success,
            "StandardDeviation": std_dev,
            "StandardError": SE,
            "RMSE": stdev,
        }

    def _check_params(self, ellipse: EllipseModel, model_params) -> None:
        """Canonicalise: ensure Lx >= Ly and theta in (-pi, pi] (in
        place). The +pi/2 rotation on a Lx/Ly swap applies to rotated
        models only: for the un-rotated 2-parameter form slot 2 is the
        appended likelihood sigma."""
        if ellipse.anisotropic and model_params[1] > model_params[0]:
            model_params[0], model_params[1] = (
                model_params[1],
                model_params[0],
            )
            if ellipse.rotated:
                model_params[2] += np.pi / 2
        if not ellipse.rotated:
            return
        if model_params[2] > np.pi:
            model_params[2] -= np.pi
        if model_params[2] <= -np.pi:
            model_params[2] += np.pi

    def _chunk_cap(self, n_points: int, itemsize: int) -> tuple[int, str]:
        """(largest chunk_size whose build fits, what was assumed)."""
        per_row = _CHUNK_VALUES_PER_PAIR * itemsize * n_points
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            # blocks the caching allocator holds and no tensor uses are
            # free to this build too
            free += (torch.cuda.memory_reserved(self.device)
                     - torch.cuda.memory_allocated(self.device))
            budget = _CHUNK_MEMORY_SHARE * free
            assumed = (f"{_CHUNK_MEMORY_SHARE:.0%} of the device's "
                       f"{free / 1e9:.1f} GB of free memory")
        else:
            budget = _CPU_CHUNK_BUDGET_BYTES
            assumed = f"{budget / 1e9:.0f} GB of host memory"
        assumed += (f" at {_CHUNK_VALUES_PER_PAIR} values of {itemsize} "
                    "bytes per (row, point) pair")
        return max(256, int(budget / per_row)), assumed

    def _chunk_fitter(
        self,
        matern_ellipse: EllipseModel,
        lane: str,
        tol: float,
        geo_cfg: dict,
        x0_single,
        bounds,
        device=None,
    ):
        """``fit(sel) -> (x, fun, nit, success, has_data)`` for one chunk
        of centre indices, and ``build(sel) -> (X, z_y, w)``: the training
        data (Fisher-transformed observations) and the batched optimiser
        of `lane` ("nm", "lm" or "lbfgs") on it. Everything stays on
        `device` (default this object's), which holds its own copy of the
        coordinates and the correlation. Nelder-Mead's stacked objective
        calls run on K5 where ``_k5_takes``, else on the vmapped
        ``_nll_fit_z``."""
        device = self.device if device is None else torch.device(device)
        lats_all, lons_all = (t.to(device) for t in self._point_coords())
        lazy = isinstance(self.cor, _LazyCorrelation)
        cor = (self.cor.normalised_samples if lazy else self.cor).to(device)
        x0_single = x0_single.to(device)
        bounds = tuple(b.to(device) for b in bounds)
        if _k5_takes(matern_ellipse, lane, device, cor.dtype):
            stacked = functools.partial(
                ellipse_nll.fisher_z_nll, v=matern_ellipse.v,
                fit_sigma=not matern_ellipse.unit_sigma)
        else:
            stacked = stacked_objective(matern_ellipse._nll_fit_z, 3)

        def build(sel):
            return _chunk_train_data(
                lats_all, lons_all, cor,
                torch.as_tensor(sel, device=device),
                **geo_cfg, fisher_z=True, lazy_cor=lazy,
            )

        def fit(sel):
            with span("mle.build"):
                X, y, w = build(sel)
                has_data = torch.sum(w, dim=1) > 0
            x0 = x0_single[None, :].expand(len(sel), x0_single.shape[0])
            with span("mle.solve"):
                if lane == "lm":
                    res = batched_levenberg_marquardt(
                        matern_ellipse._residuals_fit_z, x0, (X, y, w),
                        bounds, xtol=tol)
                elif lane == "lbfgs":
                    res = batched_lbfgs(
                        matern_ellipse._nll_fit_z, x0, (X, y, w), bounds,
                        tol=tol)
                else:
                    res = batched_nelder_mead(
                        None, x0, (X, y, w), bounds, xatol=tol, fatol=tol,
                        stacked_fun=stacked)
            return res.x, res.fun, res.nit, res.success, has_data

        return fit, build

    def _slot_fitter(self, slots, *fitter_args):
        """``(fit, se)`` for a chunk of lanes split over the device
        `slots` in equal contiguous runs (the chunk's length divides by
        their count): each slot builds its lanes' training data against
        its own copy of the correlation and runs the batched optimiser on
        them (``_chunk_fitter(*fitter_args)``); ``se(fun, sel, xs)`` is
        the Hessian standard-error pass at the optima `xs`, split the
        same way. Results land on this object's device."""
        fitters = [self._chunk_fitter(*fitter_args, device=d) for d in slots]

        def runs(sel):
            return np.split(np.asarray(sel), len(slots))

        def fit(sel):
            outs = [f[0](run) for f, run in zip(fitters, runs(sel))]
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(5))

        def se(fun, sel, xs):
            width = len(sel) // len(slots)
            return torch.cat([
                _chunk_hessian_se(fun, f[1](run),
                                  xs[k * width:(k + 1) * width].to(d)
                                  ).to(self.device)
                for k, (f, run, d) in enumerate(zip(fitters, runs(sel),
                                                    slots))])

        return fit, se

    @staticmethod
    def _geometry(matern_ellipse, min_distance, max_distance,
                  delta_x_method, physical_distance_selection,
                  max_train_cols) -> dict:
        """The training-data selection's arguments of a fit."""
        return dict(
            min_distance=float(min_distance),
            max_distance=float(max_distance),
            anisotropic=matern_ellipse.anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=matern_ellipse.physical_distance,
            physical_distance_selection=bool(physical_distance_selection),
            max_train_cols=max_train_cols,
        )

    def fit_cells(
        self,
        cells,
        matern_ellipse: EllipseModel,
        *,
        max_distance: float = 6000,
        min_distance: float = 0.3,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float = 1e-4,
        max_train_cols: int | None = None,
        physical_distance_selection: bool = True,
        chunk_size: int | None = None,
    ) -> CellFits:
        """Fit the ellipses of the given cells in one batched optimiser
        call, on this object's device: the fit ``compute_params`` makes
        of each of its chunks, for any selection of cells.

        `cells` are indices into the unmasked points (``xy_masked``'s
        rows: a flattened (lat, lon) index where the cube has no mask),
        one lane each, in their order; the lanes are padded with the
        first cell up to `chunk_size` (default: no padding), as
        ``compute_params`` pads its last chunk, so that calls on
        selections of different sizes share one shape. The keyword
        arguments are ``compute_params``' fit arguments, under its names
        and defaults.

        Returns a ``CellFits`` of tensors on this object's device, one row
        a given cell (the padding dropped): the raw optimum (before the
        Lx >= Ly canonicalisation and the QC codes, which
        ``compute_params`` applies on the host), the objective at it (for
        Nelder-Mead and L-BFGS the Fisher-z negative log-likelihood in
        float64, for Levenberg-Marquardt half its residuals' sum of
        squares), the lane's iterations, whether it converged, and whether
        its distance window held any point. Nothing is read on the host
        but what the optimiser itself reads.

        Spans ``mle.fit`` over the call, ``mle.build`` (the training data)
        and ``mle.solve`` (the optimiser) in it; ``mle.lanes`` counts the
        lanes handed to the optimiser, padding included.
        """
        lane = _optimiser_lane(opt_method)
        cells = np.asarray(cells)
        n_points = len(self.xi_masked)
        if cells.ndim != 1 or cells.size == 0 or (
                cells.dtype.kind not in "iu"):
            raise ValueError("cells must be a non-empty 1-D array of "
                             "integer indices")
        if cells.min() < 0 or cells.max() >= n_points:
            raise IndexError(f"cells must lie in [0, {n_points}), the "
                             "unmasked points")
        lanes = cells.size if chunk_size is None else int(chunk_size)
        if lanes < cells.size:
            raise ValueError(f"{cells.size} cells exceed chunk_size "
                             f"{lanes}")
        with span("mle.fit"):
            x0, box, _ = matern_ellipse._fit_setup(
                guesses, bounds, self._x_centered.dtype, self.device)
            geometry = self._geometry(
                matern_ellipse, min_distance, max_distance, delta_x_method,
                physical_distance_selection, max_train_cols)
            fit, _ = self._slot_fitter([self.device], matern_ellipse, lane,
                                       float(tol), geometry, x0, box)
            return self._fit_chunk(fit, cells, lanes)

    @staticmethod
    def _fit_chunk(fit, cells: np.ndarray, lanes: int) -> CellFits:
        """One call of `fit` (``_slot_fitter``'s) on `cells` padded to
        `lanes`, the padding dropped: the chunk logic ``fit_cells`` and
        ``compute_params`` share."""
        count("mle.lanes", lanes)
        return CellFits(*(t[:cells.size] for t in fit(_padded(cells,
                                                              lanes))))

    def compute_params(  # noqa: C901
        self,
        default_value: Any,
        matern_ellipse: EllipseModel,
        max_distance: float = 6000,
        min_distance: float = 0.3,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float = 1e-4,
        estimate_SE: str | None = None,
        n_jobs: int | None = None,
        n_sim: int = 500,
        physical_distance_selection: bool = True,
        chunk_size: int = 1024,
        max_train_cols: int | None = None,
        checkpoint: str | None = None,
        checkpoint_every: int = 8,
        dispatch_chunks: int = 1,
        mesh=None,
        mesh_axis: str = "grid",
    ) -> Dataset:
        """Fit ellipses at ALL unmasked grid points, batched on this
        object's device.

        `chunk_size` points are fitted at a time with the batched
        optimiser, each chunk as ``fit_cells`` fits it. Returns a Dataset
        of parameter fields (qc_code semantics: 0 ok / 1 lower bound / 2
        upper bound / 3 multiple bounds / 9 no convergence or no training
        data).

        `estimate_SE="hessian"` adds Fisher-information standard-error
        fields (``Lx_se``/``Ly_se``/``theta_se``/``R_se``): each
        converged lane's autodiff Hessian of the same weighted objective,
        inverted on the device, in a second pass AFTER the fit, at the
        raw optima. Bound-pinned or failed lanes get NaN. The bootstrap
        values of `estimate_SE` (and `n_jobs`/`n_sim`) are accepted for
        signature parity but ignored here: use ``fit_ellipse_model`` for
        a single point's bootstrap SE.

        `opt_method` "Nelder-Mead" (default), "lm" (Levenberg-Marquardt
        on the exact Fisher-z least-squares form of the likelihood: the
        same optimum in ~20 damped Gauss-Newton iterations instead of
        hundreds of simplex steps, with per-lane damping), or "L-BFGS-B"
        (gradient-based). In float32 prefer "lm": the simplex compares
        likelihoods that differ by less than their f32 rounding once its
        steps are small, and closes early on some lanes with the angle
        where it started, while LM reads the slopes from its Jacobian.
        Measured on the 64,800 lanes of the 1-degree grid (NVIDIA H100
        80GB HBM3, 700 W, ``chip_smoke.py`` phase 16, f32 against the
        f64 simplex on 4,096 lanes): "lm" meets it within 1% and 0.02 rad
        on 97% of lanes in 30-56 s for the grid, "Nelder-Mead" on 55% in
        72-80 s. In float64 the two agree on those lanes; on polar lanes
        the simplex can end on a bound where "lm" finds the lower
        likelihood inside the box.

        `max_train_cols` caps the training correlations per fit to the K
        nearest in-window grid points (a top-k gather). Whole-grid cost
        scales as n_points x n_cols; K = 4096 keeps every fit's window
        of the 1-degree grid out to ~3500 km. When the distance window
        holds fewer than K points this equals the unrestricted fit (up
        to float reassociation from the gather's column reorder); None
        (default) = all columns.

        `checkpoint` (a file path) makes the whole-grid fit RESUMABLE:
        every `checkpoint_every` chunks the accumulated per-point results
        are flushed to an ``.npz`` (written atomically), and a rerun with
        the same configuration continues from the last saved chunk
        instead of refitting; a fully-saved checkpoint returns without
        touching the device. A checkpoint records a fingerprint of the
        fit configuration (grid size, a checksum of the training data,
        model, optimiser, chunking, window) and refuses to resume a run
        whose configuration differs; a checkpoint whose fingerprint has
        another set of keys (an older format) is refitted with a warning.
        Between flushes the results stay on the device, so that one
        chunk's host fetch does not wait on the next chunk's solve.

        `chunk_size` is capped so that a chunk's (B, N) training-data
        build stays inside a share of the device's free memory (a
        warning says what was assumed).

        `dispatch_chunks` is accepted for signature parity and changes
        nothing: chunks are dispatched one by one.

        `mesh` (a ``parallel.make_mesh`` mesh) splits each chunk's lanes
        over the slots of `mesh_axis`, in contiguous runs: each slot
        rebuilds the training rows of its own lanes against its copy of
        the correlation and runs the batched optimiser on them, with no
        collectives (the fits are independent, and a batched optimiser
        freezes each lane once it converges, so the split moves no
        lane's optimum). The per-slot (B / n_slots, N) build is what the
        memory cap bounds, so the cap scales by the slot count;
        `chunk_size` is rounded down to a multiple of it, with a
        warning, and a grid smaller than one chunk rounds its row length
        up to it. The standard errors follow the same split.
        """
        lane = _optimiser_lane(opt_method)
        coords = Coordinates(
            {
                "latitude": np.asarray(self.coords["latitude"]),
                "longitude": np.asarray(self.coords["longitude"]),
            }
        )
        param_names = matern_ellipse.supercategory_params
        params = init_parameter_set(
            coords, parameters=param_names, default_value=default_value
        )

        n_points = len(self.xi_masked)
        if n_points == 0:
            return params

        xc = self._x_centered
        # under a mesh each slot builds (B / n_slots, N) at a time
        slots = ([self.device] if mesh is None
                 else mesh.axis_devices(mesh_axis))
        n_dev = len(slots)
        cap, assumed = self._chunk_cap(n_points, xc.element_size())
        cap *= n_dev
        if chunk_size > cap:
            cap -= cap % 256
            warn(
                f"chunk_size {chunk_size} -> {cap}: (B, N) fit temps "
                f"at N={n_points} would exceed {assumed}"
            )
            chunk_size = cap
        if mesh is not None:
            rounded = max(n_dev, chunk_size - chunk_size % n_dev)
            if rounded != chunk_size:
                warn(
                    f"chunk_size {chunk_size} -> {rounded}: the sharded "
                    f"fit needs a multiple of the {mesh_axis!r} axis "
                    f"size {n_dev}"
                )
                chunk_size = rounded

        x0_single, (lo, hi), bounds_out = matern_ellipse._fit_setup(
            guesses, bounds, xc.dtype, self.device
        )
        d = x0_single.shape[0]

        # --- checkpoint/resume ------------------------------------------------
        # Host-side accumulators hold FETCHED results for [0, n_done);
        # `pending` holds device results not yet flushed. The fingerprint
        # pins every input that changes the per-point answer or the
        # chunk alignment, including a checksum of the TRAINING DATA
        # itself (two device reductions, one scalar fetch each, rounded
        # so reduction-order jitter can't refuse a legitimate resume):
        # without it, a checkpoint written against a different training
        # cube would silently return the old cube's fits.
        data_sum = float(f"{float(torch.sum(xc)):.6e}")
        data_sumsq = float(f"{float(torch.sum(xc * xc)):.6e}")
        fingerprint = json.dumps(
            {
                "n_points": n_points,
                "data": [int(xc.shape[0]), data_sum, data_sumsq],
                "model": matern_ellipse.model_type,
                "opt": opt_method,
                "chunk": chunk_size,
                "d": d,
                "tol": tol,
                "win": [float(min_distance), float(max_distance)],
                "cols": max_train_cols,
                "dx": delta_x_method,
                "phys_sel": bool(physical_distance_selection),
                "x0": _host(x0_single).tolist(),
                "lo": _host(lo).tolist(),
                "hi": _host(hi).tolist(),
            },
            sort_keys=True,
        )
        host_parts: dict[str, list[np.ndarray]] = {
            "x": [], "nit": [], "success": [], "has_data": []
        }
        n_done = 0
        if checkpoint is not None and os.path.exists(checkpoint):
            with np.load(checkpoint) as data:
                saved_fp = str(data["fingerprint"])
                if saved_fp != fingerprint:
                    # A fingerprint with ANOTHER KEY SET is an older
                    # format of this library: refit fresh, with a
                    # warning. The same keys with other values are a
                    # genuine configuration/data mismatch: refuse, since
                    # silently mixing fits is the failure the fingerprint
                    # exists to prevent.
                    try:
                        saved_keys = set(json.loads(saved_fp))
                    except (json.JSONDecodeError, TypeError):
                        # unparseable/corrupt fingerprint, NOT a known
                        # older format: refuse rather than scheduling
                        # the file for overwrite
                        saved_keys = None
                    if saved_keys is None or saved_keys == set(
                        json.loads(fingerprint)
                    ):
                        raise ValueError(
                            f"checkpoint {checkpoint!r} was written by "
                            "a fit with a different configuration — "
                            "delete it (or point elsewhere) to refit"
                        )
                    warn(
                        f"checkpoint {checkpoint!r} uses an older "
                        "fingerprint format; refitting from scratch "
                        "(the file will be overwritten)"
                    )
                else:
                    n_done = int(data["n_done"])
                    for name in host_parts:
                        host_parts[name].append(data[name][:n_done])
            if n_done:
                logger.info(
                    "resuming whole-grid fit from %s: %d/%d points done",
                    checkpoint, n_done, n_points,
                )

        pending: list[CellFits] = []

        def _flush(save: bool) -> None:
            nonlocal n_done
            for fits in pending:
                for name, parts in host_parts.items():
                    parts.append(_host(getattr(fits, name)))
                n_done += len(fits.x)
            pending.clear()
            if save and checkpoint is not None:
                tmp = checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    fingerprint=np.asarray(fingerprint),
                    n_done=np.asarray(n_done),
                    **{
                        name: np.concatenate(parts, axis=0)
                        if parts
                        else np.zeros((0,))
                        for name, parts in host_parts.items()
                    },
                )
                os.replace(tmp, checkpoint)

        # every chunk shares ONE length: chunk_size when the grid spans
        # several chunks, else the single short chunk, rounded UP to the
        # slot count so that the slots split it evenly
        row_len = (chunk_size if n_points > chunk_size
                   else -(-n_points // n_dev) * n_dev)

        fit_chunk, chunk_se = self._slot_fitter(
            slots, matern_ellipse, lane, float(tol),
            self._geometry(matern_ellipse, min_distance, max_distance,
                           delta_x_method, physical_distance_selection,
                           max_train_cols),
            x0_single, (lo, hi))
        for start in range(n_done, n_points, chunk_size):
            cells = np.arange(start, min(start + chunk_size, n_points))
            # results stay ON THE DEVICE until a flush: fetching here
            # would make this chunk's host work wait on its solve
            pending.append(self._fit_chunk(fit_chunk, cells, row_len))
            if checkpoint is not None and len(pending) >= checkpoint_every:
                _flush(save=True)

        _flush(save=checkpoint is not None)

        fitted = np.concatenate(host_parts["x"], axis=0)
        nits = np.concatenate(host_parts["nit"], axis=0)
        successes = np.concatenate(host_parts["success"], axis=0)
        has_data = np.concatenate(host_parts["has_data"], axis=0)

        names = list(param_names.keys())
        for i in np.where(~has_data)[0]:
            warn(f"No training data for idx {i}")

        n_model = len(names) - 3  # minus stdev / qc / niter slots
        pm, score, swap = _postprocess_fits(
            fitted, successes, matern_ellipse, bounds_out, n_model)

        vals = np.column_stack(
            [
                pm,
                np.sqrt(np.asarray(self.cov_diagonal)[:n_points]),
                score.astype(float),
                nits.astype(float),
            ]
        )
        gj = np.asarray(self.yi_masked)[:n_points][has_data]
        gi = np.asarray(self.xi_masked)[:n_points][has_data]
        for k, name in enumerate(names):
            params[name].values[gj, gi] = vals[has_data, k]

        if estimate_SE == "hessian":
            # second pass, at the RAW optima (before the Lx >= Ly
            # canonicalisation) so the curvature matches the objective
            # actually minimised; SEs then swap with the axes
            fitted_dev = torch.as_tensor(fitted, dtype=xc.dtype,
                                         device=self.device)
            se_pending = []
            for start in range(0, n_points, chunk_size):
                cells = np.arange(start, min(start + chunk_size, n_points))
                sel = _padded(cells, row_len)
                se_pending.append((chunk_se(
                    matern_ellipse._nll_fit_z, sel,
                    fitted_dev[torch.as_tensor(sel, device=self.device)]),
                    cells.size))
            ses = np.concatenate(
                [_host(s)[:k] for s, k in se_pending], axis=0
            ).astype(float)
            # axis-swapped lanes swap their SEs with them
            if matern_ellipse.anisotropic:
                ses[swap, 0], ses[swap, 1] = (
                    ses[swap, 1].copy(), ses[swap, 0].copy()
                )
            ses[score == 9] = np.nan  # failed fits carry no information
            grid_shape = params[names[0]].values.shape
            for k in range(n_model):
                se_name = f"{names[k]}_se"
                field = np.full(grid_shape, np.nan, dtype=float)
                field[gj, gi] = ses[has_data, k]
                params[se_name] = DataArray(
                    field,
                    params[names[0]].coords,
                    name=se_name,
                    attrs={"units": param_names[names[k]]},
                )

        return params

    # -- lookups ---------------------------------------------------------------
    def find_nearest_xy_index_in_cov_matrix(
        self, lonlat, use_full: bool = False
    ) -> tuple[int, np.ndarray]:
        """Nearest covariance row/column index for a (lon, lat) position."""
        lon, lat, *_ = lonlat
        a = self.xy_full if use_full else self.xy_masked
        idx = int(((a[:, 0] - lon) ** 2.0 + (a[:, 1] - lat) ** 2.0).argmin())
        return idx, a[idx, :]

    def _xy_2_xy_full_index(self, xy_point: int) -> int:
        """Index within the full (uncompressed) flattened grid."""
        return int(
            np.argwhere(
                np.all(
                    (self.xy_full - self.xy_masked[xy_point, :]) == 0,
                    axis=1,
                )
            )[0]
        )

    def __str__(self) -> str:
        return str(self.__class__)


def _chunk_hessian_se(fun, train_data, xs):
    """sqrt(diag(H^{-1})) at each lane's optimum, (B, d).

    H is the autodiff Hessian of the SAME weighted Fisher-z objective the
    fit minimised. Non-positive-curvature directions (bound-pinned or
    failed lanes) yield NaN.
    """
    X, y, w = train_data

    def lane_hessian(x, X_i, y_i, w_i):
        return torch.func.hessian(lambda p: fun(p, X_i, y_i, w_i))(x)

    out = []
    for s in range(0, xs.shape[0], _SE_LANES):
        e = s + _SE_LANES
        H = torch.func.vmap(lane_hessian)(xs[s:e], X[s:e], y[s:e], w[s:e])
        dg = torch.diagonal(torch.linalg.inv_ex(H).inverse, dim1=1, dim2=2)
        out.append(torch.sqrt(
            torch.where(dg > 0, dg, torch.full_like(dg, math.nan))))
    return torch.cat(out)


def _postprocess_fits(fitted, successes, matern_ellipse, bounds_out,
                      n_model):
    """Vectorised canonicalisation and QC of raw optima (numpy, (n, d)):
    the scalar ``_check_params`` / ``_get_fit_score`` pipeline over all
    points at once. Returns (model parameters (n, n_model), qc codes,
    the Lx/Ly swap mask)."""
    p = fitted.astype(float).copy()
    swap = np.zeros(len(p), dtype=bool)
    if matern_ellipse.anisotropic:
        swap = p[:, 1] > p[:, 0]
        p[swap, 0], p[swap, 1] = fitted[swap, 1], fitted[swap, 0]
        if matern_ellipse.rotated:
            p[swap, 2] += np.pi / 2
    if matern_ellipse.rotated:
        th = p[:, 2]
        th = np.where(th > np.pi, th - np.pi, th)
        th = np.where(th <= -np.pi, th + np.pi, th)
        p[:, 2] = th
    pm = p[:, :n_model]

    score = np.zeros(len(p), dtype=int)
    for j, bb in enumerate(bounds_out[:n_model]):
        a = pm[:, j]
        # math.isclose(a, b, rel_tol=0.01) semantics
        tol = 0.01 * np.maximum(np.abs(a), abs(bb[0]))
        left = np.abs(a - bb[0]) <= tol
        tol = 0.01 * np.maximum(np.abs(a), abs(bb[1]))
        right = np.abs(a - bb[1]) <= tol
        score = np.where(left, np.where(score == 0, 1, 3), score)
        score = np.where(right, np.where(score == 0, 2, 3), score)
    score = np.where(successes, score, 9)
    return pm, score, swap


def _nearest_train_cols(X, y, w, k: int, anisotropic: bool):
    """Gather each centre's k nearest IN-WINDOW training columns.

    Out-of-window columns (w == 0) sort to the back (+inf distance); if
    a window holds fewer than k points the excess gathered columns keep
    w = 0 and never enter the weighted NLL, so whenever k covers the
    window the fit equals the unrestricted one (up to float
    reassociation from the column reorder). Columns at one distance (a
    regular grid has many) are taken in no particular order: which of
    the tied columns at the k-th distance are kept is not defined.

    X, y and w are gathered one by one: each gather moves only its own
    bytes, where packing them first costs a pass over all (B, N).
    """
    if anisotropic:
        d2 = X[..., 0] ** 2 + X[..., 1] ** 2
    else:
        d2 = X * X
    d2 = torch.where(w > 0, d2, torch.full_like(d2, torch.inf))
    cols = torch.topk(d2, k, dim=1, largest=False).indices  # (B, k)
    del d2
    y = torch.take_along_dim(y, cols, dim=1)
    w = torch.take_along_dim(w, cols, dim=1)
    if anisotropic:
        X = torch.take_along_dim(X, cols[..., None], dim=1)
    else:
        X = torch.take_along_dim(X, cols, dim=1)
    return X, y, w


def _get_fit_score(model_params, bounds, niter) -> int:
    """QC code: 0 ok, 1 lower bound hit, 2 upper, 3 multiple, 9 fail."""
    fit_success = 0
    for model_param, bb in zip(model_params, bounds):
        left = math.isclose(model_param, bb[0], rel_tol=0.01)
        right = math.isclose(model_param, bb[1], rel_tol=0.01)
        if left:
            fit_success = 1 if fit_success == 0 else 3
        if right:
            fit_success = 2 if fit_success == 0 else 3
    return fit_success


def init_parameter_set(
    coords, parameters: dict[str, str], default_value: Any = np.nan
) -> Dataset:
    """Initialise the (lat, lon) parameter fields for an ellipse model.

    `parameters` maps field name -> unit; `default_value` is scalar or a
    per-field list.
    """
    if not is_iter(default_value):
        default_value = [default_value] * len(parameters)
    if len(default_value) != len(parameters):
        raise ValueError(
            "Cannot set 6 default values for input default values"
        )
    if not isinstance(coords, Coordinates):
        coords = Coordinates({k: np.asarray(v) for k, v in coords.items()})
    shape = coords.shape
    params = Dataset({}, coords)
    for i, (name, unit) in enumerate(parameters.items()):
        params[name] = DataArray(
            np.full(shape, default_value[i], dtype=float),
            coords,
            name=name,
            attrs={"units": unit},
        )
    return params
