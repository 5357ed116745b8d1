r"""Kriging solvers (Simple / Ordinary) against a dense covariance, on
tensors.

Port of ``glomargridding_tpu/models/kriging.py`` (the classes, the
deprecated function forms, the observation helpers and the Guttman
extended inverse). The numerics follow the reference:

- One factorisation of :math:`K = C_{obs} + E` drives everything. The
  ordinary-kriging Lagrange system is solved as a bordered system on the
  same factor, never forming the (n+1) x (n+1) indefinite matrix:

  .. math::
      w_j = V_j - \lambda_j u, \qquad
      \lambda_j = \frac{\mathbf{1}^T V_j - 1}{\mathbf{1}^T u},

  with :math:`V = K^{-1} C_{cross}` and :math:`u = K^{-1}\mathbf{1}`.
- The uncertainty and constraint-mask diagonals are column reductions
  over C_cross and V, O(nM) memory.
- ``OrdinaryKriging(..., uncertainty="reference")`` (default) keeps the
  reference's published variance ``diag(C) - (w'c + lambda) - lambda``;
  "textbook" subtracts lambda once.

The covariance stays a tensor on its device, and so do the outputs. A
numpy covariance goes to `device`, by default the card (``cuda``; with
no card the classes raise, so a CPU run names ``device="cpu"``): a
64,800-cell f32 covariance is 16.8 GB, and no step here copies it to the
host. No product here may run in TF32: the port never changes
``torch.get_float32_matmul_precision()`` from "highest".
"""

from abc import ABC, abstractmethod
from typing import Literal
from warnings import warn

import numpy as np
import torch

from ..utils.arrays import (
    adjust_small_negative,
    get_spatial_mean,
    intersect_mtlb,
)
from ..utils.device import resolve_device
from ..utils.profiling import count

KrigMethod = Literal["simple", "ordinary"]


# ===========================================================================
# Functional core
# ===========================================================================
def _gather_obs_blocks(covariance, idx):
    """C_obs (n x n), C_cross (n x M), diag(C) from a dense covariance."""
    obs_grid = covariance[idx, :]
    return obs_grid[:, idx], obs_grid, torch.diagonal(covariance)


def _solve_sym(K, B):
    """Solve K X = B: Cholesky when K is positive definite, LU otherwise.

    Kriging systems built from true covariances take the Cholesky path;
    variogram-style systems (zero diagonal, the GeoStats.jl
    configuration) and covariances that are not positive definite take
    the LU path. ``COUNTS`` counts each (``kriging.solve.cholesky``,
    ``kriging.solve.lu``).
    """
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) == 0:
        count("kriging.solve.cholesky")
        return torch.cholesky_solve(B, L)
    count("kriging.solve.lu")
    return torch.linalg.solve(K, B)


def _column_dot(C_cross, V):
    """diag(C_cross' V): einsum('nm,nm->m')."""
    return torch.einsum("nm,nm->m", C_cross, V)


def _simple_core(K, C_cross, C_diag, y, mean):
    """Simple kriging: field, uncertainty^2, constraint mask, V.

    V = K^{-1} C_cross; field = V'y + mean; sigma^2 = diag(C) - sum(C.*V);
    mask = sum(C.*V)/diag(C).
    """
    V = _solve_sym(K, C_cross)
    field = V.T @ y + mean
    sv = _column_dot(C_cross, V)
    return field, C_diag - sv, sv / C_diag, V


def _ordinary_core(K, C_cross, C_diag, y):
    """Ordinary kriging via the bordered system on one factorisation.

    Returns field, uncertainty^2 (reference formula), constraint mask
    (simple-weights based), V, u, lambda.
    """
    n = K.shape[0]
    ones = torch.ones((n, 1), dtype=K.dtype, device=K.device)
    Vu = _solve_sym(K, torch.cat([C_cross, ones], dim=1))
    V = Vu[:, :-1]
    u = Vu[:, -1]
    s = torch.sum(u)
    t = torch.sum(V, dim=0)
    lam = (t - 1.0) / s
    field = V.T @ y - lam * (u @ y)
    sv = _column_dot(C_cross, V)
    # w_j'c_j = sv_j - lam_j (u'c_j), and u'c_j = 1'K^{-1}c_j = t_j
    wc = sv - lam * t
    uncert2 = C_diag - (wc + lam) - lam
    return field, uncert2, sv / C_diag, V, u, lam


def _extended_inverse(simple_inv):
    """Guttman (1946) block inverse of [[S, 1], [1', 0]] from S^{-1}."""
    S_inv = torch.as_tensor(simple_inv)
    if S_inv.dim() != 2:
        raise ValueError("S must be a matrix")
    n = S_inv.shape[0]
    B = torch.ones((n, 1), dtype=S_inv.dtype, device=S_inv.device)
    E = S_inv @ B
    finv = 1.0 / -(B.T @ E)
    G = finv * E.T
    top = torch.cat([S_inv + E @ G, -G.T], dim=1)
    bottom = torch.cat([-G, finv], dim=1)
    return torch.cat([top, bottom], dim=0)


def _finalise_uncert(uncert2):
    """sqrt of the clamped squared uncertainty, NaN -> 0."""
    uncert = torch.sqrt(adjust_small_negative(uncert2))
    return torch.nan_to_num(uncert, nan=0.0, posinf=torch.inf,
                            neginf=-torch.inf)


# ===========================================================================
# Classes
# ===========================================================================
class Kriging(ABC):
    """Kriging base: covariance C, obs indices, obs values, error cov.

    Use SimpleKriging or OrdinaryKriging. `idx` are row-major 1-d grid
    indices of the observed grid boxes, one per box (average several
    observations per box first, ``prep_obs_for_kriging``). A full-grid
    `error_cov` is subset to `idx`; observations whose error-cov diagonal
    is NaN or 0 are dropped with a warning and remaining NaNs set to 0
    (parity: ``glomargridding_tpu/models/kriging.py:213-263``).
    Everything lives on the covariance's device (``resolve_device``: a
    numpy covariance goes to `device`, by default the card).
    """

    def __init__(self, covariance, idx, obs, error_cov=None,
                 device=None) -> None:
        if not hasattr(self, "method"):
            raise NotImplementedError(
                "Do not use the generic class directly, "
                "use SimpleKriging or OrdinaryKriging"
            )
        self.covariance = torch.as_tensor(covariance, device=resolve_device(
            device, covariance, idx, obs, error_cov))
        dev = self.covariance.device
        self.idx = torch.as_tensor(idx, device=dev).long()
        self.obs = torch.as_tensor(obs, device=dev)
        self.error_cov = (
            None if error_cov is None
            else torch.as_tensor(error_cov, device=dev)
        )
        self.subset_error_covariance()

    def subset_error_covariance(self) -> None:
        """Subset E to obs indices; drop NaN/zero-diagonal observations."""
        if self.error_cov is None:
            return
        if self.error_cov.shape[0] != len(self.idx):
            self.error_cov = self.error_cov[
                self.idx[:, None], self.idx[None, :]
            ]
        diag = torch.diagonal(self.error_cov)
        mismatch = torch.isnan(diag) | (diag == 0)
        if bool(mismatch.any()):
            keep = torch.nonzero(~mismatch)[:, 0]
            drop_idx = self.idx[mismatch].tolist()
            warn(
                "Have nans or zeros on the error covariance diagonal. "
                "At positions "
                + " ,".join(map(str, drop_idx))
                + ". Filtering input accordingly"
            )
            self.idx = self.idx[keep]
            self.obs = self.obs[keep]
            self.error_cov = self.error_cov[keep[:, None], keep[None, :]]
        self.error_cov = torch.nan_to_num(self.error_cov, nan=0.0)

    def _blocks(self):
        """(K, C_cross, C_diag), error covariance folded in; cached."""
        if getattr(self, "_blocks_cache", None) is None:
            obs_obs, obs_grid, diag = _gather_obs_blocks(
                self.covariance, self.idx
            )
            if self.error_cov is not None:
                obs_obs = obs_obs + self.error_cov.to(obs_obs.dtype)
            self._blocks_cache = (obs_obs, obs_grid, diag)
        return self._blocks_cache

    def _obs(self, dtype):
        return self.obs.to(dtype)

    def set_kriging_weights(self, kriging_weights) -> None:
        """Inject pre-computed kriging weights."""
        self.kriging_weights = torch.as_tensor(
            kriging_weights, device=self.covariance.device
        )

    @abstractmethod
    def get_kriging_weights(self) -> None: ...

    @abstractmethod
    def kriging_weights_from_inverse(self, inv) -> None: ...

    @abstractmethod
    def solve(self): ...

    @abstractmethod
    def get_uncertainty(self): ...

    @abstractmethod
    def constraint_mask(self): ...


class SimpleKriging(Kriging):
    r"""Simple kriging: field = W y + mu with W = (C_obs+E)^{-1} C_cross.

    (Parity: ``glomargridding_tpu/models/kriging.py:318-384``.)
    """

    method: str = "simple"

    def get_kriging_weights(self) -> None:
        """Compute (and set) the M x n simple kriging weights W."""
        K, C_cross, _ = self._blocks()
        self.kriging_weights = _solve_sym(K, C_cross).T

    def kriging_weights_from_inverse(self, inv) -> None:
        """Set weights from a pre-computed (C_obs+E)^{-1}."""
        if len(self.idx) != inv.shape[0]:
            raise ValueError("inv must be square with side length == len(idx)")
        _, C_cross, _ = self._blocks()
        inv = torch.as_tensor(inv, dtype=C_cross.dtype, device=C_cross.device)
        self.kriging_weights = (inv @ C_cross).T

    def solve(self, mean=0.0):
        """Kriged field W y + mean (uses set weights when present)."""
        if hasattr(self, "kriging_weights"):
            W = self.kriging_weights
            return W @ self._obs(W.dtype) + mean
        K, C_cross, C_diag = self._blocks()
        field, uncert2, cmask, V = _simple_core(
            K, C_cross, C_diag, self._obs(K.dtype), mean
        )
        self.kriging_weights = V.T
        self._uncert2 = uncert2
        self._cmask = cmask
        return field

    def get_uncertainty(self):
        """sqrt(diag(C) - diag(W C_cross)), small negatives clamped."""
        if hasattr(self, "_uncert2"):
            return _finalise_uncert(self._uncert2)
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, C_cross, C_diag = self._blocks()
        return _finalise_uncert(
            C_diag - _column_dot(C_cross, self.kriging_weights.T)
        )

    def constraint_mask(self):
        """Observational-constraint diagnostic (Morice 2021 A14,
        corrected): diag(C_cross' (C_obs+E)^{-1} C_cross) / diag(C)."""
        if hasattr(self, "_cmask"):
            return self._cmask
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, C_cross, C_diag = self._blocks()
        return _column_dot(C_cross, self.kriging_weights.T) / C_diag


class OrdinaryKriging(Kriging):
    r"""Ordinary kriging: Lagrange-constrained weights summing to 1.

    The bordered solve reuses one factorisation of K. The exposed
    `kriging_weights` keep the reference's layout: M x (n+1) with the
    Lagrange multiplier in the last column. ``uncertainty`` selects the
    variance convention, "reference" (default: the double lambda
    subtraction of the reference's published formula) or "textbook".
    (Parity: ``glomargridding_tpu/models/kriging.py:387-510``.)
    """

    method: str = "ordinary"

    def __init__(
        self,
        covariance,
        idx,
        obs,
        error_cov=None,
        *,
        uncertainty: Literal["reference", "textbook"] = "reference",
        device=None,
    ) -> None:
        if uncertainty not in ("reference", "textbook"):
            raise ValueError(
                f"Unknown 'uncertainty' convention: {uncertainty!r}"
            )
        self.uncertainty_convention = uncertainty
        super().__init__(covariance, idx, obs, error_cov, device)

    def _full_solve(self):
        K, C_cross, C_diag = self._blocks()
        field, uncert2, cmask, V, u, lam = _ordinary_core(
            K, C_cross, C_diag, self._obs(K.dtype)
        )
        # reference-layout weights: rows w_j = V_j - lam_j u, last col lam
        W = V.T - lam[:, None] * u[None, :]
        self.kriging_weights = torch.cat([W, lam[:, None]], dim=1)
        self._uncert2 = uncert2
        self._lam = lam
        self._cmask = cmask
        self._field = field
        return field

    def get_kriging_weights(self) -> None:
        """Compute (and set) the M x (n+1) extended kriging weights."""
        self._full_solve()

    def _extended_cross(self):
        _, C_cross, _ = self._blocks()
        ones = torch.ones((1, C_cross.shape[1]), dtype=C_cross.dtype,
                          device=C_cross.device)
        return torch.cat([C_cross, ones], dim=0)

    def kriging_weights_from_inverse(self, inv) -> None:
        """Weights from a pre-computed inverse of the EXTENDED system."""
        if len(self.idx) != inv.shape[0] - 1:
            raise ValueError("inv must be square with side length == len(idx)")
        ext = self._extended_cross()
        inv = torch.as_tensor(inv, dtype=ext.dtype, device=ext.device)
        self.kriging_weights = (inv @ ext).T

    def solve(self):
        """Kriged field; computes weights lazily via the bordered solve."""
        if hasattr(self, "_field"):
            return self._field
        if hasattr(self, "kriging_weights"):
            W = self.kriging_weights
            zero = torch.zeros(1, dtype=W.dtype, device=W.device)
            return W @ torch.cat([self._obs(W.dtype), zero])
        return self._full_solve()

    def get_uncertainty(self):
        """OK uncertainty in the selected convention (see class docs).

        reference: diag(C) - (w'c + lam) - lam (double subtraction);
        textbook:  diag(C) - w'c - lam (= reference + lam).
        """
        textbook = self.uncertainty_convention == "textbook"
        if hasattr(self, "_uncert2"):
            uncert2 = self._uncert2
            if textbook:
                uncert2 = uncert2 + self._lam
            return _finalise_uncert(uncert2)
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, _, C_diag = self._blocks()
        Wext = self.kriging_weights
        ext = self._extended_cross().to(Wext.dtype)
        # w'c + lam (the ones row contributes lam once)
        uncert2 = C_diag - _column_dot(ext, Wext.T)
        if not textbook:
            uncert2 = uncert2 - Wext[:, -1]
        return _finalise_uncert(uncert2)

    def constraint_mask(self, simple_kriging_weights=None):
        """Constraint mask from the SIMPLE kriging weights of the system."""
        K, C_cross, C_diag = self._blocks()
        if simple_kriging_weights is None:
            if hasattr(self, "_cmask"):
                return self._cmask
            return _column_dot(C_cross, _solve_sym(K, C_cross)) / C_diag
        W = torch.as_tensor(simple_kriging_weights, dtype=C_cross.dtype,
                            device=C_cross.device)
        return _column_dot(C_cross, W.T) / C_diag

    def extended_inverse(self, simple_inv):
        """Guttman extended inverse (API parity helper)."""
        return _extended_inverse(simple_inv).to(self.covariance.dtype)


# ===========================================================================
# Observation preparation (numpy, host side)
# ===========================================================================
def prep_obs_for_kriging(
    unmask_idx,
    unique_obs_idx,
    weights,
    obs,
    remove_obs_mean: int = 0,
    obs_bias=None,
    error_cov=None,
):
    """Average per-gridbox observations and optionally remove a mean.

    remove_obs_mean: 0 none, 1 mean, 2 median, 3 GLS spatial mean (needs
    error_cov). Returns (obs_idx, grid_obs).
    (Parity: ``glomargridding_tpu/models/kriging.py:516-559``.)
    """
    obs_idx = get_unmasked_obs_indices(
        np.asarray(unmask_idx), np.asarray(unique_obs_idx)
    )
    weights = np.asarray(weights)
    obs = np.asarray(obs)
    if obs_bias is not None:
        grid_obs = weights @ (obs - np.asarray(obs_bias))
    else:
        grid_obs = weights @ obs
    grid_obs = np.squeeze(grid_obs) if len(grid_obs) > 1 else grid_obs

    match remove_obs_mean:
        case 0:
            pass
        case 1:
            grid_obs = grid_obs - np.ma.average(grid_obs)
        case 2:
            grid_obs = grid_obs - np.ma.median(grid_obs)
        case 3:
            if error_cov is None:
                raise ValueError(
                    "'remove_obs_mean = 3 requires error covariance"
                )
            grid_obs = grid_obs - get_spatial_mean(grid_obs, error_cov)
        case _:
            raise ValueError("Unknown 'remove_obs_mean' value")
    return obs_idx, grid_obs


def get_unmasked_obs_indices(unmask_idx, unique_obs_idx):
    """Positions (within unmask_idx) of observed unmasked grid boxes."""
    unmask_idx = np.squeeze(unmask_idx) if unmask_idx.ndim > 1 else unmask_idx
    _, obs_idx, _ = intersect_mtlb(unmask_idx, unique_obs_idx)
    return obs_idx.astype(int)


# ===========================================================================
# Deprecated function forms (API parity)
# ===========================================================================
def _function_blocks(obs_obs_cov, obs_grid_cov, interp_cov, device):
    K = torch.as_tensor(obs_obs_cov, device=resolve_device(
        device, obs_obs_cov, obs_grid_cov, interp_cov))
    C_cross = torch.as_tensor(obs_grid_cov, dtype=K.dtype, device=K.device)
    C_diag = torch.diagonal(
        torch.as_tensor(interp_cov, dtype=K.dtype, device=K.device)
    )
    return K, C_cross, C_diag


def kriging_simple(obs_obs_cov, obs_grid_cov, grid_obs, interp_cov, mean=0.0,
                   device=None):
    """Deprecated function form of SimpleKriging: (field, uncertainty)
    from pre-gathered blocks, on `device` (``resolve_device``)."""
    warn("kriging_simple is deprecated, use SimpleKriging", DeprecationWarning)
    K, C_cross, C_diag = _function_blocks(obs_obs_cov, obs_grid_cov,
                                          interp_cov, device)
    y = torch.as_tensor(grid_obs, dtype=K.dtype, device=K.device)
    field, uncert2, _, _ = _simple_core(K, C_cross, C_diag, y, mean)
    return field, _finalise_uncert(uncert2)


def kriging_ordinary(obs_obs_cov, obs_grid_cov, grid_obs, interp_cov,
                     device=None):
    """Deprecated function form of OrdinaryKriging, on `device`
    (``resolve_device``)."""
    warn(
        "kriging_ordinary is deprecated, use OrdinaryKriging",
        DeprecationWarning,
    )
    K, C_cross, C_diag = _function_blocks(obs_obs_cov, obs_grid_cov,
                                          interp_cov, device)
    y = torch.as_tensor(grid_obs, dtype=K.dtype, device=K.device)
    field, uncert2, *_ = _ordinary_core(K, C_cross, C_diag, y)
    return field, _finalise_uncert(uncert2)


def constraint_mask(obs_obs_cov, obs_grid_cov, interp_cov, device=None):
    """diag(C_cross' (C_obs+E)^{-1} C_cross)/diag(C) (function form), on
    `device` (``resolve_device``)."""
    K, C_cross, C_diag = _function_blocks(obs_obs_cov, obs_grid_cov,
                                          interp_cov, device)
    return _column_dot(C_cross, _solve_sym(K, C_cross)) / C_diag
