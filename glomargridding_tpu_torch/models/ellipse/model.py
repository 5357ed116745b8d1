r"""Ellipse (non-stationary Matern) model and MLE fitting.

Port of ``glomargridding_tpu/models/ellipse/model.py``: the
Paciorek-Schervish 2006 / Karspeck 2012 Matern "ellipse" correlation
kernel in six taxonomy variants (iso / aniso / rotated x degrees /
physical distance), the Fisher-transformed Gaussian negative
log-likelihood, and maximum-likelihood fitting with Nelder-Mead, L-BFGS
or (whole-grid) Levenberg-Marquardt, with bootstrap or Hessian standard
errors.

- the kernel and the NLL are plain functions of tensors, written for ONE
  fit, with an optional weight mask so that a whole grid of fits shares
  one shape; the batched optimisers of ``ops.optim`` lift them over the
  lane axis with ``torch.func.vmap``;
- derivatives come from autograd: ``backward`` for L-BFGS,
  ``torch.func.jacfwd`` for Levenberg-Marquardt, ``torch.func.hessian``
  for the Fisher-information standard errors;
- bootstrap standard errors are one batched Nelder-Mead over resample
  weights.

``ops.special.xv_kv`` gives ``x**v K_v(x)`` for every order: the closed
form for half-integer orders, the Temme/Steed ``kv`` otherwise.
"""

import math
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from ...ops.distances import mahal_dist_func
from ...ops.optim import (
    batched_nelder_mead,
    lbfgs_minimize,
    nelder_mead,
)
from ...ops.special import xv_kv as _xv_kv
from ...types import FForm, ModelType, SuperCategory
from ...utils.device import resolve_device
from ...utils.frames import deg_to_km

ARCTANH_THRESHOLD = 0.999999

MODEL_TYPE_TO_SUPERCATEGORY: dict[ModelType, SuperCategory] = {
    "ps2006_kks2011_iso": "1_param_matern",
    "ps2006_kks2011_ani": "2_param_matern",
    "ps2006_kks2011_ani_r": "3_param_matern",
    "ps2006_kks2011_iso_pd": "1_param_matern_pd",
    "ps2006_kks2011_ani_pd": "2_param_matern_pd",
    "ps2006_kks2011_ani_r_pd": "3_param_matern_pd",
}

FFORM_TO_MODELTYPE: dict[FForm, ModelType] = {
    "anisotropic_rotated": "ps2006_kks2011_ani_r",
    "anisotropic": "ps2006_kks2011_ani",
    "isotropic": "ps2006_kks2011_iso",
    "anisotropic_rotated_pd": "ps2006_kks2011_ani_r_pd",
    "anisotropic_pd": "ps2006_kks2011_ani_pd",
    "isotropic_pd": "ps2006_kks2011_iso_pd",
}

SUPERCATEGORY_PARAMS: dict[SuperCategory, OrderedDict] = {
    "3_param_matern": OrderedDict(
        [
            ("Lx", "degrees"),
            ("Ly", "degrees"),
            ("theta", "radians"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "2_param_matern": OrderedDict(
        [
            ("Lx", "degrees"),
            ("Ly", "degrees"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "1_param_matern": OrderedDict(
        [
            ("R", "degrees"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "3_param_matern_pd": OrderedDict(
        [
            ("Lx", "km"),
            ("Ly", "km"),
            ("theta", "radians"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "2_param_matern_pd": OrderedDict(
        [
            ("Lx", "km"),
            ("Ly", "km"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "1_param_matern_pd": OrderedDict(
        [
            ("R", "km"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
}

FFORM_PARAMETERS: dict[str, dict[str, Any]] = {
    "isotropic": {
        "n_params": 1,
        "default_guesses": [7.0],
        "default_bounds": [(0.5, 50.0)],
    },
    "isotropic_pd": {
        "n_params": 1,
        "default_guesses": [deg_to_km(7.0)],
        "default_bounds": [(deg_to_km(0.5), deg_to_km(50.0))],
    },
    "anisotropic": {
        "n_params": 2,
        "default_guesses": [7.0, 7.0],
        "default_bounds": [(0.5, 50.0), (0.5, 30.0)],
    },
    "anisotropic_pd": {
        "n_params": 2,
        "default_guesses": [deg_to_km(7.0), deg_to_km(7.0)],
        "default_bounds": [
            (deg_to_km(0.5), deg_to_km(50.0)),
            (deg_to_km(0.5), deg_to_km(30.0)),
        ],
    },
    "anisotropic_rotated": {
        "n_params": 3,
        "default_guesses": [7.0, 7.0, 0.0],
        "default_bounds": [
            (0.5, 50.0),
            (0.5, 30.0),
            (-2.0 * math.pi, 2.0 * math.pi),
        ],
    },
    "anisotropic_rotated_pd": {
        "n_params": 3,
        "default_guesses": [deg_to_km(7.0), deg_to_km(7.0), 0.0],
        "default_bounds": [
            (deg_to_km(0.5), deg_to_km(50.0)),
            (deg_to_km(0.5), deg_to_km(30.0)),
            (-2.0 * math.pi, 2.0 * math.pi),
        ],
    },
}


# ===========================================================================
# Kernels (Paciorek-Schervish locally-stationary Matern)
# ===========================================================================
def cov_ij_anisotropic(
    v: float,
    stdev,
    delta_x,
    delta_y,
    Lx,
    Ly,
    stdev_j=None,
    theta=None,
):
    r"""Anisotropic ellipse correlation at displacements (delta_x, delta_y).

    .. math::
        c = \frac{\sigma \sigma_j}{\Gamma(\nu) 2^{\nu-1}}
            (2\tau\sqrt{\nu})^\nu K_\nu(2\tau\sqrt{\nu}),

    with :math:`\tau` the Mahalanobis distance under
    Sigma(Lx, Ly, theta). Assumes local stationarity (Sigma_i ~ Sigma_j),
    which drops the PS06 prefactor. `v` is a Python float; displacements
    and parameters are tensors.
    """
    stdev_j = stdev if stdev_j is None else stdev_j
    tau = mahal_dist_func(delta_x, delta_y, Lx, Ly, theta=theta)
    first = (stdev * stdev_j) / (math.gamma(v) * (2.0 ** (v - 1.0)))
    inner = 2.0 * tau * math.sqrt(v)
    return first * _xv_kv(v, inner)


def cov_ij_isotropic(v: float, stdev, delta, R, stdev_j=None):
    """Isotropic (circular) variant: Lx = Ly = R."""
    stdev_j = stdev if stdev_j is None else stdev_j
    tau = torch.abs(torch.as_tensor(delta)) / R
    first = (stdev * stdev_j) / (math.gamma(v) * (2.0 ** (v - 1.0)))
    inner = 2.0 * tau * math.sqrt(v)
    return first * _xv_kv(v, inner)


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _weighted_nll(z_obs, z_model, sigma, weights):
    r"""``-sum_j w_j log N(z_obs_j; z_model_j, sigma)`` as a float64 0-d
    tensor (`weights` None: every weight 1).

    The data term :math:`\sum_j w_j (z^{obs}_j - z^{model}_j)^2 / 2\sigma^2`
    and the constant :math:`(\log\sigma + \log\sqrt{2\pi}) \sum_j w_j`
    are kept apart and accumulated in float64 whatever the inputs' dtype.
    Added up per sample in float32, as the reference's
    ``-sum(norm.logpdf * w)`` is, the constant (0.92 a sample, ~3,800 for
    4,096 samples, one ulp 2.4e-4) swamps what separates two
    neighbouring candidates of a simplex, and a float32 Nelder-Mead
    gives up long before `tol`: on the 1-degree grid after a third of the
    float64 run's iterations, with the angle still at its start
    (PERF.md, the ellipse MLE). In float64 the value is the reference's
    to rounding.
    """
    r = (z_obs - z_model) / sigma
    half_sq = 0.5 * r * r
    if weights is None:
        data = torch.sum(half_sq, dtype=torch.float64)
        count = math.prod(half_sq.shape)
    else:
        data = torch.sum(half_sq * weights, dtype=torch.float64)
        count = torch.sum(weights, dtype=torch.float64)
    return data + count * (torch.log(sigma).double() + _LOG_SQRT_2PI)


def _clip_fisher(y):
    return torch.clamp(y, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)


class EllipseModel:
    """Ellipse correlation model + MLE fitting configuration.

    Inputs are standardised correlations (stdev == 1 inside the kernel).
    `unit_sigma=False` (default, as in Karspeck et al. 2012 practice)
    appends the likelihood scale as an extra fitted parameter.
    """

    def __init__(
        self,
        anisotropic: bool,
        rotated: bool,
        physical_distance: bool,
        v: float,
        unit_sigma: bool = False,
    ) -> None:
        if v <= 0:
            raise ValueError("'v' must be > 0")
        self.anisotropic = anisotropic
        self.rotated = rotated
        self.physical_distance = physical_distance
        self.v = float(v)
        self.unit_sigma = unit_sigma

        self._get_model_names()
        self.supercategory_params = SUPERCATEGORY_PARAMS[self.supercategory]
        self.supercategory_n_params = len(self.supercategory_params)
        self._get_defaults()

    def _get_model_names(self) -> None:
        if self.rotated and not self.anisotropic:
            raise ValueError("Cannot have an isotropic rotated fform")
        parts = ["anisotropic" if self.anisotropic else "isotropic"]
        if self.rotated:
            parts.append("rotated")
        if self.physical_distance:
            parts.append("pd")
        fform_str = "_".join(parts)
        if fform_str not in FFORM_TO_MODELTYPE:
            raise ValueError("Could not compute fform value from inputs")
        self.fform: FForm = fform_str  # type: ignore[assignment]
        self.model_type: ModelType = FFORM_TO_MODELTYPE[self.fform]
        self.supercategory: SuperCategory = MODEL_TYPE_TO_SUPERCATEGORY[
            self.model_type
        ]

    def _get_defaults(self) -> None:
        params = FFORM_PARAMETERS[self.fform]
        self.n_params: int = params["n_params"]
        self.default_guesses: list[float] = list(params["default_guesses"])
        self.default_bounds: list[tuple[float, float]] = list(
            params["default_bounds"]
        )

        if self.anisotropic:

            def cov_ij(X, **kw):
                return cov_ij_anisotropic(
                    self.v, 1.0, X[..., 0], X[..., 1], **kw
                )
        else:

            def cov_ij(X, **kw):
                return cov_ij_isotropic(self.v, 1.0, X, **kw)

        self.cov_ij = cov_ij

    # -- likelihood ---------------------------------------------------------
    def _model_correlation(self, X, params):
        """Kernel correlation for a parameter vector."""
        match self.n_params:
            case 1:
                return self.cov_ij(X, R=params[0])
            case 2:
                return self.cov_ij(X, Lx=params[0], Ly=params[1])
            case 3:
                return self.cov_ij(
                    X, Lx=params[0], Ly=params[1], theta=params[2]
                )
            case _:
                raise ValueError("Unexpected length of self.n_params.")

    def _sigma(self, params, like):
        if self.unit_sigma:
            return torch.ones((), dtype=like.dtype, device=like.device)
        return params[self.n_params]

    def _masked_model_z(self, params, X, weights):
        """arctanh of the clipped model correlation, zero on masked
        lanes.

        Masked displacements are replaced with a benign value BEFORE the
        kernel: masked lanes include the zero-displacement origin, where
        K_nu is +inf, and sanitising after the fact keeps the VALUE
        finite but leaks NaN through the gradient of the untaken
        ``where`` branch, which L-BFGS, the Levenberg-Marquardt Jacobian
        and the Hessian all take.
        """
        wmask = weights > 0
        wsel = wmask[..., None] if X.dim() == weights.dim() + 1 else wmask
        X = torch.where(wsel, X, torch.ones_like(X))
        y_ll = self._model_correlation(X, params)
        y_ll = torch.where(wmask, y_ll, torch.zeros_like(y_ll))
        y_ll = torch.nan_to_num(y_ll, nan=0.0)
        return torch.arctanh(_clip_fisher(y_ll)), wmask

    def _nll_fit(self, params, X, y, weights):
        """Positional-weights adapter: the batched-fit objective."""
        return self.nll(params, X, y, weights=weights)

    def _nll_fit_z(self, params, X, z_y, weights):
        """``_nll_fit`` with PRE-TRANSFORMED observations.

        ``z_y = arctanh(clip(y))`` is constant across optimiser
        iterations, so the whole-grid batched fit computes it once in the
        chunk builder instead of on every candidate evaluation. Masked
        lanes carry ``z_y = arctanh(0) = 0`` and are zero-weighted, so
        the weighted sum equals ``nll``'s exactly.
        """
        z_ll, _ = self._masked_model_z(params, X, weights)
        return _weighted_nll(z_y, z_ll, self._sigma(params, X), weights)

    def _residuals_fit_z(self, params, X, z_y, weights):
        """``_residuals_fit`` with pre-transformed observations (see
        ``_nll_fit_z``)."""
        z_ll, _ = self._masked_model_z(params, X, weights)
        return torch.sqrt(weights) * (z_y - z_ll)

    def _residuals_fit(self, params, X, y, weights):
        r"""Weighted Fisher-z residuals: sqrt(w) (z(y) - z(model(X))).

        The NLL is exactly ``sum w [z_j^2 / (2 sigma^2) + log sigma]``
        with z the arctanh (Fisher) transform: weighted least squares in
        z-space. The scale sigma profiles out monotonically
        (sigma_hat^2 = sum w r^2 / sum w), so minimising
        ``0.5 * sum(residual^2)`` recovers the SAME (Lx, Ly, theta)
        optimum as the joint NLL, for both unit_sigma settings. This is
        the objective for ``ops.optim.batched_levenberg_marquardt``.
        Masking follows ``nll``.
        """
        z_ll, wmask = self._masked_model_z(params, X, weights)
        y = torch.where(wmask, y, torch.zeros_like(y))
        return torch.sqrt(weights) * (torch.arctanh(_clip_fisher(y)) - z_ll)

    def nll(self, params, X, y, weights=None, arctanh_transform: bool = True):
        """Masked negative log-likelihood of one fit (tensors in, a 0-d
        float64 tensor out, see ``_weighted_nll``; differentiable in
        `params`).

        `weights` multiplies per-sample contributions (0/1 masks let a
        fixed-shape batch of variable-size training sets share one
        shape). Observed and model correlations are clamped to
        +-0.999999 before the Fisher transform.
        """
        sigma = self._sigma(params, X)
        if weights is not None:
            # sanitised before the kernel: see _masked_model_z
            wmask = weights > 0
            wsel = wmask[..., None] if X.dim() == weights.dim() + 1 else wmask
            X = torch.where(wsel, X, torch.ones_like(X))
        y_ll = self._model_correlation(X, params)
        if weights is not None:
            y_ll = torch.where(wmask, y_ll, torch.zeros_like(y_ll))
            y = torch.where(wmask, y, torch.zeros_like(y))
        y_ll = torch.nan_to_num(y_ll, nan=0.0)
        if arctanh_transform:
            y = torch.arctanh(_clip_fisher(y))
            y_ll = torch.arctanh(_clip_fisher(y_ll))
        return _weighted_nll(y, y_ll, sigma, weights)

    def _tensors(self, X, y, device):
        """(X, y) as floating tensors on the fit's device."""
        device = resolve_device(device, X, y)
        X = torch.as_tensor(X, device=device)
        if not X.is_floating_point():
            X = X.to(torch.get_default_dtype())
        return X, torch.as_tensor(y, dtype=X.dtype, device=device)

    def negative_log_likelihood(
        self, X, y, params, arctanh_transform: bool = True, device=None
    ) -> float:
        """Reference-signature NLL (X, y, params) -> float."""
        X, y = self._tensors(X, y, device)
        params = torch.as_tensor(params, dtype=X.dtype, device=X.device)
        return float(self.nll(params, X, y,
                              arctanh_transform=arctanh_transform))

    def negative_log_likelihood_function(self, X, y, device=None) -> Callable:
        """params -> NLL closure over fixed training data."""
        X, y = self._tensors(X, y, device)
        return lambda params: self.nll(
            torch.as_tensor(params, dtype=X.dtype, device=X.device), X, y)

    # -- fitting --------------------------------------------------------------
    def _fit_setup(self, guesses, bounds, dtype=torch.float32, device="cpu"):
        """(x0, (lo, hi), bounds) of a fit in `dtype` on `device`, the
        likelihood scale appended when it is fitted."""
        guesses = list(guesses or self.default_guesses)
        bounds = list(bounds or self.default_bounds)
        if (not self.unit_sigma) and len(guesses) != self.n_params + 1:
            guesses.append(0.1)
            bounds.append((0.0001, 0.5))

        def tensor(values):
            return torch.tensor(values, dtype=dtype, device=device)

        lo = tensor([b[0] for b in bounds])
        hi = tensor([b[1] for b in bounds])
        return tensor(guesses), (lo, hi), bounds

    def fit(
        self,
        X,
        y,
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float | None = None,
        estimate_SE: str | None = "bootstrap_parallel",
        n_sim: int = 500,
        n_jobs: int | None = None,
        backend: str | None = None,
        random_seed: int = 1234,
        generator: torch.Generator | None = None,
        counts=None,
        device=None,
    ):
        """MLE fit; returns (NMResult, SE | None, bounds).

        `opt_method`: "Nelder-Mead" (the Karspeck method, default) or
        "L-BFGS-B", gradient-based, possible because the entire
        likelihood is differentiable. `tol` sets both xatol and fatol for
        NM, or the gradient-norm tolerance for L-BFGS. `estimate_SE` in
        {"bootstrap_serial", "bootstrap_parallel"} runs `n_sim` bootstrap
        refits, both as one batched Nelder-Mead (`n_jobs` / `backend` are
        accepted for signature parity and ignored), or "hessian" for
        Fisher-information standard errors from the autodiff Hessian at
        the optimum.

        The bootstrap's resamples come from `generator` (by default a new
        one seeded with `random_seed`), or are given outright as `counts`,
        an (n_sim, n) array of how often each sample was drawn. The fit
        runs on `device`; with none, where `X` or `y` lives if one is a
        tensor, else on the card, in the dtype of `X`.
        """
        Xt, yt = self._tensors(X, y, device)
        x0, (lo, hi), bounds_out = self._fit_setup(
            guesses, bounds, Xt.dtype, Xt.device)
        tol = 1e-4 if tol is None else tol

        if opt_method == "Nelder-Mead":
            result = nelder_mead(
                lambda p: self.nll(p, Xt, yt),
                x0,
                bounds=(lo, hi),
                xatol=tol,
                fatol=tol,
            )
        elif opt_method in ("L-BFGS-B", "L-BFGS", "lbfgs"):
            result = lbfgs_minimize(
                lambda p: self.nll(p, Xt, yt),
                x0,
                bounds=(lo, hi),
                tol=tol,
            )
        else:
            raise ValueError(
                "opt_method must be 'Nelder-Mead' or 'L-BFGS-B'"
            )

        if estimate_SE is None:
            return result, None, bounds_out
        if estimate_SE == "hessian":
            return result, self._hessian_se(Xt, yt, result.x), bounds_out
        if estimate_SE not in ("bootstrap_serial", "bootstrap_parallel"):
            raise ValueError(f"Unknown estimate_SE value: {estimate_SE}")

        SE = self._bootstrap_se(
            Xt, yt, x0, (lo, hi), tol, n_sim, random_seed,
            generator=generator, counts=counts,
        )
        return result, SE, bounds_out

    def _hessian_se(self, X, y, x_opt) -> np.ndarray:
        """Fisher-information standard errors: sqrt(diag(H^{-1})).

        H is the autodiff Hessian of the negative log-likelihood at the
        optimum. Non-positive-curvature directions yield NaN.
        """
        H = torch.func.hessian(lambda p: self.nll(p, X, y))(x_opt.detach())
        diag = torch.diagonal(torch.linalg.inv_ex(H).inverse)
        nan = torch.full_like(diag, math.nan)
        return torch.sqrt(torch.where(diag > 0, diag, nan)).cpu().numpy()

    def _bootstrap_se(self, X, y, x0, bounds, tol, n_sim, seed,
                      generator=None, counts=None) -> np.ndarray:
        """Bootstrap refits as one batched Nelder-Mead over resample
        weights.

        Resampling as weighted NLL: bootstrap counts are per-sample
        weights, the same likelihood value as gathering rows, and every
        refit keeps one shape.
        """
        n = y.shape[0]
        if counts is None:
            if generator is None:
                generator = torch.Generator(device=y.device).manual_seed(seed)
            idx = torch.randint(0, n, (n_sim, n), generator=generator,
                                device=y.device)
            w = torch.zeros((n_sim, n), dtype=X.dtype, device=y.device)
            w.scatter_add_(1, idx, torch.ones_like(idx, dtype=X.dtype))
        else:
            w = torch.as_tensor(counts, dtype=X.dtype, device=y.device)
            if w.shape != (n_sim, n):
                raise ValueError(
                    f"counts must be (n_sim, n) = ({n_sim}, {n}), got "
                    f"{tuple(w.shape)}")

        def fun(p, w_i):
            return self.nll(p, X, y, weights=w_i)

        x0_b = x0[None, :].expand(n_sim, x0.shape[0])
        res = batched_nelder_mead(
            fun, x0_b, (w,), bounds, xatol=tol, fatol=tol
        )
        return np.std(res.x.cpu().numpy(), axis=0)

    def _bootstrap_once(
        self, X, y, guesses, bounds, opt_method, tol=None, seed=1234,
        device=None,
    ) -> np.ndarray:
        """Single bootstrap refit (reference-shaped helper; the resample
        is numpy's ``RandomState(seed).choice``)."""
        rng = np.random.RandomState(seed)
        n = len(y)
        idx = rng.choice(np.arange(n), size=n, replace=True)
        if isinstance(X, torch.Tensor):
            idx = torch.as_tensor(idx, device=X.device)
        Xb, yb = self._tensors(X[idx, ...], y[idx], device)
        x0, (lo, hi), _ = self._fit_setup(guesses, bounds, Xb.dtype,
                                          Xb.device)
        res = nelder_mead(
            lambda p: self.nll(p, Xb, yb),
            x0,
            bounds=(lo, hi),
            xatol=tol or 1e-4,
            fatol=tol or 1e-4,
        )
        return res.x.cpu().numpy()
