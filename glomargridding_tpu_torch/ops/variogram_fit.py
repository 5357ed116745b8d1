r"""Maximum-likelihood variogram parameter estimation, on tensors.

Port of ``glomargridding_tpu/ops/variogram_fit.py``. The marginal Gaussian
likelihood of the observations,

.. math::
    -\log p(y) = \tfrac12\, y^\top K_\theta^{-1} y
               + \tfrac12 \log\det K_\theta + \tfrac{n}{2}\log 2\pi,
    \qquad K_\theta = \mathrm{cov}_\theta(D) + \sigma_n^2 I,

is a differentiable function of (psill, range, nugget): autograd runs
through the Cholesky and through ``xv_kv`` (the closed form for
half-integer Matern orders, Temme/Steed otherwise). The parameters are
fitted in log-space by the bounded L-BFGS or the Nelder-Mead of
``ops.optim``.

The port's L-BFGS is its own (per-lane Armijo backtracking, not the
reference's zoom line search): the two agree at the optimum, not step by
step. Nelder-Mead follows the reference step for step.

A Cholesky that fails gives NaN, as the reference's does, so that an
optimiser treats the point as worse than any other instead of stopping.

The likelihood is a float64 value whatever the data's dtype: the
quadratic form and log det are summed in float64 (the Cholesky and the
solve stay in the data's dtype). Summed in float32, as the reference
does, a likelihood of a few thousand keeps ~3e-4 of resolution, below
which every vertex of a simplex ties, and the simplex shrinks to a point
short of the optimum (``chip_smoke.py`` phase 23); the same limit as the
ellipse likelihood's (``models/ellipse/model._weighted_nll``).
"""

import math
from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from .optim import lbfgs_minimize, nelder_mead
from .variogram import _vario_kernel

_OPTIMIZERS = ("L-BFGS-B", "L-BFGS", "lbfgs", "Nelder-Mead")


class VariogramFit(NamedTuple):
    """Fitted variogram parameters and fit diagnostics."""

    psill: float
    range: float
    nugget: float
    nll: float
    nit: int
    success: bool


def _nll(params, dists, y, kind, nu, method):
    psill, range_, nugget = params[0], params[1], params[2]
    # covariance: variance - variogram with the sill as the variance; the
    # nugget goes on the diagonal as independent noise
    cov = _vario_kernel(dists, psill, torch.zeros_like(nugget), range_, psill,
                        kind=kind, nu=nu, method=method, fused=True)
    n = y.shape[0]
    K = cov + (nugget + 1e-6 * psill) * torch.eye(n, dtype=cov.dtype,
                                                  device=cov.device)
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info == 0, L, math.nan)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    quad = y.double() @ alpha.double()
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L).double()))
    return 0.5 * quad + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)


def gp_negative_log_likelihood(params, dists, y, kind: str, nu=None,
                               method=None, device=None):
    """Marginal Gaussian NLL of observations under a variogram model.

    `params` = (psill, range, nugget); `dists` the pairwise distance
    matrix of the observation positions; `y` the (mean-removed)
    observations. A float64 0-d tensor, differentiable in `params`. Runs on
    `device`; with none, where a tensor input lives, else on the card.
    """
    device = resolve_device(device, params, dists, y)
    dists = torch.as_tensor(dists, device=device)
    params = torch.as_tensor(params, dtype=dists.dtype, device=device)
    y = torch.as_tensor(y, dtype=dists.dtype, device=device)
    return _nll(params, dists, y, kind, nu, method)


def fit_variogram_mle(
    dists,
    y,
    kind: str = "matern",
    nu: float = 1.5,
    method: str = "sklearn",
    guesses=(1.0, 1000.0, 0.01),
    bounds=((1e-3, 1e3), (1.0, 5e4), (1e-6, 1e2)),
    optimizer: str = "L-BFGS-B",
    tol: float = 1e-6,
    device=None,
) -> VariogramFit:
    """Fit (psill, range, nugget) by maximising the marginal likelihood.

    `dists` is the pairwise distance matrix between observed positions
    (e.g. from ``ops.distances.haversine_matrix``), `y` the mean-removed
    observations; the fit runs in `dists`' dtype. Parameters are
    optimised in log-space (positive scales spanning decades).
    `optimizer` is "L-BFGS-B" (also "L-BFGS", "lbfgs") or "Nelder-Mead".
    Runs on `device`; with none, where a tensor input lives, else on the
    card.
    """
    if optimizer not in _OPTIMIZERS:
        raise ValueError("optimizer must be 'L-BFGS-B' or 'Nelder-Mead'")
    device = resolve_device(device, dists, y)
    dists = torch.as_tensor(dists, device=device)
    y = torch.as_tensor(y, dtype=dists.dtype, device=device)

    def logs(values):
        return torch.log(torch.as_tensor(values, dtype=dists.dtype,
                                         device=device))

    lo = logs([b[0] for b in bounds])
    hi = logs([b[1] for b in bounds])
    x0 = logs(guesses)

    def fun(log_params):
        return _nll(torch.exp(log_params), dists, y, kind, nu, method)

    if optimizer == "Nelder-Mead":
        res = nelder_mead(fun, x0, bounds=(lo, hi), xatol=tol, fatol=tol)
    else:
        res = lbfgs_minimize(fun, x0, bounds=(lo, hi), tol=tol)
    psill, range_, nugget = torch.exp(res.x).tolist()
    return VariogramFit(psill=psill, range=range_, nugget=nugget,
                        nll=float(res.fun), nit=int(res.nit),
                        success=bool(res.success))
