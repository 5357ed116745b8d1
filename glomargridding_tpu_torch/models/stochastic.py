r"""Two-stage stochastic kriging (Morice et al. 2021 ensemble method), on
tensors.

Port of ``glomargridding_tpu/models/stochastic.py``: ordinary-kriged
field plus a simulated perturbation epsilon = (simple-kriged simulated
obs) - simulated state, and multivariate-normal state draws with an
eigen-repair fallback.

- One factorisation of :math:`K = C_{obs} + E` yields BOTH the simple
  weights and the bordered ordinary solve.
- State draws are :math:`\mu + L z` with a single Cholesky factor of C,
  batched over ensemble members: drawing 200 states costs barely more
  than one. That is explicit API: factor once via ``draw_factor``, then
  ``draws_from_factor``.

What differs from the reference, and why:

- ``jax.random`` keys become ``generator=`` (a ``torch.Generator`` on the
  call's device) or injected standard normals ``noise=``, in the
  reference's shapes; each function says which.
- ``draw_factor`` returns ``(L, info)``, ``torch.linalg.cholesky_ex``'s
  status on the device (0 = positive definite), in place of the
  reference's NaN probe of the factor; its host-LAPACK route for f64 is
  left out (the card has native f64).
- the reference's ``_stochastic_fused*`` programs are one dispatch of the
  same steps; here the steps are written once, in ``solve``.

Numpy inputs go to `device`, by default the card
(``utils.device.resolve_device``); tensors keep their device; outputs are
tensors there.
"""

import logging

import numpy as np
import torch

from ..ops.covariance_tools import _eigh, _normals
from ..ops.sphere import SphericalHarmonicSampler
from ..utils.device import resolve_device
from .kriging import (
    Kriging,
    _column_dot,
    _extended_inverse,
    _finalise_uncert,
    _ordinary_core,
)


# ===========================================================================
# Multivariate-normal draws
# ===========================================================================
def draw_factor(cov):
    """(L, info): the lower Cholesky factor of a covariance tensor and
    ``cholesky_ex``'s status, a device integer that is 0 exactly when the
    matrix is positive definite (L is not usable otherwise)."""
    return torch.linalg.cholesky_ex(cov)


def draws_from_factor(L, loc, ndraws: int = 1, *, generator=None, noise=None):
    """ndraws x N samples of N(loc, L L'), batched over members.

    This is the ensemble primitive: factor once, draw many. The standard
    normals come from `generator`, or are given as `noise` of shape
    (ndraws, N).
    """
    (z,) = _normals(None if noise is None else (noise,), generator,
                    [(ndraws, L.shape[0])], L)
    return loc[None, :] + z @ L.T


def eigen_repaired_factor(
    cov,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
    strict: bool = False,
):
    """Symmetric factor of a nearly-PSD covariance via eigen repair.

    eigh, check |most negative| / largest against eigen_rtol (warn, or
    raise when `strict`), floor eigenvalues at eigen_fudge, return
    V sqrt(W) so that F F' equals the repaired covariance. Non-strict by
    default because the primary draw path tolerates indefinite inputs
    without raising.
    """
    w, v = _eigh(cov)
    w_min = float(w[0])
    w_max = float(w[-1])
    if w_min < 0:
        rtol_check = abs(w_min) / w_max
        logging.warning(
            "Negative eigenvalues detected: largest = "
            f"{w_max}; smallest = {w_min}; ratio = {rtol_check}"
        )
        if strict and rtol_check >= eigen_rtol:
            raise ValueError("Negative eigenvalues are unexpectedly large.")
    w = torch.as_tensor(np.where(w < eigen_fudge, eigen_fudge, w),
                        dtype=v.dtype, device=v.device)
    return v * torch.sqrt(w)[None, :]


def _factors(*covs, **repair):
    """A factor F with F F' ~ cov for each covariance: Cholesky where it
    succeeds, the eigen-repaired symmetric factor where it does not. ONE
    host sync resolves every status; the rescue (a full eigh) runs only
    for a matrix that actually failed."""
    tried = [draw_factor(c) for c in covs]
    bad = torch.stack([info != 0 for _, info in tried]).cpu()
    return [eigen_repaired_factor(c, **repair) if b else L
            for c, (L, _), b in zip(covs, tried, bad.tolist())]


def mv_normal_draw(
    loc,
    cov,
    ndraws: int = 1,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
    strict: bool = False,
    *,
    generator=None,
    noise=None,
    device=None,
):
    """Draw from N(loc, cov) with automatic eigen-repair fallback.

    Tries a Cholesky factor first; if the matrix is not positive-definite
    falls back to the eigen-repaired symmetric factor. The standard
    normals come from `generator`, or are given as `noise` of shape
    (ndraws, N). Returns shape (N,) for ndraws == 1 else (ndraws, N).
    """
    cov = torch.as_tensor(cov, device=resolve_device(device, cov, loc))
    if cov.dim() != 2:
        raise ValueError("cov should be 2D.")
    if cov.shape[0] != cov.shape[1]:
        raise ValueError("cov is not a square matrix")
    loc = torch.as_tensor(loc, dtype=cov.dtype, device=cov.device)
    (L,) = _factors(cov, eigen_rtol=eigen_rtol, eigen_fudge=eigen_fudge,
                    strict=strict)
    out = draws_from_factor(L, loc, ndraws, generator=generator, noise=noise)
    return out[0] if ndraws == 1 else out


def _member_finish(field, W, state, sim_obs):
    """simulated grid, epsilon, and perturbed member from the draws."""
    sim_grid = W @ sim_obs
    eps = sim_grid - state
    return field + eps, sim_grid, eps


_GLOBAL_SEED = np.random.SeedSequence(20260816)


def _next_generator(device):
    """A generator on `device` seeded from the module's seed sequence."""
    seed = int(_GLOBAL_SEED.spawn(1)[0].generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def scipy_mv_normal_draw(
    loc,
    cov,
    ndraws: int = 1,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
    device=None,
):
    """Generator-less MVN draw (API parity with the global-RNG form).

    Prefer ``mv_normal_draw`` with an explicit generator; this wrapper
    seeds a fresh one from a module-global seed sequence for drop-in
    workflows.
    """
    device = resolve_device(device, cov, loc)
    return mv_normal_draw(loc, cov, ndraws, eigen_rtol, eigen_fudge,
                          generator=_next_generator(device), device=device)


# ===========================================================================
# StochasticKriging
# ===========================================================================
class StochasticKriging(Kriging):
    """Ordinary-kriged field plus simulated perturbation (ensemble member).

    After ``solve`` the attributes `gridded_field` (unperturbed),
    `simulated_grid`, `simulated_obs`, and `epsilon` are populated.
    `error_cov` is required.
    """

    method = "stochastic"

    def __init__(
        self,
        covariance,
        idx,
        obs,
        error_cov,
        *,
        uncertainty: str = "reference",
        device=None,
    ) -> None:
        if error_cov is None:
            raise ValueError(
                "Error Covariance must be provided for StochasticKriging"
            )
        if uncertainty not in ("reference", "textbook"):
            raise ValueError(
                f"Unknown 'uncertainty' convention: {uncertainty!r}"
            )
        # "reference" keeps the published double lambda subtraction;
        # "textbook" subtracts the Lagrange multiplier once (see
        # OrdinaryKriging).
        self.uncertainty_convention = uncertainty
        super().__init__(covariance, idx, obs, error_cov, device)

    def set_simple_kriging_weights(self, simple_kriging_weights) -> None:
        """Inject pre-computed simple kriging weights (second stage)."""
        self.simple_kriging_weights = torch.as_tensor(
            simple_kriging_weights, device=self.covariance.device
        )

    def get_kriging_weights(self) -> None:
        """One factorisation -> simple AND extended ordinary weights."""
        K, C_cross, C_diag = self._blocks()
        field, uncert2, cmask, V, u, lam = _ordinary_core(
            K, C_cross, C_diag, self._obs(K.dtype)
        )
        self.simple_kriging_weights = V.T
        W = V.T - lam[:, None] * u[None, :]
        self.kriging_weights = torch.cat([W, lam[:, None]], dim=1)
        self._field = field
        self._uncert2 = uncert2
        self._lam = lam
        self._cmask = cmask

    def _extended_cross(self):
        _, C_cross, _ = self._blocks()
        ones = torch.ones((1, C_cross.shape[1]), dtype=C_cross.dtype,
                          device=C_cross.device)
        return torch.cat([C_cross, ones], dim=0)

    def kriging_weights_from_inverse(self, inv) -> None:
        """Simple + extended weights from a pre-computed (C_obs+E)^{-1}."""
        if len(self.idx) != inv.shape[0]:
            raise ValueError(
                "inv must be square with side length == len(self.idx)"
            )
        _, C_cross, _ = self._blocks()
        inv = torch.as_tensor(inv, dtype=C_cross.dtype,
                              device=C_cross.device)
        self.simple_kriging_weights = (inv @ C_cross).T
        self.kriging_weights = (
            _extended_inverse(inv) @ self._extended_cross()).T

    def get_uncertainty(self):
        """Ordinary-kriging uncertainty of the first stage.

        Convention selected at construction: "reference" (double lambda
        subtraction, parity) or "textbook" (single subtraction).
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
        uncert2 = C_diag - _column_dot(self._extended_cross().to(Wext.dtype),
                                       Wext.T)
        if not textbook:
            uncert2 = uncert2 - Wext[:, -1]
        return _finalise_uncert(uncert2)

    def constraint_mask(self):
        """Constraint mask from the simple kriging weights."""
        if not hasattr(self, "simple_kriging_weights"):
            raise KeyError("Please set kriging weights")
        _, C_cross, C_diag = self._blocks()
        return _column_dot(C_cross, self.simple_kriging_weights.T) / C_diag

    def solve(self, simulated_state=None, generator=None, noise=None):
        """Perturbed ensemble member: ordinary field + epsilon.

        `simulated_state` may be pre-computed (recommended: factor C once
        and batch-draw states with ``draw_factor``/``draws_from_factor``).
        The standard normals come from `generator` (one seeded from the
        module's seed sequence when omitted), or are given as
        ``noise=(z_state, z_obs)`` of shapes (N,) and (n_obs,); with a
        `simulated_state`, ``z_state`` is not read and may be None.

        C (unless the state is given) and E are factored by Cholesky; a
        factor that fails is replaced by the eigen-repaired one, after a
        single sync on both statuses.
        """
        if not hasattr(self, "kriging_weights"):
            self.get_kriging_weights()
        if self.error_cov is None:
            raise ValueError(
                "Error Covariance must be set to draw simulated observations"
            )
        if hasattr(self, "_field"):
            field = self._field
        else:
            W = self.kriging_weights
            zero = torch.zeros(1, dtype=W.dtype, device=W.device)
            field = W @ torch.cat([self._obs(W.dtype), zero])
        self.gridded_field = field

        W = self.simple_kriging_weights
        E = self.error_cov.to(W.dtype)
        n, m = self.covariance.shape[0], E.shape[0]
        if noise is None and generator is None:
            generator = _next_generator(W.device)
        if simulated_state is None:
            z_state, z_obs = _normals(noise, generator, [(n,), (m,)], W)
            Lc, Le = _factors(self.covariance.to(W.dtype), E)
            state = Lc @ z_state
        else:
            (z_obs,) = _normals(None if noise is None else noise[1:],
                                generator, [(m,)], W)
            (Le,) = _factors(E)
            state = torch.as_tensor(simulated_state, dtype=W.dtype,
                                    device=W.device)
        self.simulated_obs = state[self.idx] + Le @ z_obs
        member, self.simulated_grid, self.epsilon = _member_finish(
            field, W, state, self.simulated_obs
        )
        return member


def precompute_states(
    n_states: int,
    covariance=None,
    corr_fn=None,
    variance: float | None = None,
    lats_deg=None,
    lons_deg=None,
    nugget: float = 0.0,
    *,
    generator=None,
    noise=None,
    device=None,
):
    """Pre-compute a batch of simulated states for StochasticKriging.

    One draw costs as much as two hundred, so states are worth
    precomputing. Two routes:

    - dense: pass `covariance`: one Cholesky factor (eigen-repaired if it
      fails), batched L z draws from `generator` or from `noise` of
      shape (n_states, M);
    - spectral: pass `corr_fn` (isotropic correlation of the central
      angle), `variance` and the regular `lats_deg`/`lons_deg` grid:
      exact stationary draws by spherical-harmonic synthesis in f32
      (``ops.sphere.SphericalHarmonicSampler`` with its defaults), from
      `generator` or from `noise` as ``SphericalHarmonicSampler.draw``
      takes it.

    Returns (n_states, M); feed rows to ``StochasticKriging.solve`` via
    `simulated_state=`.
    """
    if covariance is not None:
        cov = torch.as_tensor(covariance,
                              device=resolve_device(device, covariance))
        (L,) = _factors(cov)
        loc = torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device)
        return draws_from_factor(L, loc, n_states, generator=generator,
                                 noise=noise)
    if corr_fn is None or variance is None:
        raise ValueError(
            "provide either covariance or (corr_fn, variance, grid axes)"
        )
    sampler = SphericalHarmonicSampler(corr_fn, variance, lats_deg,
                                       lons_deg, nugget=nugget,
                                       device=resolve_device(device))
    return sampler.draw(n_states, generator=generator, noise=noise)


def batched_ensemble_step(
    covariance, error_cov, idx, obs, n_members, *, generator=None,
    noise=None, device=None,
):
    """Fully-batched ensemble generation: one factor, batched members.

    Returns (members, gridded_field): members is (n_members, M). This is
    the dense path for 100-member ensembles: the per-member work is two
    matvecs, all batched. The standard normals come from `generator`, or
    are given as ``noise=(z_state, z_obs)`` of shapes (n_members, M) and
    (n_members, n_obs).

    Merely near-PSD inputs (the normal case for clipped/estimated
    covariances) are rescued: a failed Cholesky factor of either C or E
    falls back to the eigen-repaired symmetric factor instead of
    silently emitting all-NaN members (same rescue as
    ``StochasticKriging.solve``).
    """
    cov = torch.as_tensor(covariance, device=resolve_device(
        device, covariance, error_cov, idx, obs))
    idx = torch.as_tensor(idx, device=cov.device).long()
    E = torch.as_tensor(error_cov, dtype=cov.dtype, device=cov.device)
    y = torch.as_tensor(obs, dtype=cov.dtype, device=cov.device)

    C_cross = cov[idx, :]
    field, _, _, V, _, _ = _ordinary_core(
        C_cross[:, idx] + E, C_cross, torch.diagonal(cov), y)

    L, LE = _factors(cov, E)
    z_state, z_obs = _normals(
        noise, generator,
        [(n_members, cov.shape[0]), (n_members, E.shape[0])], cov)
    states = z_state @ L.T
    del L
    obs_sim = states[:, idx] + z_obs @ LE.T
    members = field[None, :] + (obs_sim @ V - states)
    return members, field
