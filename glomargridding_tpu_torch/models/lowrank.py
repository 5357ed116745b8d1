r"""Kriging and stochastic ensembles on a factored (low-rank) covariance,
on tensors.

Port of ``glomargridding_tpu/models/lowrank.py``. The device-scale PSD
repair (``ops.covariance_tools.explained_variance_clip_lowrank`` /
``laloux_clip_lowrank``) returns the clipped covariance in factored form

.. math::  C = \mathrm{diag}(f) + V \, \mathrm{diag}(g) \, V^T

(``LowRankPSD``): the retained eigenspace keeps its spectrum, everything
orthogonal gets the uniform floor. This module closes the loop: ordinary
kriging, its uncertainty/constraint-mask diagnostics, and the two-stage
perturbation ensemble all evaluated straight off the factors. Nothing
n x n is ever formed, so the non-stationary 1-degree pipeline (ellipse
covariance operator -> low-rank clip -> kriging -> members) runs at
64,800 cells without a dense covariance.

Key identities (m observed of n grid points, r = retained rank):

- obs block      K   = V_o g V_o' + diag(f_o) + E            (m x m)
- cross block    C_x[i, j] = V_o[i] g V[j]' + f_j [idx_i = j] (m x n)
- any C_x' z is one (r,)-bottleneck matmul plus a scatter-add,
- diag(C_x' K^{-1} C_x) reduces to an (r x r) Gram form plus exact
  corrections at the m observed columns,

so the full solve + diagnostics cost O(m^3 + n r (r + members)) flops
and O(n (r + members)) memory.

Everything runs on the ``LowRankPSD``'s device (build one from numpy
factors with ``convert.lowrank_psd_from_arrays``, which goes to the card
by default). The ensemble's standard normals come from ``generator=`` or
are injected as ``noise=(z1, z2, zo)`` of shapes (n, members),
(r, members), (m, members): the reference's three draws, in its order.
``lowrank_months_scan`` is a Python loop over months (the reference's
``lax.scan`` existed to make one dispatch). No product here may run in
TF32: the port never changes ``torch.get_float32_matmul_precision()``
from "highest", which is what the Woodbury core's full-f32 products need.
"""

from typing import NamedTuple
from warnings import warn

import numpy as np
import torch

from ..ops.covariance_tools import LowRankPSD, _normals
from ..utils.profiling import span
from .kernel_kriging import _add_error, _loo_from_K


class LowRankKrigingResult(NamedTuple):
    """Ordinary-kriged field + diagnostics from a factored covariance."""

    field: torch.Tensor
    uncertainty: torch.Tensor
    constraint_mask: torch.Tensor


def check_idx_unique(idx, error_cov=None, pad_error: float = 1e6):
    """Warn when observation grid indices repeat with real weight.

    The factored observation system builds its floor term as
    ``diag(f_o)``, which omits the floor coupling f_j on OFF-diagonal
    entries between two observations sharing a grid cell: genuinely
    duplicated station indices would give a silently-wrong K vs the
    dense OrdinaryKriging path. Duplicates whose error-covariance
    diagonal is huge (the ``pad_month_observations`` convention places
    all dummy obs at grid index 0 with a huge pad error, suppressing
    their weights) are exempt. Host-side check on the SMALL (m,) index
    array; public low-rank entry points call it once per solve.
    """
    idx_h = _host(idx)
    if error_cov is not None:
        if isinstance(error_cov, torch.Tensor):
            ediag = _host(error_cov if error_cov.dim() == 1
                          else torch.diagonal(error_cov))
        else:
            Eh = np.asarray(error_cov)
            ediag = Eh if Eh.ndim == 1 else np.diagonal(Eh)
        idx_h = idx_h[ediag < pad_error]
    _, counts = np.unique(idx_h, return_counts=True)
    n_dup = int((counts > 1).sum())
    if n_dup:
        warn(
            f"{n_dup} grid cell(s) carry multiple observations with "
            "non-pad error: the factored observation system drops the "
            "floor coupling between duplicates and will diverge from "
            "the dense OrdinaryKriging path. Merge duplicate "
            "observations per cell (or inflate their error) first."
        )
    return n_dup == 0


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stacked_obs_solve(V_o, g, f_o, E, y, extra=None):
    """One Cholesky of K = C_obs + E and ONE solve for every right-hand
    side the caller needs. Returns (u, w, X) = K^{-1}(1, y, extra)."""
    m = V_o.shape[0]
    K = _add_error((V_o * g[None, :]) @ V_o.T + torch.diag(f_o), E)
    L = torch.linalg.cholesky(K)
    rhs = [torch.ones((m, 1), dtype=V_o.dtype, device=V_o.device),
           y[:, None]]
    if extra is not None:
        rhs.append(extra)
    sol = torch.cholesky_solve(torch.cat(rhs, dim=1), L)
    u, w = sol[:, 0], sol[:, 1]
    return u, w, (sol[:, 2:] if extra is not None else None)


def _field_from_uw(V, g, f, idx, u, w, y):
    """Ordinary-kriged field + Lagrange terms from u = K^{-1}1 and
    w = K^{-1}y. Returns (field, t, lam, uy)."""
    return _field_rows(V, g, V[idx], f[idx], idx, None, u, w, y)


def _field_rows(V, g, V_o, f_o, rows, inside, u, w, y):
    """``_field_from_uw`` on a block of grid rows (see ``_cross_t_rows``)."""
    s = torch.sum(u)
    uy = u @ y
    t = _cross_t_rows(V, g, V_o, f_o, rows, inside, u)  # K^{-1}C_x colsums
    cw = _cross_t_rows(V, g, V_o, f_o, rows, inside, w)
    lam = (t - 1.0) / s
    field = cw - lam * uy
    return field, t, lam, uy


def _cross_t_apply(V, g, f, idx, z):
    """C_cross' @ z for z of shape (m,) or (m, b); C never formed.

    C_cross[i, j] = V[idx_i] g V[j]' + f_j [idx_i == j], so
    C_cross' z = V (g (V_o' z)) + scatter_add(idx, f_o * z).
    """
    return _cross_t_rows(V, g, V[idx], f[idx], idx, None, z)


def _cross_t_rows(V, g, V_o, f_o, rows, inside, z):
    """``_cross_t_apply`` on a block of grid rows: V the block's rows,
    V_o = V[idx] and f_o = f[idx] of the whole grid, `rows` the
    observations' local rows in the block and `inside` whether each lies
    in it (None: every observation, the whole grid)."""
    if z.dim() == 1:
        out = V @ (g * (V_o.T @ z))
        fz = f_o * z
    else:
        out = V @ (g[:, None] * (V_o.T @ z))
        fz = f_o[:, None] * z
    return out.index_add_(0, rows, _inside(fz, inside))


def _inside(values, inside):
    """`values` with the rows of observations outside the block zeroed
    (None: all inside)."""
    if inside is None:
        return values
    mask = inside.reshape(-1, *([1] * (values.dim() - 1)))
    return torch.where(mask, values, torch.zeros_like(values))


def _error_forms(E, e_diag):
    """(E, e_vec): E as the solve takes it and its diagonal. E may be the
    (m,) DIAGONAL of a diagonal error covariance, the m^2-free form the
    public wrappers pass through for diagonal E."""
    if E.dim() == 1:
        if not e_diag:  # caller bypassed the wrappers: stay correct
            return torch.diag(E), E
        return E, E
    return E, torch.diagonal(E)


def _states(V, g, f, z1, z2):
    """Exact N(0, C) states of the rows of V, f: (rows, members)."""
    return torch.sqrt(f)[:, None] * z1 + V @ (torch.sqrt(g)[:, None] * z2)


def _obs_noise(E, e_vec, zo, e_diag):
    """Observation noise (m, members) with covariance E."""
    if e_diag:
        return torch.sqrt(e_vec)[:, None] * zo
    return torch.linalg.cholesky(E) @ zo


class _ObsSolve(NamedTuple):
    """The m-sized part of the solve: u = K^{-1} 1, w = K^{-1} y,
    A = K^{-1} sim_obs (None without members), and for the diagnostics
    S = K^{-1} V_o and diag(K^{-1}) (None without)."""

    u: torch.Tensor
    w: torch.Tensor
    A: torch.Tensor | None
    S: torch.Tensor | None
    kinv_diag: torch.Tensor | None


def _obs_solve(V_o, g, f_o, E, e_vec, y, sim_obs, diagnostics, e_diag):
    """Factorise K = C_obs + E and solve every right-hand side the grid
    rows need (``_ObsSolve``), from the observed rows alone.

    e_diag=True (set by the public wrappers when E is diagonal, the
    common production case) solves through the Woodbury identity; every
    right-hand side otherwise goes through ONE stacked solve
    (``_stacked_obs_solve``)."""
    dtype = V_o.dtype
    m, r = V_o.shape
    if e_diag:
        # Woodbury route: K = D + U U' with D = diag(f_o + e) and
        # U = V_o sqrt(g), so K^{-1}Z = D^{-1}Z - D^{-1}U W^{-1}U'D^{-1}Z
        # with W = I_r + U'D^{-1}U, SPD with eigenvalues >= 1 (zero-gain
        # pad_rank columns are simply zero columns of U). EVERY solve is
        # r-sized: the m^3 Cholesky disappears. Numerical discipline
        # (the reference learned it on the 1-degree workload, where the
        # field's RMSE came out above the Cholesky route's):
        # 1. the Woodbury-core products run in full f32 (here every f32
        #    product does: TF32 is never enabled);
        # 2. one step of iterative refinement with the residual taken
        #    through the exact factored K, which wipes the remaining
        #    cancellation error (the two Woodbury terms are each
        #    O(|Z| lambda_max / d) and cancel to the answer).
        d = f_o + e_vec
        U = V_o * torch.sqrt(g)[None, :]
        DiU = U / d[:, None]
        W = U.T @ DiU
        W.diagonal().add_(1.0)
        Lw = torch.linalg.cholesky(W)

        def kmat(Z):  # K @ Z off the factors (two (m, r) matmuls)
            return U @ (U.T @ Z) + d[:, None] * Z

        def ksolve_once(Z):
            Zd = Z / d[:, None]
            return Zd - DiU @ torch.cholesky_solve(U.T @ Zd, Lw)

        def ksolve(Z):
            X = ksolve_once(Z)
            return X + ksolve_once(Z - kmat(X))

        rhs = [torch.ones((m, 1), dtype=dtype, device=V_o.device),
               y[:, None]]
        if sim_obs is not None:
            rhs.append(sim_obs)
        sol = ksolve(torch.cat(rhs, dim=1))
        A = sol[:, 2:] if sim_obs is not None else None
        S = kinv_diag = None
        if diagnostics:
            S = ksolve(V_o)  # K^{-1} V_o, r-sized solves only
            # diag(K^{-1}) = 1/d - rowsum((Lw^{-1}DiU')^2): one narrow
            # forward substitution instead of an m-wide identity RHS
            R = torch.linalg.solve_triangular(Lw, DiU.T, upper=False)
            kinv_diag = 1.0 / d - torch.sum(R**2, dim=0)
        return _ObsSolve(sol[:, 0], sol[:, 1], A, S, kinv_diag)
    parts = []
    if diagnostics:
        parts.append(V_o)
        parts.append(torch.eye(m, dtype=dtype, device=V_o.device))
    if sim_obs is not None:
        parts.append(sim_obs)
    u, w, X = _stacked_obs_solve(
        V_o, g, f_o, E, y, torch.cat(parts, dim=1) if parts else None,
    )
    A = X[:, -sim_obs.shape[1]:] if sim_obs is not None else None
    S = kinv_diag = None
    if diagnostics:
        S = X[:, :r]  # K^{-1} V_o
        kinv_diag = torch.diagonal(X[:, r:r + m])
    return _ObsSolve(u, w, A, S, kinv_diag)


def _finish_rows(V, g, f, V_o, f_o, rows, inside, y, sol):
    """Field, uncertainty^2 and constraint mask of a block of grid rows
    (V, f the block's rows; `rows`, `inside` as in ``_cross_t_rows``) from
    the observation solve `sol`; zeros for the diagnostics without S."""
    field, t, lam, uy = _field_rows(V, g, V_o, f_o, rows, inside, sol.u,
                                    sol.w, y)
    if sol.S is None:
        return field, torch.zeros_like(field), torch.zeros_like(field)
    # diag(C_x' K^{-1} C_x): C_x[:, j] = V_o (g V_j) + f_j e_pos(j),
    # so the quadratic form splits into the (r x r) Gram piece
    # V_j' g (V_o'K^{-1}V_o) g V_j, a cross piece on the m observed
    # columns via S = K^{-1}V_o, and f_j^2 diag(K^{-1}).
    S = sol.S
    M = (g[:, None] * (V_o.T @ S)) * g[None, :]  # (r, r)
    M = 0.5 * (M + M.T)
    sv = torch.sum((V @ M) * V, dim=1)  # (rows,)
    P = torch.sum(S * (V_o * g[None, :]), dim=1)  # (m,)
    sv.index_add_(0, rows, _inside(2.0 * f_o * P + f_o**2 * sol.kinv_diag,
                                   inside))

    diag = f + torch.sum(V**2 * g[None, :], dim=1)
    wc = sv - lam * t
    uncert2 = diag - (wc + lam) - lam
    cmask = sv / diag
    return field, uncert2, cmask


def _members_rows(V, g, V_o, f_o, rows, inside, A, states, field):
    """member = field + grid_sim - state on a block of grid rows:
    (members, rows)."""
    grid_sim = _cross_t_rows(V, g, V_o, f_o, rows, inside, A)
    return field[None, :] + (grid_sim - states).T


def _lowrank_solve(
    V, g, f, E, idx, y, n_members: int, diagnostics: bool = True,
    e_diag: bool = False, generator=None, noise=None,
):
    """Factorise K, field, diagnostics, members: the core of every entry
    point.

    n_members = 0 skips the ensemble entirely; diagnostics=False skips
    the uncertainty/constraint diagonals (the m^2-wide part of the
    stacked solve) and returns zeros for them; e_diag=True (set by the
    public wrappers when E is diagonal, the common production case)
    draws the obs noise elementwise instead of via a second m^3
    Cholesky, and solves through the Woodbury identity.
    ``parallel.lowrank`` runs the same pieces on row blocks.
    """
    m = idx.shape[0]
    n = V.shape[0]
    r = g.shape[0]
    V_o = V[idx]
    f_o = f[idx]
    E, e_vec = _error_forms(E, e_diag)

    # draw states and simulated observations FIRST so they can join the
    # single stacked solve
    sim_obs = None
    if n_members > 0:
        with span("lowrank.states"):
            z1, z2, zo = _normals(
                noise, generator,
                [(n, n_members), (r, n_members), (m, n_members)], V)
            states = _states(V, g, f, z1, z2)  # (n, members)
            sim_obs = states[idx] + _obs_noise(E, e_vec, zo, e_diag)

    with span("lowrank.solve"):
        sol = _obs_solve(V_o, g, f_o, E, e_vec, y, sim_obs, diagnostics,
                         e_diag)
    with span("lowrank.rows"):
        field, uncert2, cmask = _finish_rows(V, g, f, V_o, f_o, idx, None,
                                             y, sol)
    if n_members == 0:
        members = torch.zeros((0, n), dtype=V.dtype, device=V.device)
        return field, uncert2, cmask, members
    with span("lowrank.members"):
        members = _members_rows(V, g, V_o, f_o, idx, None, sol.A, states,
                                field)
    return field, uncert2, cmask, members


def _is_diagonal(E) -> bool:
    """Is the error covariance ((m,), (m, m) or stacked (T, m, m))
    diagonal? One reduction on E's device."""
    if E.dim() == 1:
        return True
    on_diag = torch.count_nonzero(torch.diagonal(E, dim1=-2, dim2=-1))
    return bool(torch.count_nonzero(E) == on_diag)


def _inputs(psd, idx, obs, error_cov):
    """(idx, y, E) beside the factors, after the duplicate-index check."""
    V = psd.vectors
    y = torch.as_tensor(obs, dtype=V.dtype, device=V.device)
    E = torch.as_tensor(error_cov, dtype=V.dtype, device=V.device)
    check_idx_unique(idx, E)
    return torch.as_tensor(idx, device=V.device).long(), y, E


def _result(field, uncert2, cmask):
    return LowRankKrigingResult(
        field, torch.sqrt(torch.clamp(uncert2, min=0.0)), cmask)


def lowrank_kriging(
    psd: LowRankPSD, idx, obs, error_cov
) -> LowRankKrigingResult:
    """Ordinary kriging against a factored (clipped) covariance.

    `psd` is the ``LowRankPSD`` from a `_lowrank` clip; `idx` the grid
    indices of the m observed cells; `error_cov` the (m, m)
    observation-error covariance OR its (m,) diagonal (diagonal E takes
    the m^3-free Woodbury route either way; passing the diagonal also
    skips m^2 zeros). Field, uncertainty and constraint mask are EXACT
    for the factored covariance (cross-checked against the dense solver
    in tests); cost O(m^3 + n r^2) dense-E / O(n r^2 + m r^2)
    diagonal-E, memory O(n r). Runs on `psd`'s device.
    """
    with span("lowrank.call"):
        with span("lowrank.inputs"):
            idx, y, E = _inputs(psd, idx, obs, error_cov)
            e_diag = _is_diagonal(E)
        field, uncert2, cmask, _ = _lowrank_solve(
            psd.vectors, psd.gains, psd.floor, E, idx, y, 0, e_diag=e_diag)
        return _result(field, uncert2, cmask)


def lowrank_ensemble_step(
    psd: LowRankPSD,
    idx,
    obs,
    error_cov,
    generator: torch.Generator | None = None,
    n_members: int = 100,
    noise=None,
):
    """Two-stage perturbation ensemble on the factored covariance.

    Stage 1 draws exact N(0, C) states straight from the factors
    (O(n(r + members)), no Cholesky of C); stage 2 simple-kriges each
    state's simulated observations (+ correlated obs noise) back and
    forms ``member = field + grid_sim - state`` (same convention as
    ``models.stochastic.batched_ensemble_step``). `error_cov` may be the
    (m, m) matrix or its (m,) diagonal (see :func:`lowrank_kriging`).
    The standard normals come from `generator` on `psd`'s device, or
    are given as ``noise=(z1, z2, zo)`` (module docstring).

    Returns (result, members): a ``LowRankKrigingResult`` and the
    (n_members, n) member stack.
    """
    with span("lowrank.call"):
        with span("lowrank.inputs"):
            idx, y, E = _inputs(psd, idx, obs, error_cov)
            e_diag = _is_diagonal(E)
        field, uncert2, cmask, members = _lowrank_solve(
            psd.vectors, psd.gains, psd.floor, E, idx, y, int(n_members),
            e_diag=e_diag, generator=generator, noise=noise,
        )
        return _result(field, uncert2, cmask), members


def lowrank_months_scan(
    psd: LowRankPSD,
    idx_months,
    obs_months,
    error_cov_months,
    generator: torch.Generator | None = None,
    n_members: int = 0,
    diagnostics: bool = True,
    noise=None,
):
    """Kriging (+ optional ensembles) over months, one month at a time.

    The non-stationary analog of
    ``models.kernel_kriging.months_scan_kriging``: the factored clipped
    covariance is fixed across months while observations change;
    `idx_months` (T, m), `obs_months` (T, m), `error_cov_months`
    (T, m, m) or, for diagonal monthly error covariances, the (T, m)
    stack of their DIAGONALS, which takes the m^3-free Woodbury route.
    Pad ragged months with
    ``models.kernel_kriging.pad_month_observations``. Returns (results,
    members): a ``LowRankKrigingResult`` of (T, n) stacks and the
    (T, n_members, n) member stack (empty when n_members=0).
    ``diagnostics=False`` zeroes the uncertainty / constraint-mask
    outputs and skips their triangular work. `noise`, when given, is a
    sequence of T ``(z1, z2, zo)`` triples, one per month.
    """
    V = psd.vectors
    with span("lowrank.call"):
        with span("lowrank.inputs"):
            idx_m = torch.as_tensor(idx_months, device=V.device).long()
            obs_m = torch.as_tensor(obs_months, dtype=V.dtype,
                                    device=V.device)
            err_m = torch.as_tensor(error_cov_months, dtype=V.dtype,
                                    device=V.device)
            # (T, m): stacked DIAGONALS by contract; (T, m, m): stacked
            # matrices, diagonality checked on the device
            e_diag = err_m.dim() == 2 or _is_diagonal(err_m)
        out = [
            _lowrank_solve(
                V, psd.gains, psd.floor, err_m[t], idx_m[t], obs_m[t],
                int(n_members), bool(diagnostics), e_diag, generator,
                None if noise is None else noise[t],
            )
            for t in range(idx_m.shape[0])
        ]
        field, uncert2, cmask, members = (
            torch.stack([o[i] for o in out]) for i in range(4))
        return _result(field, uncert2, cmask), members


def lowrank_members_from_states(
    psd: LowRankPSD, idx, obs, error_cov, states, eps
):
    """Deterministic member update for PRE-DRAWN states and obs noise.

    `states` (n_members, n), `eps` (n_members, m): the test seam. Feed
    fixed draws and the output must equal the dense two-stage update
    ``field + W'(state[idx] + eps) - state`` with W the simple-kriging
    weights of the densified covariance.
    """
    V, g, f = psd.vectors, psd.gains, psd.floor

    def like(x):
        return torch.as_tensor(x, dtype=V.dtype, device=V.device)

    idx = torch.as_tensor(idx, device=V.device).long()
    y, states, eps = like(obs), like(states), like(eps)
    # one factorisation and ONE stacked solve shared by the field solve
    # and the member update (diagnostics are not needed here)
    sim_obs = states[:, idx] + eps
    u, w, A = _stacked_obs_solve(
        V[idx], g, f[idx], like(error_cov), y, sim_obs.T)
    field, _, _, _ = _field_from_uw(V, g, f, idx, u, w, y)
    grid_sim = _cross_t_apply(V, g, f, idx, A)  # (n, members)
    return field[None, :] + (grid_sim - states.T).T


def lowrank_crossval(
    psd, idx, obs, error_cov, mean: float = 0.0,
    method: str = "ordinary",
):
    """Leave-one-out cross-validation against a factored covariance.

    The counterpart of :func:`models.kernel_kriging.kriging_crossval`
    for the CLIPPED non-stationary pipeline: scores the repaired
    ``LowRankPSD`` on the month's observations via the Dubrule LOO
    identity: one m-sized observation system (built densely from the
    factors; 100 MB in f32 at m = 5000) instead of m refits, with the
    Lagrange-bordered form for ``method="ordinary"``. Use it to choose
    between candidate parameter fields / clip targets before paying the
    grid solve. Returns a
    :class:`models.kernel_kriging.CrossValResult`.
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    idx, y, E = _inputs(psd, idx, obs, error_cov)
    V_o = psd.vectors[idx]
    g = psd.gains.to(V_o.dtype)
    K = (V_o * g[None, :]) @ V_o.T + torch.diag(psd.floor[idx])
    return _loo_from_K(_add_error(K, E), y, float(mean), method)
