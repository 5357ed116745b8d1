r"""Batched bounded optimisers on tensors: Nelder-Mead, L-BFGS and
Levenberg-Marquardt over independent problems.

Port of ``glomargridding_tpu/ops/optim.py``. One ellipse is fitted per
grid point; here every grid point of a chunk is one *lane* of a batch, and
the simplex (or the damped Gauss-Newton step) of all lanes marches in
lock-step as plain batched tensor operations. The per-lane objective
``fun(x, *args_i)`` is written for ONE problem and lifted over the lane
axis with ``torch.func.vmap``.

Nelder-Mead follows scipy's implementation: the same initial simplex
(1.05x nonzero / 0.00025 for zero entries), the same reflect / expand /
contract / shrink coefficients (1, 2, 0.5, 0.5), the same termination
test (max |f_i - f_0| <= fatol AND max |x_i - x_0| <= xatol), the same
default ``maxiter = 200 * d``, and bounds handled by clipping candidate
points into the box.

Where the reference's loops end on a device scalar (``lax.while_loop``,
``lax.cond``), a Python loop reads one small tensor from the device per
iteration; nothing inside an objective is read on the host.
"""

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .cuda import simplex as card_simplex


class NMResult(NamedTuple):
    """Result of a minimisation (one problem, or a batch along dim 0)."""

    x: torch.Tensor  # (d,) best point
    fun: torch.Tensor  # scalar best value
    nit: torch.Tensor  # iterations executed
    success: torch.Tensor  # bool: converged within maxiter


_NONZDELT = 0.05
_ZDELT = 0.00025


def _box(bounds, d, like):
    """(lo, hi) as (d,) tensors in `like`'s dtype, on its device."""
    if bounds is None:
        return (torch.full((d,), -torch.inf, dtype=like.dtype,
                           device=like.device),
                torch.full((d,), torch.inf, dtype=like.dtype,
                           device=like.device))
    return tuple(torch.as_tensor(b, dtype=like.dtype, device=like.device)
                 for b in bounds)


def _float_tensor(x, device):
    x = torch.as_tensor(x, device=device)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _initial_simplex(x0, lo, hi):
    """scipy-style initial simplex, clipped into bounds: (d + 1, d)."""
    step = torch.where(x0 == 0.0, _ZDELT, _NONZDELT * x0)
    pts = x0[None, :] + torch.diag(step)
    return torch.clamp(torch.cat([x0[None, :], pts], dim=0), min=lo, max=hi)


def _spreads(simplex, fvals):
    """(f_spread, x_spread) of simplexes (..., d + 1, d) about their best
    vertex."""
    order = torch.argsort(fvals, dim=-1, stable=True)
    fs = torch.take_along_dim(fvals, order, dim=-1)
    xs = torch.take_along_dim(simplex, order[..., None], dim=-2)
    f_spread = torch.amax(torch.abs(fs[..., 1:] - fs[..., :1]), dim=-1)
    x_spread = torch.amax(torch.abs(xs[..., 1:, :] - xs[..., :1, :]),
                          dim=(-2, -1))
    return f_spread, x_spread


def _decide(fr, fe, foc, fic, fb, fsw, fw):
    """scipy's decision tree in arithmetic form: (take_expand,
    take_reflect, take_oc, shrink); inside contraction is what is left."""
    take_expand = (fr < fb) & (fe < fr)
    take_reflect = ((fr < fb) & ~(fe < fr)) | ((fr >= fb) & (fr < fsw))
    outside = (fr >= fsw) & (fr < fw)
    take_oc = outside & (foc <= fr)
    inside = fr >= fw
    shrink = (outside & ~(foc <= fr)) | (inside & ~(fic < fw))
    return take_expand, take_reflect, take_oc, shrink


def nelder_mead(
    fun: Callable,
    x0,
    bounds: tuple | None = None,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    maxiter: int | None = None,
    device=None,
) -> NMResult:
    """Minimise `fun(x)` (a 0-d tensor) from `x0` with bounded
    Nelder-Mead: the one-lane form, the oracle of
    :func:`batched_nelder_mead`.

    `bounds` is a (lower, upper) pair of length-d arrays (or None for
    unbounded). The loop's condition is read on the host every iteration,
    so a batch of problems belongs in ``batched_nelder_mead``. Runs on
    `device`; with none, where `x0` lives if it is a tensor, else on the
    card.
    """
    device = resolve_device(device, x0)
    x0 = _float_tensor(x0, device)
    d = x0.shape[0]
    if maxiter is None:
        maxiter = 200 * d
    lo, hi = _box(bounds, d, x0)

    def evaluate(points):
        return torch.stack([fun(p) for p in points])

    with torch.no_grad():
        simplex = _initial_simplex(x0, lo, hi)
        fvals = evaluate(simplex)
        nit = 0
        while nit < maxiter:
            f_spread, x_spread = _spreads(simplex, fvals)
            if bool((f_spread <= fatol) & (x_spread <= xatol)):
                break
            order = torch.argsort(fvals, stable=True)
            simplex, fvals = simplex[order], fvals[order]
            centroid = torch.mean(simplex[:-1], dim=0)
            direction = centroid - simplex[-1]
            cands = torch.clamp(torch.stack([
                centroid + direction,
                centroid + 2.0 * direction,
                centroid + 0.5 * direction,
                centroid - 0.5 * direction,
            ]), min=lo, max=hi)
            fc = evaluate(cands)
            take_expand, take_reflect, take_oc, shrink = _decide(
                *fc, fvals[0], fvals[-2], fvals[-1])
            if bool(shrink):
                simplex = torch.clamp(
                    simplex[:1] + 0.5 * (simplex - simplex[:1]), min=lo,
                    max=hi)
                fvals = evaluate(simplex)
            else:
                pick = 1 if bool(take_expand) else 0 if bool(
                    take_reflect) else 2 if bool(take_oc) else 3
                simplex = torch.cat([simplex[:-1], cands[pick][None]])
                fvals = torch.cat([fvals[:-1], fc[pick][None]])
            nit += 1
        best = torch.argmin(fvals)
        f_spread, x_spread = _spreads(simplex, fvals)
        success = (f_spread <= fatol) & (x_spread <= xatol)
    return NMResult(simplex[best], fvals[best],
                    torch.tensor(nit, dtype=torch.int32, device=device),
                    success)


def stacked_objective(fun, n_args: int):
    """``fun(x, *args_i)`` lifted to a stacked call: ``(points, *args,
    mask) -> (K, B)`` for (K, B, d) points and `n_args` per-lane
    arguments, by ``torch.func.vmap`` over the lanes and then the points.
    Every lane is evaluated; `mask` is not read."""
    vfk = vmap(vmap(fun), in_dims=(0,) + (None,) * n_args)

    def evaluate(points, *args_and_mask):
        return vfk(points, *args_and_mask[:-1])

    return evaluate


def batched_nelder_mead(
    fun,
    x0,
    args,
    bounds,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    maxiter: int | None = None,
    device=None,
    stacked_fun=None,
) -> NMResult:
    """Natively batched Nelder-Mead over independent problems.

    `fun(x, *args_i)` is minimised per batch element (lane); `x0` is
    (B, d) and each element of `args` has leading batch dimension B.
    `bounds` is a (lo, hi) pair of (d,) arrays shared across the batch.

    The same algorithm as ``nelder_mead`` (scipy decision tree,
    clip-to-box bounds, per-lane termination), with the batch axis
    explicit, which buys two things:

    - the four candidate evaluations (reflect / expand / contractions)
      run as ONE stacked call on (4, B, d), so whatever in the objective
      depends only on `args` (the training data, the dominant memory
      traffic when `args` holds a (B, N, ...) design) is computed once
      per iteration instead of four times;
    - the shrink-simplex evaluation (d + 1 more full passes) only runs on
      iterations where some ACTIVE lane actually shrinks.

    A lane that has converged, or has spent `maxiter`, is frozen: it
    keeps its state, and `nit` counts only its active iterations.

    The host reads one two-element tensor per iteration, (the active
    lanes, the active lanes that shrink), after the candidates are
    evaluated: the iteration that finds no lane active changes nothing
    and ends the loop.

    Each objective call is one stacked call, ``stacked_fun(points, *args,
    mask) -> (K, B)`` on (K, B, d) points, whose values the loop reads
    only on the lanes of the (B,) bool `mask`: every lane for the initial
    simplex, the active lanes for each iteration's candidates, the active
    lanes that shrink for a shrink pass. So a stacked objective may skip
    the other lanes and return anything there. Give the objective once:
    `fun` (lifted by ``stacked_objective(fun, len(args))``, which
    evaluates every lane) or, with `fun` None, `stacked_fun`.

    Where ``ops.cuda.simplex.takes`` the solve (a CUDA device, d + 1 <= 5
    and K5 as the stacked objective), its trips after the initial
    simplex run there: a captured CUDA graph of trips, replayed with one
    host read a replay, to the same bits as the host's loop
    (``_eager_trips``), its twin.

    Spans (``utils/profiling``): ``nm.evaluate`` around each objective
    call (the initial simplex, each iteration's candidates, each shrink
    pass), ``nm.read`` around the host read. Counters, host integers the
    loop holds: ``nm.iterations`` its trips (the last finds no lane
    active), ``nm.points`` the K of each (K, B, d) call, so (d + 1)(1 +
    shrinks) + 4 trips, ``nm.shrinks`` the shrink passes,
    ``nm.lanes_offered`` B a call and ``nm.lanes_evaluated`` the lanes of
    its mask (their ratio is the share of lane evaluations a stacked
    objective that skips may save). The card's path keeps their meaning
    and adds its own (``ops.cuda.simplex``).

    Runs on `device`; with none, where `x0` or an argument lives if one
    is a tensor, else on the card.
    """
    device = resolve_device(device, x0, *args)
    x0 = _float_tensor(x0, device)
    args = tuple(torch.as_tensor(a, device=device) for a in args)
    B, d = x0.shape
    if maxiter is None:
        maxiter = 200 * d
    lo, hi = _box(bounds, d, x0)

    if (fun is None) == (stacked_fun is None):
        raise ValueError("give the objective once: fun or stacked_fun")
    if stacked_fun is None:
        stacked_fun = stacked_objective(fun, len(args))

    def evaluate(points, mask):  # (K, B, d) -> (K, B)
        count("nm.points", points.shape[0])
        count("nm.lanes_offered", B)
        with span("nm.evaluate"):
            return stacked_fun(points, *args, mask)

    def evaluate_simplexes(simplexes, mask):  # (B, K, d) -> (B, K)
        return evaluate(simplexes.transpose(0, 1).contiguous(), mask).T

    with torch.no_grad():
        step = torch.where(x0 == 0.0, _ZDELT, _NONZDELT * x0)  # (B, d)
        pts = x0[:, None, :] + torch.eye(
            d, dtype=x0.dtype, device=device)[None] * step[:, None, :]
        simplex = torch.clamp(torch.cat([x0[:, None, :], pts], dim=1),
                              min=lo, max=hi)  # (B, d + 1, d)
        fvals = evaluate_simplexes(
            simplex, torch.ones((B,), dtype=torch.bool, device=device))
        count("nm.lanes_evaluated", B)
        if card_simplex.takes(device, d, stacked_fun):
            simplex, fvals, nit = card_simplex.trips(
                simplex, fvals, args, lo, hi, xatol=xatol, fatol=fatol,
                maxiter=maxiter, stacked_fun=stacked_fun)
        else:
            simplex, fvals, nit = _eager_trips(
                simplex, fvals, evaluate, evaluate_simplexes, lo, hi,
                xatol=xatol, fatol=fatol, maxiter=maxiter)
        best = torch.argmin(fvals, dim=1)
        x_best = torch.take_along_dim(simplex, best[:, None, None],
                                      dim=1)[:, 0]
        f_best = torch.take_along_dim(fvals, best[:, None], dim=1)[:, 0]
        success = _converged(simplex, fvals, xatol, fatol)
    return NMResult(x_best, f_best, nit, success)


def _converged(simplex, fvals, xatol, fatol):
    f_spread, x_spread = _spreads(simplex, fvals)
    return (f_spread <= fatol) & (x_spread <= xatol)


def _eager_trips(simplex, fvals, evaluate, evaluate_simplexes, lo, hi, *,
                 xatol, fatol, maxiter):
    """``batched_nelder_mead``'s trips from its initial simplex, each
    decided on the host: (simplex, values, nit) once no lane is active.
    `evaluate` and `evaluate_simplexes` are its objective calls."""
    B = simplex.shape[0]
    nit = torch.zeros((B,), dtype=torch.int32, device=simplex.device)
    while True:
        count("nm.iterations")
        active = (~_converged(simplex, fvals, xatol, fatol)
                  & (nit < maxiter))  # (B,)
        order = torch.argsort(fvals, dim=1, stable=True)
        sorted_simplex = torch.take_along_dim(simplex, order[:, :, None],
                                              dim=1)
        sorted_fvals = torch.take_along_dim(fvals, order, dim=1)

        centroid = torch.mean(sorted_simplex[:, :-1], dim=1)  # (B, d)
        direction = centroid - sorted_simplex[:, -1]
        cands = torch.clamp(torch.stack([
            centroid + direction,
            centroid + 2.0 * direction,
            centroid + 0.5 * direction,
            centroid - 0.5 * direction,
        ]), min=lo, max=hi)  # (4, B, d)
        fr, fe, foc, fic = evaluate(cands, active)
        xr, xe, xoc, xic = cands
        take_expand, take_reflect, take_oc, shrink = _decide(
            fr, fe, foc, fic, sorted_fvals[:, 0], sorted_fvals[:, -2],
            sorted_fvals[:, -1])
        shrinking = shrink & active

        with span("nm.read"):
            n_active, n_shrink = torch.stack(
                [active.sum(), shrinking.sum()]).tolist()
        count("nm.lanes_evaluated", n_active)
        if not n_active:
            break

        cand_x = torch.where(
            take_expand[:, None], xe,
            torch.where(take_reflect[:, None], xr,
                        torch.where(take_oc[:, None], xoc, xic)))
        cand_f = torch.where(
            take_expand, fe,
            torch.where(take_reflect, fr,
                        torch.where(take_oc, foc, fic)))
        replaced_simplex = torch.cat(
            [sorted_simplex[:, :-1], cand_x[:, None, :]], dim=1)
        replaced_fvals = torch.cat(
            [sorted_fvals[:, :-1], cand_f[:, None]], dim=1)

        best = sorted_simplex[:, :1]
        shrunk_simplex = torch.clamp(
            best + 0.5 * (sorted_simplex - best), min=lo, max=hi)
        # d + 1 objective passes, paid only where they can be needed
        if n_shrink:
            count("nm.shrinks")
            count("nm.lanes_evaluated", n_shrink)
            shrunk_fvals = evaluate_simplexes(shrunk_simplex, shrinking)
        else:
            shrunk_fvals = torch.full_like(sorted_fvals, torch.inf)

        new_simplex = torch.where(shrink[:, None, None], shrunk_simplex,
                                  replaced_simplex)
        new_fvals = torch.where(shrink[:, None], shrunk_fvals,
                                replaced_fvals)
        # frozen lanes keep their state
        simplex = torch.where(active[:, None, None], new_simplex, simplex)
        fvals = torch.where(active[:, None], new_fvals, fvals)
        nit = nit + active.to(nit.dtype)
    return simplex, fvals, nit


# ===========================================================================
# Bounded L-BFGS through a sigmoid box map
# ===========================================================================
def _sigmoid_to_box(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _box_to_sigmoid(x, lo, hi):
    frac = torch.clamp((x - lo) / (hi - lo), 1e-3, 1.0 - 1e-3)
    return torch.log(frac) - torch.log1p(-frac)


_LBFGS_MEMORY = 10
_ARMIJO_C1 = 1e-4
# relative slack of the approximate decrease test (optax's zoom search's
# `approx_dec_rtol`, Hager and Zhang 2006, eq. 23)
_APPROX_DEC_RTOL = 1e-6
_MAX_BACKTRACKS = 30


def batched_lbfgs(fun, x0, args, bounds, maxiter: int = 200,
                  tol: float = 1e-6, device=None) -> NMResult:
    """Bounded L-BFGS over a batch of problems (see
    ``batched_nelder_mead`` for the calling convention).

    The box is removed by the reparametrisation ``x = lo + (hi - lo) *
    sigmoid(u)``, as in the reference. The minimiser itself is this
    module's own: a two-loop L-BFGS recursion (memory 10) written over
    the lane axis, one backtracking line search per lane, and all lanes'
    values and gradients from one backward pass of the summed lane
    objectives. The step halves, per lane, until it meets the Armijo
    test ``f(u + t p) <= f(u) + 1e-4 t g.p`` or, as the reference's
    search also accepts, Hager and Zhang's approximate decrease: a slope
    ``g(u + t p).p <= -(1 - 2e-4) g.p`` and ``f(u + t p) <= f(u) + 1e-6
    |f(u)|``. Near the optimum the decrease a step makes is below the
    rounding of f, where only the slopes still tell (a 3,000-observation
    variogram likelihood, ~2,000 in value, holds |grad| ~1e-5 with the
    Armijo test alone). A pair (s, y) with ``s.y <= 0`` is not stored. A
    lane stops when ``|grad| <= tol`` (success) or after `maxiter`
    iterations, and also when its line search finds no decrease (no
    success).

    The reference leans on a library L-BFGS (memory 10, zoom line
    search), so the two take different steps: they agree AT THE OPTIMUM
    (to the tolerance of the stop), not step for step, and `nit` is not
    comparable.
    """
    device = resolve_device(device, x0, *args)
    x0 = _float_tensor(x0, device)
    args = tuple(torch.as_tensor(a, device=device) for a in args)
    B, d = x0.shape
    lo, hi = _box(bounds, d, x0)
    vf = vmap(fun)

    def value_and_grad(u):
        u = u.detach().requires_grad_(True)
        with torch.enable_grad():
            f = vf(_sigmoid_to_box(u, lo, hi), *args)
            (g,) = torch.autograd.grad(f.sum(), u)
        return f.detach(), g

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    u = _box_to_sigmoid(x0, lo, hi)
    f, g = value_and_grad(u)
    S = torch.zeros((_LBFGS_MEMORY, B, d), dtype=u.dtype, device=device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((_LBFGS_MEMORY, B), dtype=u.dtype, device=device)
    gamma = torch.ones((B,), dtype=u.dtype, device=device)
    nit = torch.zeros((B,), dtype=torch.int32, device=device)
    stalled = torch.zeros((B,), dtype=torch.bool, device=device)
    slot = 0
    for _ in range(maxiter):
        gnorm = torch.linalg.norm(g, dim=1)
        # a NaN gradient compares false: the lane stops, without success
        active = (gnorm > tol) & (nit < maxiter) & ~stalled
        if not bool(active.any()):
            break
        # two-loop recursion, newest pair first; an empty slot has
        # rho = 0 and contributes nothing
        q = g.clone()
        order = [(slot - 1 - i) % _LBFGS_MEMORY for i in range(_LBFGS_MEMORY)]
        alphas = {}
        for i in order:
            alphas[i] = rho[i] * dot(S[i], q)
            q = q - alphas[i][:, None] * Y[i]
        r = gamma[:, None] * q
        for i in reversed(order):
            beta = rho[i] * dot(Y[i], r)
            r = r + S[i] * (alphas[i] - beta)[:, None]
        p = -r
        slope = dot(g, p)
        downhill = slope < 0
        p = torch.where(downhill[:, None], p, -g)
        slope = torch.where(downhill, slope, -gnorm * gnorm)
        # the first step has no curvature yet: a unit-length move
        t = torch.where(nit == 0, torch.clamp(1.0 / gnorm, max=1.0),
                        torch.ones_like(gnorm))
        searching = active.clone()
        u_new, f_new, g_new = u, f, g
        for _ in range(_MAX_BACKTRACKS):
            trial = u + (t * active)[:, None] * p
            f_trial, g_trial = value_and_grad(trial)
            armijo = f_trial <= f + _ARMIJO_C1 * t * slope
            approx = ((dot(g_trial, p) <= (2.0 * _ARMIJO_C1 - 1.0) * slope)
                      & (f_trial <= f + _APPROX_DEC_RTOL * torch.abs(f)))
            ok = searching & (armijo | approx)
            u_new = torch.where(ok[:, None], trial, u_new)
            f_new = torch.where(ok, f_trial, f_new)
            g_new = torch.where(ok[:, None], g_trial, g_new)
            searching = searching & ~ok
            if not bool(searching.any()):
                break
            t = torch.where(searching, 0.5 * t, t)
        stalled = stalled | searching
        moved = active & ~searching
        s = torch.where(moved[:, None], u_new - u, torch.zeros_like(u))
        y = torch.where(moved[:, None], g_new - g, torch.zeros_like(g))
        sy = dot(s, y)
        keep = sy > 1e-30
        S[slot] = torch.where(keep[:, None], s, torch.zeros_like(s))
        Y[slot] = torch.where(keep[:, None], y, torch.zeros_like(y))
        rho[slot] = torch.where(keep, 1.0 / torch.where(keep, sy, 1.0), 0.0)
        gamma = torch.where(keep, sy / torch.where(keep, dot(y, y), 1.0),
                            gamma)
        slot = (slot + 1) % _LBFGS_MEMORY
        u = torch.where(moved[:, None], u_new, u)
        f = torch.where(moved, f_new, f)
        g = torch.where(moved[:, None], g_new, g)
        nit = nit + active.to(nit.dtype)
    x = _sigmoid_to_box(u, lo, hi)
    with torch.no_grad():
        fx = vf(x, *args)
    return NMResult(x, fx, nit, torch.linalg.norm(g, dim=1) <= tol)


def lbfgs_minimize(
    fun: Callable,
    x0,
    bounds: tuple,
    maxiter: int = 200,
    tol: float = 1e-6,
    device=None,
) -> NMResult:
    """Bounded L-BFGS on one problem: ``batched_lbfgs`` with one lane.

    The gradient-based alternative to Nelder-Mead, usable because the
    whole likelihood (the half-integer Matern K_nu included) is
    differentiable. It converges in far fewer iterations than the
    simplex, though each costs a line search, and a batch waits for its
    slowest lane: prefer Nelder-Mead for batched throughput, L-BFGS for
    single fits, gradient access and Hessian standard errors.
    """
    device = resolve_device(device, x0)
    x0 = _float_tensor(x0, device)
    res = batched_lbfgs(lambda x: fun(x), x0[None, :], (), bounds,
                        maxiter=maxiter, tol=tol)
    return NMResult(*(part[0] for part in res))


# ===========================================================================
# Batched Levenberg-Marquardt (least-squares MLE lane)
# ===========================================================================
def batched_levenberg_marquardt(
    res_fun,
    x0,
    args,
    bounds,
    maxiter: int = 100,
    ftol: float = 1e-9,
    xtol: float = 1e-8,
    device=None,
) -> NMResult:
    r"""Batched damped Gauss-Newton over independent least-squares fits.

    The ellipse NLL is exactly weighted least squares in Fisher-z space
    (``EllipseModel._residuals_fit``), so instead of a derivative-free
    simplex walking ~10^2-10^3 evaluations per fit, each iteration solves
    the local quadratic model from one forward-mode Jacobian (d ~ 3
    tangents) plus one trial evaluation, typically ~20 iterations to the
    same optimum. The loop is written DIRECTLY over the batch dimension:
    per-lane damping and per-lane freezing are plain elementwise selects,
    so no lane waits on another's line search.

    ``res_fun(x_i, *args_i) -> (m,)`` residual vector of one problem;
    minimises ``0.5 * sum(res^2)`` per lane. `x0` is (B, d); each element
    of `args` has leading batch dim B; `bounds` is a shared (lo, hi) pair
    of (d,) arrays: trial steps are clipped into the box (as in the
    batched Nelder-Mead). Returns NMResult with ``fun = 0.5 * sse``,
    per-lane ``nit`` (accepted + rejected steps) and ``success``
    (converged before maxiter).

    Levenberg damping uses Fletcher's diagonal scaling
    ``(J'J + lam * diag(J'J)) delta = -J'r`` so the step is invariant to
    parameter scaling (km-scale ranges and radian-scale angles in one
    solve). Lanes converge successfully when an accepted step improves
    the SSE by < ftol relatively or moves < xtol relatively, or when
    damping saturates while the proposed step is already negligible (a
    lane that started at its optimum). Damping saturation with a
    non-trivial rejected step (NaN objective, no descent direction) stops
    the lane with ``success=False``: those fits get qc_code 9, matching
    the Nelder-Mead lane.
    """
    device = resolve_device(device, x0, *args)
    x0 = _float_tensor(x0, device)
    args = tuple(torch.as_tensor(a, device=device) for a in args)
    B, d = x0.shape
    lo, hi = _box(bounds, d, x0)

    def sse_one(x, *a):
        r = res_fun(x, *a)
        return 0.5 * torch.sum(r * r)

    def res_twice(x, *a):
        r = res_fun(x, *a)
        return r, r

    def rj_one(x, *a):
        J, r = jacfwd(res_twice, has_aux=True)(x, *a)
        return r, J

    sse_all = vmap(sse_one)
    rj_all = vmap(rj_one)

    tiny = torch.finfo(x0.dtype).tiny
    lam_max = 1e10
    eye = torch.eye(d, dtype=x0.dtype, device=device)

    with torch.no_grad():
        x = x0
        sse = sse_all(x0, *args)
        lam = torch.full((B,), 1e-3, dtype=x0.dtype, device=device)
        conv = torch.zeros((B,), dtype=torch.bool, device=device)
        ok = torch.zeros((B,), dtype=torch.bool, device=device)
        nit = torch.zeros((B,), dtype=torch.int32, device=device)
        n_any = 0
        while n_any < maxiter and not bool(conv.all()):
            r, J = rj_all(x, *args)  # (B, m), (B, m, d)
            g = torch.einsum("bmd,bm->bd", J, r)
            A = torch.einsum("bmd,bme->bde", J, J)
            diagA = torch.diagonal(A, dim1=1, dim2=2)
            # scale floor keeps zero-data lanes (all-masked residuals)
            # solvable: delta collapses to 0 and the lane converges
            scale = torch.clamp(diagA, min=1e-12)
            M = A + (lam[:, None] * scale)[:, None, :] * eye
            delta = -torch.linalg.solve_ex(M, g[..., None])[0][..., 0]
            x_trial = torch.clamp(x + delta, min=lo, max=hi)
            sse_trial = sse_all(x_trial, *args)

            better = sse_trial < sse
            accept = better & ~conv
            step = x_trial - x
            rel_impr = (sse - sse_trial) / torch.clamp(sse, min=tiny)
            step_small = torch.amax(
                torch.abs(step) / torch.clamp(torch.abs(x), min=1.0), dim=1
            ) < xtol
            # Converged for real: an accepted step whose improvement or
            # size dropped below tolerance, OR damping saturated while
            # the PROPOSED step was already negligible (a lane that
            # started at its optimum: delta ~ 0 never strictly improves,
            # so it rides the damping ratchet, but it IS at a stationary
            # point). Saturation with a non-trivial rejected step (NaN
            # data, no descent direction found) ends the lane as FAILED.
            stuck = (~better) & (lam >= lam_max) & ~conv
            conv_good = (accept & ((rel_impr < ftol) | step_small)) | (
                stuck & step_small)
            newly_conv = conv_good | stuck

            x = torch.where(accept[:, None], x_trial, x)
            sse = torch.where(accept, sse_trial, sse)
            lam = torch.where(
                conv, lam,
                torch.clamp(torch.where(better, lam / 3.0, lam * 4.0),
                            1e-12, lam_max))
            nit = nit + (~conv).to(nit.dtype)
            conv = conv | newly_conv
            ok = ok | conv_good
            n_any += 1
    return NMResult(x, sse, nit, ok)
