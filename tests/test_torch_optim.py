"""The port's optimisers against the JAX package's, on the CPU in f64.

The same numpy inputs go through ``glomargridding_tpu.ops.optim`` and
``glomargridding_tpu_torch.ops.optim``. Nelder-Mead is a sequence of
comparisons, so on analytic objectives in f64 the two take the same
decisions: `nit` is held EQUAL and the points to 1e-9. L-BFGS has its own
line search (Armijo backtracking against optax's zoom), so it is held at
the optimum only. Levenberg-Marquardt is a statement-for-statement port:
`nit` equal, points to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.ops import optim as joptim
from glomargridding_tpu_torch.ops import optim as toptim
from glomargridding_tpu_torch.utils.profiling import COUNTS

torch.set_num_threads(2)

STEP_TOL = dict(rtol=1e-9, atol=1e-9)


def rosenbrock(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def rosen_args(x, a):
    return (a - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def _np(res):
    return [np.asarray(part.detach().cpu() if isinstance(part, torch.Tensor)
                       else part) for part in res]


def _assert_same_walk(ours, ref, **tol):
    x, f, nit, ok = _np(ours)
    rx, rf, rnit, rok = _np(ref)
    np.testing.assert_array_equal(nit, rnit)
    np.testing.assert_array_equal(ok, rok)
    np.testing.assert_allclose(x, rx, **(tol or STEP_TOL))
    np.testing.assert_allclose(f, rf, **(tol or STEP_TOL))


def test_nelder_mead_rosenbrock_step_for_step():
    kw = dict(xatol=1e-6, fatol=1e-6, maxiter=1000)
    ours = toptim.nelder_mead(rosenbrock, np.array([-1.2, 1.0]),
                              device="cpu", **kw)
    ref = joptim.nelder_mead(rosenbrock, jnp.array([-1.2, 1.0]), **kw)
    assert bool(ours.success)
    _assert_same_walk(ours, ref)
    np.testing.assert_allclose(ours.x.numpy(), [1.0, 1.0], atol=1e-4)


def test_nelder_mead_bounded_quadratic():
    # minimum outside the box: converges onto the bound
    bounds = (np.array([0.0, 0.0]), np.array([2.0, 2.0]))
    ours = toptim.nelder_mead(lambda x: torch.sum((x - 5.0) ** 2),
                              np.array([1.0, 1.0]), bounds=bounds,
                              device="cpu")
    ref = joptim.nelder_mead(lambda x: jnp.sum((x - 5.0) ** 2),
                             jnp.array([1.0, 1.0]),
                             bounds=tuple(map(jnp.asarray, bounds)))
    _assert_same_walk(ours, ref)
    np.testing.assert_allclose(ours.x.numpy(), [2.0, 2.0], atol=1e-3)


def test_nelder_mead_maxiter_reports_failure():
    ours = toptim.nelder_mead(rosenbrock, np.array([-1.2, 1.0]), maxiter=3,
                              xatol=1e-12, fatol=1e-12, device="cpu")
    assert not bool(ours.success)
    assert int(ours.nit) == 3


def test_batched_quadratics(rng):
    centres = rng.uniform(-3, 3, size=(64, 3))
    kw = dict(xatol=1e-6, fatol=1e-10, maxiter=600)
    bounds = (np.full(3, -10.0), np.full(3, 10.0))
    ours = toptim.batched_nelder_mead(
        lambda x, c: torch.sum((x - c) ** 2), np.zeros((64, 3)), (centres,),
        bounds, device="cpu", **kw)
    ref = joptim.batched_nelder_mead(
        lambda x, c: jnp.sum((x - c) ** 2), jnp.zeros((64, 3)),
        (jnp.asarray(centres),), tuple(map(jnp.asarray, bounds)), **kw)
    assert bool(ours.success.all())
    _assert_same_walk(ours, ref)
    np.testing.assert_allclose(ours.x.numpy(), centres, atol=1e-3)


def _rosen_batch(rng, B=16):
    return rng.uniform(0.5, 1.5, size=(B,)), rng.uniform(-2, 2, size=(B, 2))


def test_batched_matches_reference_and_one_lane_oracle(rng):
    """Rosenbrock from scattered starts mixes every branch of the
    decision tree and converges at different per-lane rates: the stacked
    candidate evaluation, the guarded shrink and the frozen-lane
    bookkeeping against the reference and against the one-lane form."""
    a, x0 = _rosen_batch(rng)
    bounds = (np.full(2, -5.0), np.full(2, 5.0))
    kw = dict(xatol=1e-6, fatol=1e-6, maxiter=800)
    ours = toptim.batched_nelder_mead(rosen_args, x0, (a,), bounds,
                                      device="cpu", **kw)
    ref = joptim.batched_nelder_mead(rosen_args, jnp.asarray(x0),
                                     (jnp.asarray(a),),
                                     tuple(map(jnp.asarray, bounds)), **kw)
    _assert_same_walk(ours, ref)
    assert len(np.unique(ours.nit.numpy())) > 1
    for i in (0, 7):
        lane = toptim.nelder_mead(
            lambda x: rosen_args(x, torch.as_tensor(a[i])), x0[i],
            bounds=bounds, device="cpu", **kw)
        assert int(lane.nit) == int(ours.nit[i])
        np.testing.assert_allclose(lane.x.numpy(), ours.x[i].numpy(),
                                   **STEP_TOL)


def _shrink_case(rng, B=8):
    return rng.uniform(-1, 1, size=(B, 3)), (np.full(3, -4.0),
                                             np.full(3, 4.0))


def test_batched_shrink_path(rng):
    """Non-smooth max-norm objectives force genuine shrink steps."""
    c, bounds = _shrink_case(rng)
    kw = dict(xatol=1e-5, fatol=1e-8, maxiter=1500)
    ours = toptim.batched_nelder_mead(
        lambda x, c: torch.max(torch.abs(x - c)), np.zeros((8, 3)), (c,),
        bounds, device="cpu", **kw)
    ref = joptim.batched_nelder_mead(
        lambda x, c: jnp.max(jnp.abs(x - c)), jnp.zeros((8, 3)),
        (jnp.asarray(c),), tuple(map(jnp.asarray, bounds)), **kw)
    _assert_same_walk(ours, ref)


def _masked_stacked(fun, n_args, masks):
    """The default stacked objective with NaN on every lane outside each
    call's mask, recording the masks: a stacked objective that skips."""
    plain = toptim.stacked_objective(fun, n_args)

    def stacked(points, *args_and_mask):
        mask = args_and_mask[-1]
        masks.append(mask.clone())
        return torch.where(mask, plain(points, *args_and_mask), torch.nan)

    return stacked


def _skip_case(name, rng):
    """(fun, x0, args, bounds, kw) of a batch whose lanes stop at
    different trips: Rosenbrock lanes, max-norm lanes that shrink, and
    lanes that run out of iterations."""
    if name == "rosenbrock":
        a, x0 = _rosen_batch(rng)
        return (rosen_args, x0, (a,), (np.full(2, -5.0), np.full(2, 5.0)),
                dict(xatol=1e-6, fatol=1e-6, maxiter=800))
    c, bounds = _shrink_case(rng)
    if name == "shrink":
        return (lambda x, c: torch.max(torch.abs(x - c)), np.zeros((8, 3)),
                (c,), bounds, dict(xatol=1e-5, fatol=1e-8, maxiter=1500))
    x0 = c * np.repeat([1e-3, 10.0], 4)[:, None]
    return (lambda x, t: torch.sum((x - t) ** 2), x0, (0.9 * x0,),
            (np.full(3, -40.0), np.full(3, 40.0)),
            dict(xatol=1e-4, fatol=1e-8, maxiter=40))


@pytest.mark.parametrize("case", ["rosenbrock", "shrink", "maxiter"])
def test_lanes_outside_the_mask_are_never_read(case, rng):
    """A stacked objective that returns NaN on every lane outside its
    call's mask gives the default's result bit for bit: the loop reads
    values only on the lanes the mask names (all at the start, the active
    lanes for the candidates, the active lanes that shrink), and the
    masks do leave lanes out."""
    fun, x0, args, bounds, kw = _skip_case(case, rng)
    plain = toptim.batched_nelder_mead(fun, x0, args, bounds, device="cpu",
                                       **kw)
    masks = []
    skipped = toptim.batched_nelder_mead(
        None, x0, args, bounds, device="cpu",
        stacked_fun=_masked_stacked(fun, len(args), masks), **kw)
    for a, b in zip(plain, skipped):
        assert torch.equal(a, b)
    if case == "maxiter":
        assert not bool(plain.success.all()) and bool(plain.success.any())
    assert bool(masks[0].all())
    assert any(not bool(m.all()) for m in masks)


def test_lane_counters_count_the_calls(rng):
    """``nm.lanes_offered`` is B a call and ``nm.lanes_evaluated`` the
    lanes of each call's mask, all B on the first; the calls are the
    start, one a trip and one a shrink pass. The default objective is
    offered and counted the same."""
    fun, x0, args, bounds, kw = _skip_case("shrink", rng)
    names = ("nm.iterations", "nm.shrinks", "nm.lanes_offered",
             "nm.lanes_evaluated")
    deltas = []
    for stacked in (True, False):
        masks = []
        before = {k: COUNTS[k] for k in names}
        toptim.batched_nelder_mead(
            None if stacked else fun, x0, args, bounds, device="cpu",
            stacked_fun=(_masked_stacked(fun, len(args), masks)
                         if stacked else None), **kw)
        deltas.append({k: COUNTS[k] - v for k, v in before.items()})
        if stacked:
            delta = deltas[0]
            calls = 1 + delta["nm.iterations"] + delta["nm.shrinks"]
            assert len(masks) == calls
            assert delta["nm.lanes_offered"] == x0.shape[0] * calls
            assert delta["nm.lanes_evaluated"] == sum(int(m.sum())
                                                      for m in masks)
            assert int(masks[0].sum()) == x0.shape[0]
            assert 0 < delta["nm.lanes_evaluated"] < delta["nm.lanes_offered"]
    assert deltas[0] == deltas[1]


@pytest.mark.parametrize("given", ["both", "neither"])
def test_the_objective_is_given_once(given, rng):
    """``fun`` or ``stacked_fun``: both, or neither, is refused before
    any evaluation."""
    fun, x0, args, bounds, kw = _skip_case("shrink", rng)
    stacked = toptim.stacked_objective(fun, len(args))
    with pytest.raises(ValueError, match="once"):
        toptim.batched_nelder_mead(
            fun if given == "both" else None, x0, args, bounds,
            device="cpu", stacked_fun=stacked if given == "both" else None,
            **kw)


def test_batched_maxiter_reports_failure():
    x0 = np.broadcast_to(np.asarray([-1.2, 1.0]), (4, 2)).copy()
    ours = toptim.batched_nelder_mead(
        lambda x, c: rosenbrock(x - c), x0, (np.zeros((4, 2)),), None,
        xatol=1e-12, fatol=1e-12, maxiter=3, device="cpu")
    assert not bool(ours.success.any())
    np.testing.assert_array_equal(ours.nit.numpy(), 3)


def test_lbfgs_bounded_quadratic():
    """At the optimum, as the reference: on the bound when the minimum
    lies outside the box, precisely when inside."""
    def f(x):
        return torch.sum((x - 5.0) ** 2)

    def jf(x):
        return jnp.sum((x - 5.0) ** 2)

    lo = np.array([0.0, 0.0])
    ours = toptim.lbfgs_minimize(f, np.array([1.0, 1.0]),
                                 bounds=(lo, np.array([2.0, 2.0])),
                                 device="cpu")
    ref = joptim.lbfgs_minimize(jf, jnp.array([1.0, 1.0]),
                                bounds=(jnp.asarray(lo),
                                        jnp.array([2.0, 2.0])))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-2)
    np.testing.assert_allclose(ours.x.numpy(), [2.0, 2.0], atol=1e-2)

    ours = toptim.lbfgs_minimize(f, np.array([1.0, 1.0]),
                                 bounds=(lo, np.array([10.0, 10.0])),
                                 device="cpu")
    assert bool(ours.success)
    np.testing.assert_allclose(ours.x.numpy(), [5.0, 5.0], atol=1e-4)


def test_lbfgs_finishes_below_the_rounding_of_f():
    """A bowl whose value carries rounding noise of 1e-9 (as a large
    Cholesky's log det does) and whose gradient is exact: near the
    minimum a step lowers f by less than the noise, where only the
    slopes still tell. Both searches accept Hager and Zhang's
    approximate decrease there and stop at |grad| <= tol; by the Armijo
    test alone the search stalls short of it."""
    h = np.array([1e3, 3e2, 1e2])

    def f(x):
        noise = 1e-9 * torch.sin(1e7 * torch.sum(x)).detach()
        bowl = 0.5 * torch.sum(torch.as_tensor(h) * (x - 0.3) ** 2)
        return 1e4 + bowl + noise

    def jf(x):
        noise = jax.lax.stop_gradient(1e-9 * jnp.sin(1e7 * jnp.sum(x)))
        return 1e4 + 0.5 * jnp.sum(jnp.asarray(h) * (x - 0.3) ** 2) + noise

    bounds = (np.full(3, -2.0), np.full(3, 2.0))
    ours = toptim.lbfgs_minimize(f, np.full(3, 1.0), bounds=bounds,
                                 tol=1e-7, device="cpu")
    ref = joptim.lbfgs_minimize(jf, jnp.full(3, 1.0),
                                bounds=tuple(map(jnp.asarray, bounds)),
                                tol=1e-7)
    assert bool(ref.success) and bool(ours.success)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-8)


def test_batched_lbfgs(rng):
    centres = rng.uniform(-3, 3, size=(32, 3))
    bounds = (np.full(3, -10.0), np.full(3, 10.0))
    ours = toptim.batched_lbfgs(lambda x, c: torch.sum((x - c) ** 2),
                                np.zeros((32, 3)), (centres,), bounds,
                                tol=1e-8, device="cpu")
    ref = joptim.batched_lbfgs(lambda x, c: jnp.sum((x - c) ** 2),
                               jnp.zeros((32, 3)), (jnp.asarray(centres),),
                               tuple(map(jnp.asarray, bounds)), tol=1e-8)
    assert bool(ours.success.all())
    # both stop at |grad| <= 1e-8 in u-space: the optima agree far inside
    # the reference test's own 1e-3
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-6)
    np.testing.assert_allclose(ours.x.numpy(), centres, atol=1e-6)


def test_batched_lbfgs_rosenbrock_lanes_and_nan_lane(rng):
    """Lanes that need many iterations and a line search each reach the
    valley's floor; a NaN lane stops at once without success."""
    a, x0 = _rosen_batch(rng, 6)
    a[5] = np.nan
    ours = toptim.batched_lbfgs(rosen_args, x0, (a,),
                                (np.full(2, -5.0), np.full(2, 5.0)),
                                maxiter=400, tol=1e-7, device="cpu")
    assert bool(ours.success[:5].all()) and not bool(ours.success[5])
    assert int(ours.nit[5]) == 0
    np.testing.assert_allclose(ours.x[:5, 0].numpy(), a[:5], atol=1e-4)
    np.testing.assert_allclose(ours.x[:5, 1].numpy(), a[:5] ** 2, atol=1e-4)


def test_lm_success_semantics():
    """A solvable lane and a lane that STARTS at its optimum both report
    success; a NaN lane leaves through damping saturation with
    success=False. Statement for statement the reference: `nit` equal."""
    t = np.linspace(0.0, 1.0, 16)
    y_good = 2.0 * t + 1.0
    x0 = np.asarray([[0.5, 0.0], [2.0, 1.0], [0.5, 0.0]])
    ys = np.stack([y_good, y_good, np.full_like(y_good, np.nan)])
    bounds = (np.asarray([-10.0, -10.0]), np.asarray([10.0, 10.0]))
    tt = torch.as_tensor(t)
    ours = toptim.batched_levenberg_marquardt(
        lambda x, y: x[0] * tt + x[1] - y, x0, (ys,), bounds, device="cpu")
    jt = jnp.asarray(t)
    ref = joptim.batched_levenberg_marquardt(
        lambda x, y: x[0] * jt + x[1] - y, jnp.asarray(x0),
        (jnp.asarray(ys),), tuple(map(jnp.asarray, bounds)))
    assert ours.success.tolist() == [True, True, False]
    np.testing.assert_array_equal(ours.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(ours.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_allclose(ours.x.numpy()[:2], np.asarray(ref.x)[:2],
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ours.x[0].numpy(), [2.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(ours.x[1].numpy(), [2.0, 1.0], atol=1e-6)


def test_lm_nonlinear_lanes(rng):
    """Exponential decays from scattered starts, clipped into a box:
    accepted and rejected steps, the damping ratchet, per-lane freezing."""
    t = np.linspace(0.0, 2.0, 40)
    truth = np.column_stack([rng.uniform(1, 3, 12), rng.uniform(0.5, 2, 12)])
    ys = truth[:, :1] * np.exp(-truth[:, 1:] * t[None, :]) + rng.normal(
        0, 0.01, (12, 40))
    x0 = np.tile([1.0, 1.0], (12, 1))
    bounds = (np.asarray([0.1, 0.1]), np.asarray([5.0, 5.0]))
    tt, jt = torch.as_tensor(t), jnp.asarray(t)
    ours = toptim.batched_levenberg_marquardt(
        lambda x, y: x[0] * torch.exp(-x[1] * tt) - y, x0, (ys,), bounds,
        device="cpu")
    ref = joptim.batched_levenberg_marquardt(
        lambda x, y: x[0] * jnp.exp(-x[1] * jt) - y, jnp.asarray(x0),
        (jnp.asarray(ys),), tuple(map(jnp.asarray, bounds)))
    assert bool(ours.success.all())
    np.testing.assert_array_equal(ours.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-8)
    np.testing.assert_allclose(ours.fun.numpy(), np.asarray(ref.fun),
                               rtol=1e-8)
    np.testing.assert_allclose(ours.x.numpy(), truth, rtol=0.05)
