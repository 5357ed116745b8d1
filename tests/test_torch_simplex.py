"""The card's Nelder-Mead loop (``ops/cuda/simplex``) on the CPU: which
solves it takes, that the CPU keeps the eager loop, and its replay loop
against the eager loop with the kernels' plain twins.

P and D run only on the card (``tests/test_torch_cuda_simplex.py`` holds
them to the eager loop there, bit for bit). Here ``_prepare`` and
``_decide`` are replaced by plain PyTorch twins of what the kernels do
to the loop's buffers (the previous trip's selection completed, the
trip's sort, candidates and masks, the tallies), the graph by the
uncaptured chain, and K5 by the vmapped objective: the loop's buffers,
tallies, replays and counters then give the eager loop's bits and
counts.
"""

import functools
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch import EllipseBuilder
from glomargridding_tpu_torch.models.ellipse import estimate
from glomargridding_tpu_torch.models.ellipse.model import EllipseModel
from glomargridding_tpu_torch.ops import optim
from glomargridding_tpu_torch.ops.cuda import ellipse_nll
from glomargridding_tpu_torch.ops.cuda import simplex as card
from glomargridding_tpu_torch.utils.profiling import COUNTS

torch.set_num_threads(2)

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
NM_COUNTERS = ("nm.iterations", "nm.points", "nm.shrinks",
               "nm.lanes_offered", "nm.lanes_evaluated")


def _model(rotated=True, fit_sigma=False, v=1.5):
    return EllipseModel(anisotropic=True, rotated=rotated,
                        physical_distance=True, v=v,
                        unit_sigma=not fit_sigma)


def _k5(v=1.5, fit_sigma=False):
    return ellipse_nll.FisherZ(v, fit_sigma)


@pytest.mark.parametrize("device, d, objective, takes", [
    (CUDA, 3, _k5(), True),
    (CUDA, 2, _k5(0.5), True),
    (CUDA, 4, _k5(2.5, True), True),
    (CPU, 3, _k5(), False),
    # the vmapped objective (model.py's bootstrap, the CPU's K5 twin)
    (CUDA, 3, optim.stacked_objective(_model()._nll_fit_z, 3), False),
    # d + 1 above K5's points a call
    (CUDA, 5, _k5(), False),
    # the L-BFGS and Levenberg-Marquardt lanes' objectives
    (CUDA, 3, _model()._nll_fit_z, False),
    (CUDA, 3, _model()._residuals_fit_z, False),
    # K5's wrapper, but not as the FisherZ objective _chunk_fitter binds
    (CUDA, 3, functools.partial(ellipse_nll.fisher_z_nll, v=1.5), False),
    (CUDA, 3, lambda *a, **k: ellipse_nll.fisher_z_nll(
        *a, v=1.5, fit_sigma=False, **k), False),
])
def test_which_solves_run_on_the_card(device, d, objective, takes):
    """A CUDA device, d + 1 <= 5 and K5 as the ``FisherZ`` objective
    ``_chunk_fitter`` binds; the CPU, the vmapped objective, the gradient
    lanes' objectives, any other callable and d + 1 > 5 keep the eager
    loop."""
    assert card.takes(device, d, objective) is takes


def test_fisher_z_is_k5_bound_to_the_model(monkeypatch):
    """``FisherZ(v, fit_sigma)`` calls K5's wrapper with the model's order
    and sigma flag, passing `out` and `launches` through; equal bindings
    are equal (one loop a shape), and ``_chunk_fitter`` binds one where
    ``_k5_takes``."""
    calls = []
    monkeypatch.setattr(ellipse_nll, "fisher_z_nll",
                        lambda *a, **k: calls.append((len(a), k)))
    _k5(2.5, True)(*range(5), out="o", launches="n")
    _k5()(*range(5))
    assert calls == [(5, dict(v=2.5, fit_sigma=True, out="o",
                              launches="n")),
                     (5, dict(v=1.5, fit_sigma=False))]
    assert _k5() == _k5(1.5, False) and hash(_k5()) == hash(_k5(1.5, False))
    assert _k5() != _k5(1.5, True)
    bound = []

    class Bound(Exception):
        pass

    def solve(*a, stacked_fun, **k):
        bound.append(stacked_fun)
        raise Bound

    monkeypatch.setattr(estimate, "_k5_takes", lambda *a: True)
    monkeypatch.setattr(estimate, "batched_nelder_mead", solve)
    builder = _builder()
    model = _model(fit_sigma=True, v=2.5)
    x0, box, _ = model._fit_setup([800.0, 800.0, 0.0, 1.0], [
        (100.0, 2e4), (100.0, 2e4), (-7.0, 7.0), (0.1, 3.0)],
        torch.float64, CPU)
    fit, _ = builder._chunk_fitter(
        model, "nm", 1e-3, builder._geometry(model, 0.3, 3000.0,
                                             "Modified_Met_Office", True, 8),
        x0, box)
    with pytest.raises(Bound):
        fit(np.arange(4))
    assert bound == [_k5(2.5, True)]


def _builder():
    """An EllipseBuilder on the CPU over a 4 x 5 grid of 30 noise fields."""
    lats, lons = np.arange(-7.5, 12.5, 5.0), np.arange(2.5, 27.5, 5.0)
    cube = np.random.default_rng(7).normal(size=(30, lats.size, lons.size))
    return EllipseBuilder(cube, {"time": np.arange(30), "latitude": lats,
                                 "longitude": lons}, device="cpu")


@pytest.mark.parametrize("launches", [
    torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int64)])
def test_k5_refuses_a_launch_counter_it_cannot_add_to(launches):
    """K5's `launches` is one int64 element on the call's device."""
    with pytest.raises(ValueError, match="launches"):
        ellipse_nll._outputs(None, launches, 4, 8, CPU)


def _lanes(B, N, d, seed, dtype=torch.float64):
    """(x0, (X, z_y, w), bounds) of B lanes of N columns in d parameters
    (rotated, sigma fitted where d = 4): lengths of a few hundred to a few
    thousand km, a tight box so that candidates clip at both bounds, the
    last two lanes without data (w = 0: they shrink to xatol)."""
    g = np.random.default_rng(seed)
    X = g.uniform(-3000.0, 3000.0, (B, N, 2))
    w = (g.random((B, N)) > 0.2).astype(float)
    w[-2:] = 0.0
    z = np.arctanh(g.uniform(-0.1, 0.95, (B, N)))
    x0 = np.tile([1500.0, 1200.0, 0.3, 0.8][:d], (B, 1))
    x0[:, :2] *= g.uniform(0.8, 1.25, (B, 2))
    lo = np.array([700.0, 700.0, -1.0, 0.3][:d])
    hi = np.array([2600.0, 2600.0, 1.0, 2.0][:d])

    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    return t(x0), (t(X), t(z), t(w)), (t(lo), t(hi))


@functools.cache
def _stand_in(d):
    """K5's stand-in on the CPU: the vmapped objective on the mask's
    lanes, NaN on the others, into `out` where one is given, counting
    itself in `launches` where one is given. One object a `d`, so that
    the solves of a shape share one loop."""
    twin = optim.stacked_objective(
        _model(rotated=d != 2, fit_sigma=d == 4)._nll_fit_z, 3)

    def k5(points, X, z_y, w, mask, out=None, launches=None):
        values = torch.where(mask, twin(points, X, z_y, w, mask), torch.nan)
        if launches is not None:
            launches += 1
        return values if out is None else out.copy_(values)

    return k5


def _plain_prepare(loop, slot):
    """P's plain twin: complete the previous trip's selection (``pick``),
    then the trip's masks, sort, candidates and shrunk simplex."""
    t = loop.tally
    t[2] += 1
    pick = loop.pick.long()
    lanes = torch.arange(loop.B)
    which = torch.clamp(pick - 1, 0, 3)
    shrink = pick == 5
    replaced_x = torch.cat([loop.xs[:, :-1],
                            loop.cand.transpose(0, 1)[lanes, which][:, None]],
                           dim=1)
    replaced_f = torch.cat([loop.fs[:, :-1], loop.fc.T[lanes, which][:, None]],
                           dim=1)
    done = pick != 0
    loop.x.copy_(torch.where(done[:, None, None], torch.where(
        shrink[:, None, None], loop.shrunk.transpose(0, 1), replaced_x),
        loop.x))
    loop.f.copy_(torch.where(done[:, None], torch.where(
        shrink[:, None], loop.fsh.T, replaced_f), loop.f))
    loop.nit += done.to(loop.nit.dtype)
    active = (~optim._converged(loop.x, loop.f, loop.xatol, loop.fatol)
              & (loop.nit < loop.maxiter))
    order = torch.argsort(loop.f, dim=1, stable=True)
    xs = torch.take_along_dim(loop.x, order[:, :, None], dim=1)
    fs = torch.take_along_dim(loop.f, order, dim=1)
    centroid = torch.mean(xs[:, :-1], dim=1)
    direction = centroid - xs[:, -1]
    lo, hi = loop.lo, loop.hi
    loop.xs.copy_(xs)
    loop.fs.copy_(fs)
    loop.cand.copy_(torch.clamp(torch.stack([
        centroid + direction, centroid + 2.0 * direction,
        centroid + 0.5 * direction, centroid - 0.5 * direction]),
        min=lo, max=hi))
    loop.shrunk.copy_(torch.clamp(xs[:, :1] + 0.5 * (xs - xs[:, :1]),
                                  min=lo, max=hi).transpose(0, 1))
    loop.active.copy_(active)
    t[slot] += int(active.sum())
    t[7] += int(active.sum())


def _plain_decide(loop, slot):
    """D's plain twin: the decision, ``pick``, ``shrinking``, the
    tallies."""
    t = loop.tally
    if t[slot] == 0 and t[3] == 0:
        t[3] = t[2]
    t[slot ^ 1] = 0
    t[9] += 1
    fr, fe, foc, fic = loop.fc
    expand, reflect, oc, shrink = optim._decide(
        fr, fe, foc, fic, loop.fs[:, 0], loop.fs[:, -2], loop.fs[:, -1])
    pick = torch.where(shrink, 5, torch.where(expand, 2, torch.where(
        reflect, 1, torch.where(oc, 3, 4))))
    active = loop.active
    loop.pick.copy_(torch.where(active, pick, 0))
    loop.shrinking.copy_(shrink & active)
    n = int((shrink & active).sum())
    t[6] += n
    if n and t[5] < t[2]:
        t[5] = t[2]
        t[4] += 1


@pytest.fixture
def plain_card(monkeypatch):
    """The card's loop on the CPU: the kernels' twins, no capture, a
    fresh loop cache, and every solve routed to it."""
    monkeypatch.setattr(card, "_LOOPS", {})
    monkeypatch.setattr(card, "_prepare", _plain_prepare)
    monkeypatch.setattr(card, "_decide", _plain_decide)
    monkeypatch.setattr(card, "_capture",
                        lambda chain: SimpleNamespace(replay=chain))
    routed = {"card": True}
    monkeypatch.setattr(card, "takes", lambda *a: routed["card"])
    return routed


def _solve(x0, args, bounds, d, **kw):
    names = NM_COUNTERS + ("nm.graph_trips", "nm.spare_trips",
                           "k5.launches", "p.launches", "d.launches")
    before = {k: COUNTS[k] for k in names}
    res = optim.batched_nelder_mead(None, x0, args, bounds, device="cpu",
                                    stacked_fun=_stand_in(d), **kw)
    return res, {k: COUNTS[k] - v for k, v in before.items()}


def _replayed(plain_card, x0, args, bounds, d, **kw):
    """The card's loop against the eager loop on one solve: the same bits
    and the eager loop's counters, every eager trip replayed and fewer
    than ``TRIPS`` spare. Returns the result and the card's counts."""
    plain_card["card"] = False
    want, eager = _solve(x0, args, bounds, d, **kw)
    plain_card["card"] = True
    got, counts = _solve(x0, args, bounds, d, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert {k: counts[k] for k in NM_COUNTERS} == {
        k: eager[k] for k in NM_COUNTERS}
    assert eager["nm.graph_trips"] == 0
    assert counts["nm.graph_trips"] % card.TRIPS == 0
    assert 0 <= counts["nm.spare_trips"] < card.TRIPS
    assert counts["nm.graph_trips"] == (counts["nm.iterations"]
                                        + counts["nm.spare_trips"])
    assert counts["nm.iterations"] == int(want.nit.max()) + 1
    # the launches the kernels count: P and D once a trip run, K5 twice
    trips = counts["nm.graph_trips"]
    assert counts["p.launches"] == counts["d.launches"] == trips
    assert counts["k5.launches"] == 2 * trips
    return got, counts


@pytest.mark.parametrize("d, B, kw", [
    (3, 12, dict(xatol=1e-3, fatol=1e-3, maxiter=600)),
    (2, 9, dict(xatol=1e-4, fatol=1e-6, maxiter=400)),
    (4, 7, dict(xatol=1e-3, fatol=1e-4, maxiter=45)),  # lanes at maxiter
    (3, 5, dict(xatol=1e9, fatol=1e9, maxiter=600)),  # all stop at once
])
def test_the_replayed_trips_are_the_eager_trips(plain_card, d, B, kw):
    """Bit for bit and count for count (``_replayed``); two solves of one
    shape on different data share the loop's buffers and each meets its
    eager solve."""
    for seed in (1, 2):
        x0, args, bounds = _lanes(B, 24, d, seed=d * 10 + seed)
        got, counts = _replayed(plain_card, x0, args, bounds, d, **kw)
    assert len(card._LOOPS) == 1
    if kw["maxiter"] == 45:
        assert bool((got.nit == 45).any()) and not bool(got.success.all())
    if kw["xatol"] > 1:
        assert counts["nm.iterations"] == 1
    else:
        assert counts["nm.shrinks"] >= 1 and bool((got.nit > 0).all())


def test_solves_from_several_threads_each_meet_their_eager_solve(
        plain_card):
    """Eight threads solve one shape on different data at once through the
    one loop (its buffers shared, its lock held a solve), with a short
    switch interval: each result is its own eager solve's."""
    problems = [_lanes(5, 16, 2, seed=60 + i) for i in range(8)]
    kw = dict(xatol=1e-4, fatol=1e-6, maxiter=400)
    plain_card["card"] = False
    want = [_solve(*p, 2, **kw)[0] for p in problems]
    plain_card["card"] = True
    got = [None] * len(problems)

    def solve(i):
        got[i] = _solve(*problems[i], 2, **kw)[0]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=solve, args=(i,))
                   for i in range(len(problems))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for a, b in zip(want, got):
        assert b is not None
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_the_cpu_fit_keeps_the_eager_loop(monkeypatch):
    """On the CPU, ``_chunk_fitter``'s Nelder-Mead lane runs the eager
    loop (the card's loop is never asked to run) and returns its result:
    the eager loop on the same training data."""
    builder = _builder()
    model = _model()

    def refuse(*a, **k):
        raise AssertionError("the card's loop ran on the CPU")

    monkeypatch.setattr(card, "trips", refuse)
    kw = dict(max_distance=3000.0, guesses=[800.0, 800.0, 0.0],
              bounds=[(100.0, 20000.0), (100.0, 20000.0),
                      (-2 * np.pi, 2 * np.pi)], tol=1e-3, max_train_cols=8)
    cells = np.arange(0, 20, 2)
    fits = builder.fit_cells(cells, model, **kw)
    x0, box, _ = model._fit_setup(kw["guesses"], kw["bounds"],
                                  torch.float64, CPU)
    fit, build = builder._chunk_fitter(
        model, "nm", 1e-3, builder._geometry(model, 0.3, 3000.0,
                                             "Modified_Met_Office", True, 8),
        x0, box)
    X, z, w = build(cells)
    res = optim.batched_nelder_mead(
        None, x0[None].expand(cells.size, 3), (X, z, w), box, xatol=1e-3,
        fatol=1e-3, stacked_fun=optim.stacked_objective(model._nll_fit_z, 3))
    for a, b in zip(res, (fits.x, fits.fun, fits.nit, fits.success)):
        assert torch.equal(a, b)
    assert not estimate._k5_takes(model, "nm", CPU, torch.float64)
