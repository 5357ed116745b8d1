"""The card's Nelder-Mead loop (``ops/cuda/simplex``: kernels P and D
around K5, replayed as a CUDA graph) against the eager loop on the card,
bit for bit: x, fun, nit, success and the ``nm.*`` counters.

Opt-in: needs an NVIDIA Hopper GPU, nvcc and ``GLOMAR_CUDA_TESTS=1``.
Run from the repository root:

    GLOMAR_CUDA_TESTS=1 python -m pytest tests/test_torch_cuda_simplex.py -q

Both loops call K5 on the same points, so equal decisions give equal
bits: the card's loop is held equal, with no tolerance. The eager loop
runs the same solve with ``simplex.takes`` patched to refuse it.
"""

import os

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch.ops import optim
from glomargridding_tpu_torch.ops.cuda import ellipse_nll
from glomargridding_tpu_torch.ops.cuda import simplex as card
from glomargridding_tpu_torch.utils.profiling import COUNTS

pytestmark = pytest.mark.cuda

NM_COUNTERS = ("nm.iterations", "nm.points", "nm.shrinks",
               "nm.lanes_offered", "nm.lanes_evaluated")
COUNTED = NM_COUNTERS + ("nm.graph_trips", "nm.spare_trips", "k5.launches",
                         "p.launches", "d.launches")


@pytest.fixture(autouse=True)
def _card():
    if os.environ.get("GLOMAR_CUDA_TESTS") != "1":
        pytest.skip("CUDA kernel tests are opt-in (GLOMAR_CUDA_TESTS=1)")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _lanes(B, N, rotated, fit_sigma, dtype, seed, box=(700.0, 2600.0)):
    """(x0, (X, z_y, w), bounds) on the card: displacements within 3,000
    km, 20% of the columns weighted 0, Fisher-z observations of
    correlations in (-0.1, 0.95), but within 0.05 of 0 on the first four
    lanes (their lengths fall to the lower bound) and in (0.97, 0.99) on
    the next four (theirs rise to the upper); the last three lanes
    without data (they shrink to xatol); starts of 1,200-1,900 km in a
    box of `box` km (and theta in (-1, 1), sigma in (0.3, 2))."""
    g = np.random.default_rng(seed)
    d = 2 + int(rotated) + int(fit_sigma)
    X = g.uniform(-3000.0, 3000.0, (B, N, 2))
    w = (g.random((B, N)) > 0.2).astype(float)
    w[-3:] = 0.0
    y = g.uniform(-0.1, 0.95, (B, N))
    y[:4] = g.uniform(-0.05, 0.05, (4, N))
    y[4:8] = g.uniform(0.97, 0.99, (4, N))
    z = np.arctanh(y)
    x0 = np.empty((B, d))
    x0[:, :2] = g.uniform(1200.0, 1900.0, (B, 2))
    lo, hi = [box[0]] * 2, [box[1]] * 2
    if rotated:
        x0[:, 2] = g.uniform(-0.5, 0.5, B)
        lo, hi = lo + [-1.0], hi + [1.0]
    if fit_sigma:
        x0[:, -1] = 0.8
        lo, hi = lo + [0.3], hi + [2.0]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    return t(x0), (t(X), t(z), t(w)), (t(lo), t(hi))


def _solve(x0, args, bounds, stacked, **kw):
    before = {k: COUNTS[k] for k in COUNTED}
    res = optim.batched_nelder_mead(None, x0, args, bounds,
                                    stacked_fun=stacked, **kw)
    torch.cuda.synchronize()
    return res, {k: COUNTS[k] - v for k, v in before.items()}


def _same(monkeypatch, x0, args, bounds, v, fit_sigma, **kw):
    """The card's loop against the eager loop on one solve; returns the
    card's result and counter deltas."""
    k5 = ellipse_nll.FisherZ(v, fit_sigma)
    assert card.takes(x0.device, x0.shape[1], k5)
    with monkeypatch.context() as m:
        m.setattr(card, "takes", lambda *a: False)
        want, eager = _solve(x0, args, bounds, k5, **kw)
    got, counts = _solve(x0, args, bounds, k5, **kw)
    for name, a, b in zip(("x", "fun", "nit", "success"), want, got):
        differ = (a != b).reshape(a.shape[0], -1).any(dim=1)
        assert not bool(differ.any()), (
            f"{name}: {int(differ.sum())} of {a.shape[0]} lanes differ, the "
            f"first {int(torch.nonzero(differ)[0])}; nit {want.nit.tolist()}"
            f" against {got.nit.tolist()}")
    assert {k: counts[k] for k in NM_COUNTERS} == {
        k: eager[k] for k in NM_COUNTERS}
    assert eager["nm.graph_trips"] == 0 and eager["k5.launches"] == (
        1 + eager["nm.iterations"] + eager["nm.shrinks"])
    assert counts["nm.iterations"] == int(got.nit.max()) + 1
    _launches_match(counts, eager)
    return got, counts


def _launches_match(counts, eager):
    """The trips replayed, and the launches K5, P and D count on the card:
    P and D one a trip run; K5 the start, then the eager loop's calls
    (one a trip up to the loop's last, one a shrink trip) and the empty
    ones (the shrink slot of the other trips, both slots of the spare
    ones)."""
    trips = counts["nm.graph_trips"]
    assert trips % card.TRIPS == 0
    assert 0 <= counts["nm.spare_trips"] < card.TRIPS
    assert trips == counts["nm.iterations"] + counts["nm.spare_trips"]
    assert counts["p.launches"] == counts["d.launches"] == trips
    iterations, shrinks = counts["nm.iterations"], counts["nm.shrinks"]
    empty = (iterations - shrinks) + 2 * counts["nm.spare_trips"]
    assert counts["k5.launches"] == 1 + iterations + shrinks + empty
    assert eager["p.launches"] == eager["d.launches"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rotated, fit_sigma, v", [
    (False, False, 0.5),  # d = 2
    (False, True, 2.5),  # d = 3
    (True, False, 1.5),  # d = 3
    (True, True, 3.5),  # d = 4
])
def test_the_card_loop_is_the_eager_loop(rotated, fit_sigma, v, dtype,
                                         monkeypatch):
    """Every form of K5 in f32 and f64, on 200 lanes (not a multiple of
    P's and D's 128-thread blocks): lanes that shrink, lanes with no
    data, candidates clipped at both bounds; then a second solve of the
    same shape on other data through the same captured graph."""
    x0, args, bounds = _lanes(200, 301, rotated, fit_sigma, dtype, seed=5)
    got, counts = _same(monkeypatch, x0, args, bounds, v, fit_sigma,
                        xatol=1e-3, fatol=1e-3)
    assert counts["nm.shrinks"] >= 1
    assert bool(got.success[-3:].all()) and bool((got.nit[-3:] > 0).all())
    lo, hi = bounds
    assert bool((got.x[:4, :2] == lo[:2]).any())
    assert bool((got.x[4:8, :2] == hi[:2]).any())
    loop = card._LOOPS[x0.device]
    graph = loop.graph
    x0, args, bounds = _lanes(200, 301, rotated, fit_sigma, dtype, seed=6)
    _same(monkeypatch, x0, args, bounds, v, fit_sigma, xatol=1e-3,
          fatol=1e-3)
    assert card._LOOPS[x0.device] is loop and loop.graph is graph


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lanes_that_stop_at_maxiter(dtype, monkeypatch):
    """maxiter 37, no multiple of the trips a replay: lanes stop there
    unconverged."""
    x0, args, bounds = _lanes(130, 257, True, False, dtype, seed=7)
    got, _ = _same(monkeypatch, x0, args, bounds, 1.5, False, xatol=1e-6,
                   fatol=1e-9, maxiter=37)
    assert bool((got.nit == 37).any()) and not bool(got.success.all())


def test_every_lane_converged_in_the_first_replay(monkeypatch):
    """With tolerances no simplex exceeds, every lane stops before its
    first trip: one trip of the eager loop, the rest of the first replay
    spare."""
    x0, args, bounds = _lanes(64, 128, True, False, torch.float32, seed=8)
    got, counts = _same(monkeypatch, x0, args, bounds, 1.5, False,
                        xatol=1e9, fatol=1e12)
    assert counts["nm.iterations"] == 1
    assert counts["nm.graph_trips"] == card.TRIPS
    assert bool((got.nit == 0).all()) and bool(got.success.all())


def test_the_cells_shape(monkeypatch):
    """2,048 lanes of 4,096 columns in f32, the rotated unit-sigma form
    at nu = 1.5 and the configuration's box and tolerance: the shape of
    ``ell1deg.fit``'s solves."""
    x0, args, bounds = _lanes(2048, 4096, True, False, torch.float32,
                              seed=9, box=(300.0, 30000.0))
    bounds = (bounds[0].new_tensor([300.0, 300.0, -2 * np.pi]),
              bounds[1].new_tensor([30000.0, 30000.0, 2 * np.pi]))
    _, counts = _same(monkeypatch, x0, args, bounds, 1.5, False, xatol=1e-3,
                      fatol=1e-3)
    assert counts["nm.iterations"] > card.TRIPS
