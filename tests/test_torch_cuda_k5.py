"""K5 (``ops/cuda/ellipse_nll.fisher_z_nll``) on the card against its
plain twin, ``EllipseModel._nll_fit_z`` under vmap over lanes and points
(``ops.optim.stacked_objective``), and the fit that runs on it.

Opt-in: needs an NVIDIA Hopper GPU, nvcc and ``GLOMAR_CUDA_TESTS=1``.
Run from the repository root:

    GLOMAR_CUDA_TESTS=1 python -m pytest tests/test_torch_cuda_k5.py -q

Tolerance, max over the mask's lanes of |K5 - twin| / |twin|: 1e-12, the
float64 sums' order over the columns (at most N 2^-53 relative). K5 takes
the twin's operations in the twin's order, each rounded on its own (nvcc
contracts none into an FMA), through the CUDA math library that
PyTorch's kernels call, so its terms are the twin's bit for bit (2.2e-16
measured at the cell's call on an H100), in f32 as in f64. Where sigma is
fitted, f32 1e-6: K5 multiplies by 1 / sigma where the twin divides, one
rounding more in r (2^-24), ~1.2e-7 of a term at most; every term is
non-negative, so the sum's relative error is at most the worst term's.
"""

import math
import os

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch import EllipseBuilder
from glomargridding_tpu_torch.models.ellipse import estimate
from glomargridding_tpu_torch.models.ellipse.model import EllipseModel
from glomargridding_tpu_torch.ops import optim
from glomargridding_tpu_torch.ops.cuda import ellipse_nll
from glomargridding_tpu_torch.utils.profiling import COUNTS

pytestmark = pytest.mark.cuda

RTOL, RTOL_F32_FITTED_SIGMA = 1e-12, 1e-6


@pytest.fixture(autouse=True)
def _card():
    if os.environ.get("GLOMAR_CUDA_TESTS") != "1":
        pytest.skip("CUDA kernel tests are opt-in (GLOMAR_CUDA_TESTS=1)")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _model(rotated, fit_sigma, v):
    return EllipseModel(anisotropic=True, rotated=rotated,
                        physical_distance=True, v=v,
                        unit_sigma=not fit_sigma)


def _case(K, B, N, rotated, fit_sigma, dtype, seed=0):
    """Points, training data and mask on the card: lengths 300-8,000 km,
    any angle, sigma 0.05-0.5; displacements within 4,000 km, 10% of the
    columns weighted 0 and 2% of them zero-weight columns at the origin,
    the last column at the origin with weight 1 (the model's NaN there is
    read as 0), Fisher-z observations of correlations in (-0.2, 0.99);
    lane 0 holds no weighted column; 70% of the lanes in the mask, lane 0
    among them and lane 1 not."""
    g = np.random.default_rng(seed)
    d = (3 if rotated else 2) + int(fit_sigma)
    pts = np.empty((K, B, d))
    pts[..., :2] = g.uniform(300.0, 8000.0, (K, B, 2))
    if rotated:
        pts[..., 2] = g.uniform(-2 * math.pi, 2 * math.pi, (K, B))
    if fit_sigma:
        pts[..., -1] = g.uniform(0.05, 0.5, (K, B))
    X = g.uniform(-4000.0, 4000.0, (B, N, 2))
    w = (g.random((B, N)) > 0.1).astype(float)
    origin = g.random((B, N)) < 0.02
    X[origin], w[origin] = 0.0, 0.0
    X[:, -1], w[:, -1] = 0.0, 1.0
    w[0] = 0.0
    z = np.arctanh(g.uniform(-0.2, 0.99, (B, N)))
    mask = g.random(B) < 0.7
    mask[0] = True
    if B > 1:
        mask[1] = False

    def card(a, t=dtype):
        return torch.as_tensor(a, dtype=t, device="cuda").contiguous()

    return (card(pts), card(X), card(z), card(w), card(mask, torch.bool))


def _twin(model, points, X, z, w, mask):
    out = optim.stacked_objective(model._nll_fit_z, 3)(points, X, z, w, mask)
    return torch.where(mask, out, torch.inf)


def _rel(k, p, mask):
    err = torch.abs(k - p) / torch.clamp(torch.abs(p), min=1e-300)
    return float(err[:, mask].max())


def _check(K, B, N, rotated, fit_sigma, v, dtype, seed=0):
    model = _model(rotated, fit_sigma, v)
    inputs = _case(K, B, N, rotated, fit_sigma, dtype, seed)
    mask = inputs[-1]
    before = COUNTS["k5.launches"]
    k = ellipse_nll.fisher_z_nll(*inputs, v=v, fit_sigma=fit_sigma)
    again = ellipse_nll.fisher_z_nll(*inputs, v=v, fit_sigma=fit_sigma)
    p = _twin(model, *inputs)
    torch.cuda.synchronize()
    assert COUNTS["k5.launches"] - before == 2
    assert k.shape == (K, B) and k.dtype == torch.float64
    assert torch.equal(k, again)
    assert bool(torch.isinf(k[:, ~mask]).all()) and bool(
        (k[:, ~mask] > 0).all())
    assert bool(torch.isfinite(k[:, mask]).all())
    tol = RTOL_F32_FITTED_SIGMA if (
        fit_sigma and dtype == torch.float32) else RTOL
    assert _rel(k, p, mask) <= tol, (K, B, N, rotated, fit_sigma, v)


def test_the_cells_shapes():
    """4 candidates x 2,048 lanes x 4,096 columns in f32, the rotated
    unit-sigma form at nu = 1.5: ``ell1deg.fit``'s stacked call."""
    _check(4, 2048, 4096, True, False, 1.5, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K, B, N, rotated, fit_sigma, v", [
    (5, 33, 1001, True, True, 1.5),  # d + 1 with sigma fitted, N % 4 != 0
    (4, 1, 64, True, False, 1.5),  # one lane
    (3, 40, 4096, False, False, 0.5),  # 2-parameter, d + 1
    (4, 17, 1030, False, True, 2.5),  # 2-parameter with sigma
    (4, 64, 515, True, False, 3.5),
    (1, 8, 7, True, True, 1.5),  # fewer columns than a block's threads
])
def test_forms_and_ragged_shapes(K, B, N, rotated, fit_sigma, v, dtype):
    _check(K, B, N, rotated, fit_sigma, v, dtype, seed=K * B + N)


def test_a_lane_outside_the_mask_reads_nothing():
    """With no lane in the mask, every value is +inf, even where the data
    would give NaN."""
    points, X, z, w, mask = _case(4, 16, 256, True, False, torch.float32)
    X[:] = torch.nan
    out = ellipse_nll.fisher_z_nll(points, X, z, w, torch.zeros_like(mask),
                                   v=1.5, fit_sigma=False)
    assert bool(torch.isposinf(out).all())


def _planar_builder(dtype):
    """tests/test_torch_ellipse_fit_cells.py's cube, on the card."""
    lats, lons = np.arange(-17.5, 22.5, 5.0), np.arange(2.5, 52.5, 5.0)
    rng = np.random.default_rng(160)
    la, lo = np.meshgrid(lats, lons, indexing="ij")
    x = 111.2 * lo.ravel() * np.cos(np.radians(2.5))
    y = 111.2 * la.ravel()
    c, s = np.cos(0.4), np.sin(0.4)
    u = (c * (x[:, None] - x[None, :]) + s * (y[:, None] - y[None, :]))
    v = (-s * (x[:, None] - x[None, :]) + c * (y[:, None] - y[None, :]))
    cov = np.exp(-np.sqrt((u / 1500.0) ** 2 + (v / 700.0) ** 2))
    cube = (np.linalg.cholesky(cov + 1e-9 * np.eye(x.size))
            @ rng.normal(size=(x.size, 60))).T.reshape(60, lats.size,
                                                        lons.size)
    return EllipseBuilder(torch.as_tensor(cube, dtype=dtype, device="cuda"),
                          {"time": np.arange(60), "latitude": lats,
                           "longitude": lons}, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_objective_call_of_a_fit_is_a_k5_launch(dtype, monkeypatch):
    """``fit_cells`` on the card sends every Nelder-Mead objective call to
    K5 (the start, each trip, each shrink pass; the card's loop,
    ``ops.cuda.simplex``, also makes an empty call in the shrink slot of
    its other trips and two in each spare trip, and K5 counts its
    launches there on the card), and reaches the fit the
    vmapped objective reaches: the same iterations on at least 90% of the
    lanes (the two sum a lane's terms in another order, and the simplex
    may take a comparison the other way at the last bits), and every
    objective at the optimum within 1e-6 relative of the other's."""
    builder = _planar_builder(dtype)
    kw = dict(max_distance=6000.0, guesses=[800.0, 800.0, 0.0],
              bounds=[(100.0, 20000.0), (100.0, 20000.0),
                      (-2 * np.pi, 2 * np.pi)],
              tol=1e-3, max_train_cols=48, chunk_size=32)
    model = _model(True, False, 1.5)
    cells = np.arange(0, 80, 3)
    names = ("k5.launches", "nm.iterations", "nm.shrinks", "nm.spare_trips")
    before = {k: COUNTS[k] for k in names}
    fast = builder.fit_cells(cells, model, **kw)
    delta = {k: COUNTS[k] - v for k, v in before.items()}
    iterations, shrinks = delta["nm.iterations"], delta["nm.shrinks"]
    empty = (iterations - shrinks) + 2 * delta["nm.spare_trips"]
    assert delta["k5.launches"] == 1 + iterations + shrinks + empty
    monkeypatch.setattr(estimate, "_k5_takes", lambda *a: False)
    before = COUNTS["k5.launches"]
    plain = builder.fit_cells(cells, model, **kw)
    assert COUNTS["k5.launches"] == before
    same_nit = (fast.nit == plain.nit).double().mean().item()
    assert same_nit >= 0.9, same_nit
    rel = torch.abs(fast.fun - plain.fun) / torch.abs(plain.fun)
    assert float(rel.max()) <= 1e-6
