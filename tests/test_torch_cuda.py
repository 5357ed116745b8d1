"""The CUDA tile kernel (K1) on the card, against its plain PyTorch twin.

Opt-in: needs an NVIDIA Hopper GPU, nvcc and ``GLOMAR_CUDA_TESTS=1``.
Run from the repository root:

    GLOMAR_CUDA_TESTS=1 python -m pytest tests/test_torch_cuda.py -q

The first test builds the kernel from ``glomargridding_tpu_torch/ops/
cuda/csrc`` (seconds). Tolerance, as max |kernel - plain| / variance:
f64 1e-12; f32 1e-5 (the f32 A&S asin carries ~1 ulp of pi/2 of
absolute error at every distance, and the kernel's FMA contraction moves
a few roundings; see chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.ops.cuda import pairwise as tpair
from glomargridding_tpu_torch.ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
)

pytestmark = pytest.mark.cuda

TILE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}

MODELS = (
    [
        MaternVariogram(psill=1.2, nugget=0.1, range=1500.0, nu=nu, method=m)
        for nu in (0.5, 1.5, 2.5, 3.5)
        for m in ("sklearn", "gstat", "karspeck")
    ]
    + [
        ExponentialVariogram(psill=1.0, nugget=0.05, range=800.0),
        GaussianVariogram(psill=1.0, nugget=0.05, range=800.0),
        SphericalVariogram(psill=1.0, nugget=0.05, range=3000.0),
    ]
)


@pytest.fixture(autouse=True)
def _card():
    if os.environ.get("GLOMAR_CUDA_TESTS") != "1":
        pytest.skip("CUDA kernel tests are opt-in (GLOMAR_CUDA_TESTS=1)")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _coords(m, n, dtype, seed=0):
    g = np.random.default_rng(seed)
    coords = [
        np.radians(g.uniform(-lim, lim, size))
        for size in (m, n)
        for lim in (89, 180)
    ]
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in coords]


def _rel(k, p, scale):
    """max |k - p| relative to the tile's scale, its variance (sill)."""
    return torch.max(torch.abs(k - p)).item() / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("distance", ["haversine", "chordal", "cartesian"])
@pytest.mark.parametrize(
    "model", MODELS,
    ids=lambda v: f"{v.kind}-{getattr(v, 'nu', '')}-{getattr(v, 'method', '')}",
)
def test_tile_matches_plain(model, distance, dtype):
    """Every template combination, at ragged and tile-aligned shapes."""
    for m, n in ((1, 1), (63, 129), (200, 333), (256, 512)):
        coords = _coords(m, n, dtype)
        k = tpair.pairwise_covariance(*coords, model, distance)
        p = tpair.pairwise_covariance_torch(*coords, model, distance)
        torch.cuda.synchronize()
        assert k.shape == (m, n) and k.dtype == dtype and k.is_contiguous()
        assert bool(torch.isfinite(k).all())
        sill = model.psill + model.nugget
        assert _rel(k, p, sill) <= TILE_RTOL[dtype], (m, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_self_tile_diagonal(dtype):
    """K's diagonal: haversine self-pairs keep d = 2R asin_poly(0) > 0,
    exactly as the plain twin does (the Matern d == 0 branch stays off)."""
    la, lo, _, _ = _coords(300, 1, dtype)
    model = MaternVariogram(psill=1.2, nugget=0.1, range=1500.0, nu=0.5)
    at_zero = torch.tensor(model.psill + model.nugget, dtype=dtype) - (
        torch.tensor(model.nugget, dtype=dtype)
    )
    for distance, branch_fires in (("haversine", False), ("cartesian", True)):
        k = tpair.pairwise_covariance(la, lo, la, lo, model, distance)
        p = tpair.pairwise_covariance_torch(la, lo, la, lo, model, distance)
        diag = torch.diagonal(k).cpu()
        sill = model.psill + model.nugget
        assert _rel(diag, torch.diagonal(p).cpu(), sill) <= TILE_RTOL[dtype]
        assert bool((diag == at_zero).all()) == branch_fires


def test_kriging_uses_the_kernel_only(monkeypatch):
    """On CUDA tensors every tile comes from the kernel: the plain twin
    must not be called, and the launch count is one per tile."""

    def forbidden(*args, **kwargs):
        raise AssertionError("plain twin called on the CUDA path")

    monkeypatch.setattr(tpair, "pairwise_covariance_torch", forbidden)
    g = np.random.default_rng(1)
    lat = np.repeat(np.arange(-87.5, 90, 5.0), 72)
    lon = np.tile(np.arange(-177.5, 180, 5.0), 36)
    idx = np.sort(g.choice(lat.size, 50, replace=False))
    obs = g.normal(size=50)
    err = np.diag(0.1 + 0.05 * g.random(50))
    kernel = tkk.variogram_kernel(MaternVariogram(psill=1.2, range=1200.0))
    before = tpair.pairwise_covariance.launches
    res = tkk.kriging_from_kernel(kernel, lat, lon, idx, obs, err,
                                  variance=1.2, n_blocks=4, device="cuda")
    torch.cuda.synchronize()
    assert res.field.is_cuda and bool(torch.isfinite(res.field).all())
    n_tiles = 1 + len(tkk._blocks(lat.size, 4))
    assert tpair.pairwise_covariance.launches - before == n_tiles
    monkeypatch.undo()
    cpu = tkk.kriging_from_kernel(kernel, lat, lon, idx, obs, err,
                                  variance=1.2, n_blocks=4)
    for a, b in zip(res, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_wrapper_raises_on_unsupported_order():
    c = _coords(4, 4, torch.float64)
    with pytest.raises(NotImplementedError):
        tpair.pairwise_covariance(*c, MaternVariogram(range=1.0, nu=4.5))
