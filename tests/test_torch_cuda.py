"""The CUDA kernels on the card, against their plain PyTorch twins: the
stationary tile (K1) and the ellipse kernels K2, K3 and K4.

Opt-in: needs an NVIDIA Hopper GPU, nvcc and ``GLOMAR_CUDA_TESTS=1``.
Run from the repository root:

    GLOMAR_CUDA_TESTS=1 python -m pytest tests/test_torch_cuda.py -q

The first test builds the kernel from ``glomargridding_tpu_torch/ops/
cuda/csrc`` (seconds). Tolerance, as max |kernel - plain| / variance:
f64 1e-12; f32 1e-5 (the f32 A&S asin carries ~1 ulp of pi/2 of
absolute error at every distance, and the kernel's FMA contraction moves
a few roundings; see chip_smoke.py). The ellipse kernels, as max
|kernel - plain| / max |plain|: f64 1e-12, f32 1e-5; K3 (f32, atomics in
no fixed order) 1e-5 against its twin and 1e-4 against the dense f64
product. K2 == K4 and C == C' are pinned bit for bit.
"""

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest
import test_torch_device as device_cases
import torch

from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.models.ellipse import covariance as tcov
from glomargridding_tpu_torch.ops.cuda import build
from glomargridding_tpu_torch.ops.cuda import ellipse as tell
from glomargridding_tpu_torch.ops.cuda import pairwise as tpair
from glomargridding_tpu_torch.ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
)
from glomargridding_tpu_torch.utils.profiling import COUNTS

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


# K1's shapes on the kriging path: the 64.8k call's C_cross tiles (5,000 x
# 4,096 and its last 5,000 x 3,360), the 259.2k call's last (5,000 x
# 1,152), K (5,000 x 5,000, rows = columns); n % 4 != 0 (scalar stores);
# m not a multiple of the row tile (64 in f32, 32 in f64); one pair
K1_SHAPES = [(5000, 4096), (5000, 3360), (5000, 1152), (5000, "K"),
             (5000, 4133), (65, 130), (33, 62), (1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("distance", ["haversine", "chordal", "cartesian"])
@pytest.mark.parametrize(
    "model", MODELS,
    ids=lambda v: f"{v.kind}-{getattr(v, 'nu', '')}-{getattr(v, 'method', '')}",
)
def test_tile_kriging_shapes(model, distance, dtype):
    """K1 at the kriging's real tile shapes and the ragged edges of its
    persistent walk, against its twin; K's self-pairs keep d > 0 under
    haversine (the diagonal equals the twin's)."""
    sill = model.psill + model.nugget
    for m, n in K1_SHAPES:
        la1, lo1, la2, lo2 = _coords(m, 1 if n == "K" else n, dtype, seed=m)
        if n == "K":
            la2, lo2 = la1, lo1
        k = tpair.pairwise_covariance(la1, lo1, la2, lo2, model, distance)
        p = tpair.pairwise_covariance_torch(la1, lo1, la2, lo2, model,
                                            distance)
        torch.cuda.synchronize()
        assert k.shape == p.shape and bool(torch.isfinite(k).all()), (m, n)
        assert _rel(k, p, sill) <= TILE_RTOL[dtype], (m, n)
        if n == "K":
            assert _rel(torch.diagonal(k), torch.diagonal(p), sill) <= \
                TILE_RTOL[dtype]
        del k, p


@pytest.mark.parametrize("source", ["ellipse_tile", "pairwise_tile"])
def test_branch_free_sqrt_is_fsqrt_rn(source, tmp_path):
    """The kernels' square root without a slow-path branch gives
    __fsqrt_rn's bits for every one of the 2^32 floats (tests/cuda/
    sqrt_check.cu includes the kernel source whole)."""
    flags = build.NVCC_FLAGS + (
        ("-DCHECK_PAIRWISE",) if source == "pairwise_tile" else ())
    target = tmp_path / f"libsqrt_check_{source}.so"
    build.compile_library(Path(__file__).parent / "cuda" / "sqrt_check.cu",
                          target, flags=flags)
    lib = ctypes.CDLL(str(target))
    lib.sqrt_check.argtypes = [ctypes.c_void_p]
    lib.sqrt_check.restype = ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert lib.sqrt_check(mismatches.data_ptr()) == 0
    torch.cuda.synchronize()
    assert mismatches.item() == 0


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
    before = COUNTS["k1.launches"]
    res = tkk.kriging_from_kernel(kernel, lat, lon, idx, obs, err,
                                  variance=1.2, n_blocks=4, device="cuda")
    torch.cuda.synchronize()
    assert res.field.is_cuda and bool(torch.isfinite(res.field).all())
    n_tiles = 1 + len(tkk._blocks(lat.size, 4))
    assert COUNTS["k1.launches"] - before == n_tiles
    monkeypatch.undo()
    cpu = tkk.kriging_from_kernel(kernel, lat, lon, idx, obs, err,
                                  variance=1.2, n_blocks=4, device="cpu")
    for a, b in zip(res, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tri_colsq_on_the_card(dtype):
    """L^-1's row panels on cuBLAS (1,300 observations: panels of 512,
    512 and 276 rows, strided views of L^-1 written in place) give the
    dense product's column sums of squares in f64: to 1e-12 in f64, to
    1e-5 in true f32 (TF32 would read ~1e-3)."""
    n = 1300
    assert tkk._TRI_PANEL_ROWS < n
    g = torch.Generator().manual_seed(4)
    A = torch.randn((n, n), generator=g, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.T / n + torch.eye(n, dtype=A.dtype))
    Linv = torch.linalg.solve_triangular(L, torch.eye(n, dtype=A.dtype),
                                         upper=False)
    Cc = torch.randn((n, 640), generator=g, dtype=torch.float64)
    want = torch.sum((Linv @ Cc) ** 2, 0)
    got = tkk._tri_colsq(Linv.to("cuda", dtype), Cc.to("cuda", dtype),
                         tkk._TRI_PANEL_ROWS)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_cuda
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.double().cpu().numpy(), want.numpy(),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("nu", [1.0, 4.5])
def test_other_orders_take_the_plain_tile(nu):
    """A Matern order K1 has no template for takes the plain tile on the
    card, chosen from nu: no launch, one plain tile counted, the CPU
    tile's values."""
    c = _coords(63, 129, torch.float64)
    vario = MaternVariogram(psill=1.2, nugget=0.1, range=1500.0, nu=nu)
    launches, plain = COUNTS["k1.launches"], COUNTS["k1.plain_tiles"]
    out = tpair.pairwise_covariance(*c, vario)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] == launches
    assert COUNTS["k1.plain_tiles"] == plain + 1
    cpu = tpair.pairwise_covariance(*(a.cpu() for a in c), vario)
    assert out.is_cuda
    assert _rel(out.cpu(), cpu, 1.3) <= 1e-12


def test_kernel_matvec_launches_k1_per_block():
    """``kernel_matvec`` of a half-integer kernel: one K1 launch per row
    block and application, the CPU twin's values."""
    from glomargridding_tpu_torch.ops.sampling import kernel_matvec

    g = np.random.default_rng(2)
    la = np.radians(g.uniform(-80, 80, 1000))
    lo = np.radians(g.uniform(-180, 180, 1000))
    v = g.normal(size=(1000, 5))
    kernel = tkk.variogram_kernel(MaternVariogram(psill=1.2, range=1200.0))
    before = COUNTS["k1.launches"]
    y = kernel_matvec(kernel, la, lo, n_blocks=7)(v)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] - before == 7
    cpu = kernel_matvec(kernel, la, lo, n_blocks=7, device="cpu")(v)
    assert y.is_cuda
    assert _rel(y.cpu(), cpu, cpu.abs().max().item()) <= 1e-12


# ---------------------------------------------------------------------------
# ellipse kernels K2, K3, K4
# ---------------------------------------------------------------------------
ELLIPSE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _points(n, dtype, seed=0, device="cuda"):
    """Lat-sorted points with heterogeneous ellipses, packed (n, 8)."""
    g = np.random.default_rng(seed)
    lats = np.sort(g.uniform(-70, 70, n))
    lons = g.uniform(-180, 180, n)
    Lx, Ly = g.uniform(800, 2000, n), g.uniform(400, 900, n)
    th, sd = g.uniform(-np.pi, np.pi, n), g.uniform(0.5, 1.5, n)
    ct, st = np.cos(th), np.sin(th)
    s00 = ct * ct * Lx * Lx + st * st * Ly * Ly
    s01 = ct * st * (Lx * Lx - Ly * Ly)
    s11 = st * st * Lx * Lx + ct * ct * Ly * Ly
    cols = (np.radians(lats), np.radians(lons),
            np.stack([s00, s01, s11], -1), np.sqrt(s00 * s11 - s01 * s01),
            sd)
    return tell.pack_points(
        *(torch.as_tensor(a, dtype=dtype, device=device) for a in cols))


def _rel_max(k, p):
    return (torch.max(torch.abs(k - p)) / torch.max(torch.abs(p))).item()


def _ellipse_launches():
    """(K4, K2, K3) launches so far."""
    return tuple(COUNTS[k] for k in ("k4.launches", "k2.launches",
                                     "k3.launches"))


ELLIPSE_CASES = [
    (nu, method, md)
    for nu in (0.5, 1.5, 2.5, 3.5)
    for method in tell.DELTA_X_METHODS
    for md in (None, 3000.0)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu,method,max_dist", ELLIPSE_CASES)
def test_ellipse_tile_and_sym_match_plain(nu, method, max_dist, dtype):
    """K4 (rectangular, ragged) and K2 against their twins; K2 == K4 and
    K2 == K2' bit for bit."""
    args = (nu, method, max_dist)
    rows, cols = _points(200, dtype, 1), _points(333, dtype, 2)
    k4 = tell.ellipse_tile(rows, cols, *args)
    assert k4.shape == (200, 333) and k4.dtype == dtype
    assert _rel_max(k4, tell.ellipse_tile_torch(rows, cols, *args)) <= \
        ELLIPSE_RTOL[dtype]
    for n in (64, 130, 257):
        P = _points(n, dtype, n)
        k2 = tell.ellipse_sym(P, *args)
        full = tell.ellipse_tile(P, P, *args)
        full.diagonal().add_(P[:, 6] * P[:, 6])
        torch.cuda.synchronize()
        assert torch.equal(k2, full) and torch.equal(k2, k2.T), n
        assert _rel_max(k2, tell.ellipse_sym_torch(P, *args)) <= \
            ELLIPSE_RTOL[dtype]


@pytest.mark.parametrize("max_dist", [None, 3000.0])
def test_ellipse_sym_bf16_store(max_dist):
    """The bf16 store is the f32 tile rounded once; keep_pad pads the
    ragged edge with exact zeros."""
    P = _points(300, torch.float32)
    kw = dict(max_dist=max_dist, add_diag=False, keep_pad=True)
    b16 = tell.ellipse_sym(P, 1.5, out_dtype=torch.bfloat16, **kw)
    f32 = tell.ellipse_sym(P, 1.5, **kw)
    assert b16.shape == (320, 320) and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    assert not bool(f32[300:].any()) and not bool(f32[:, 300:].any())
    assert not bool(torch.diagonal(f32).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_dist", [None, 3000.0])
@pytest.mark.parametrize("nu", [0.5, 1.5])
@pytest.mark.parametrize("n", [4099, 16421])
def test_ellipse_sym_persistent_walk(n, nu, max_dist, dtype):
    """K2 where its persistent walk takes many steps over ragged tiles
    (n not a multiple of its 128 (64) tile or of 4): K2 == K4 and K2 ==
    K2' bit for bit, keep_pad's zero padding, and the bf16 store equal to
    the f32 tile rounded once."""
    P = _points(n, dtype, n + 1)
    args = (nu, "Modified_Met_Office", max_dist)
    k2 = tell.ellipse_sym(P, *args)
    full = tell.ellipse_tile(P, P, *args)
    full.diagonal().add_(P[:, 6] * P[:, 6])
    torch.cuda.synchronize()
    assert torch.equal(k2, full)
    del full
    assert torch.equal(k2, k2.T)
    padded = tell.ellipse_sym(P, *args, keep_pad=True)
    n_pad = -(-n // tell.TILE) * tell.TILE
    assert padded.shape == (n_pad, n_pad)
    assert torch.equal(padded[:n, :n], k2)
    assert not bool(padded[n:].any()) and not bool(padded[:, n:].any())
    del k2
    if dtype == torch.float32:
        kw = dict(add_diag=False, keep_pad=True)
        b16 = tell.ellipse_sym(P, *args, out_dtype=torch.bfloat16, **kw)
        f32 = tell.ellipse_sym(P, *args, **kw)
        assert torch.equal(b16, f32.to(torch.bfloat16))
        assert torch.equal(f32[:n, :n] + torch.diag(P[:, 6] * P[:, 6]),
                           padded[:n, :n])


@pytest.mark.parametrize("nu,method,max_dist", ELLIPSE_CASES)
def test_ellipse_matvec_matches_plain_and_dense(nu, method, max_dist):
    n = 1300
    P = _points(n, torch.float32)
    x = torch.randn(n, 5, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    lat = np.asarray(P[:, 0].cpu(), np.float64)
    hi = None if max_dist is None else tcov._stream_band_plan(
        lat, lat, n, n, max_dist, tell.TILE, tell.TILE)[2]
    args = (nu, method, max_dist)
    y = tell.ellipse_matvec(P, x, hi, *args)
    assert y.shape == (n, 5) and y.dtype == torch.float32
    assert _rel_max(y, tell.ellipse_matvec_torch(P, x, hi, *args)) <= 1e-5
    dense = tell.ellipse_sym(P.double(), *args)
    got = y.double() + (P[:, 6] ** 2).double()[:, None] * x.double()
    assert _rel_max(got, dense @ x.double()) <= 1e-4


def test_ellipse_kernels_refuse_other_orders():
    P = _points(70, torch.float32)
    before = _ellipse_launches()
    for call in (
        lambda: tell.ellipse_tile(P, P, 1.2),
        lambda: tell.ellipse_sym(P, 4.5),
        lambda: tell.ellipse_matvec(P, torch.zeros_like(P[:, :2]), v=2.0),
    ):
        with pytest.raises(ValueError, match="half-integer"):
            call()
    assert before == _ellipse_launches()


def test_ellipse_launch_counts_and_cpu_tensors(monkeypatch):
    """One launch per wrapper call on the card; a CPU tensor never
    launches; the stream operator's paths go through K3 and K4 only."""
    P = _points(400, torch.float32)
    counts = _ellipse_launches
    before = counts()
    tell.ellipse_tile(P, P, 0.5)
    tell.ellipse_sym(P, 0.5)
    tell.ellipse_matvec(P, torch.ones_like(P[:, :3]), None, v=0.5)
    assert counts() == tuple(b + 1 for b in before)
    cpu = P.cpu()
    tell.ellipse_tile(cpu, cpu, 0.5)
    tell.ellipse_sym(cpu, 0.5)
    tell.ellipse_matvec(cpu, torch.ones_like(cpu[:, :3]), None, v=0.5)
    assert counts() == tuple(b + 1 for b in before)

    def forbidden(*args, **kwargs):
        raise AssertionError("plain twin called on the CUDA path")

    monkeypatch.setattr(tell, "ellipse_tile_torch", forbidden)
    monkeypatch.setattr(tell, "ellipse_matvec_torch", forbidden)
    monkeypatch.setattr(tell, "ellipse_sym_torch", forbidden)
    args = (P[:, 0], P[:, 1], P[:, 2:5], P[:, 5], P[:, 6])
    mv, n, _ = tcov.ellipse_covariance_operator(
        *args, v=1.5, store="stream", max_dist=3000.0)
    before = counts()
    narrow = mv(torch.ones((n, 4), device="cuda"))
    wide = mv(torch.ones((n, 12), device="cuda"))
    torch.cuda.synchronize()
    after = counts()
    assert after[2] == before[2] + 1 and after[0] > before[0]
    assert narrow.is_cuda and wide.is_cuda
    assert _rel_max(narrow, wide[:, :4]) <= 1e-5
    cov = tcov.build_ellipse_covariance(*args, v=1.5, max_dist=3000.0)
    assert cov.is_cuda and counts()[1] == after[1] + 1


# ---------------------------------------------------------------------------
# K4 and K3 at ragged shapes; the entry points' default device
# ---------------------------------------------------------------------------
# (m, n): one row; sides that are not multiples of K4's tile (64 x 128 in
# f32, 32 x 64 in f64); n % 4 != 0 (no 16-byte stores); all of them fewer
# tiles than the card has SMs, and one shape with many more
K4_SHAPES = [(1, 1), (1, 333), (65, 129), (200, 333), (130, 4097),
             (127, 260), (64, 128), (1500, 2100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_dist", [None, 3000.0])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=str)
def test_k4_ragged_shapes(shape, max_dist, dtype):
    """K4 against its twin at ragged shapes, and into an output view that
    is not 16-byte aligned; K4 == K4' bit for bit on square calls."""
    m, n = shape
    args = (1.5, "Modified_Met_Office", max_dist)
    rows, cols = _points(m, dtype, 3), _points(n, dtype, 4)
    k4 = tell.ellipse_tile(rows, cols, *args)
    plain = tell.ellipse_tile_torch(rows, cols, *args)
    torch.cuda.synchronize()
    assert k4.shape == (m, n) and bool(torch.isfinite(k4).all())
    scale = max(torch.max(torch.abs(plain)).item(), 1e-300)
    assert torch.max(torch.abs(k4 - plain)).item() / scale <= \
        ELLIPSE_RTOL[dtype]
    ws = torch.full((m * n + 1,), float("nan"), dtype=dtype, device="cuda")
    shifted = ws[1:].view(m, n)
    tell.ellipse_tile(rows, cols, *args, out=shifted)
    assert torch.equal(shifted, k4)
    sq = tell.ellipse_tile(cols, cols, *args)
    assert torch.equal(sq, sq.T)


@pytest.mark.parametrize("width", range(1, 9))
@pytest.mark.parametrize("max_dist", [None, 3000.0])
def test_k3_deep_band_and_widths(width, max_dist):
    """K3 over a band deeper than one block's chunk (MV_DEPTH column
    blocks) at every width 1..8: 1e-5 of max |y| against its twin and
    1e-4 against the dense f64 product."""
    # unbanded, 22 column blocks; at 3,000 km the band of points spread
    # over 140 degrees of latitude needs ~8,000 of them to pass 16 blocks
    n = 64 * (tell.MV_DEPTH + 5) + 37 if max_dist is None else 64 * 125 + 37
    P = _points(n, torch.float32, 9)
    lat = np.asarray(P[:, 0].cpu(), np.float64)
    hi = None if max_dist is None else tcov._stream_band_plan(
        lat, lat, n, n, max_dist, tell.TILE, tell.TILE)[2]
    _, depth = tell.band_limits(hi, n, "cpu")
    assert depth > tell.MV_DEPTH
    x = torch.randn(n, width, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(width))
    args = (1.5, "Modified_Met_Office", max_dist)
    y = tell.ellipse_matvec(P, x, hi, *args)
    assert y.shape == (n, width)
    assert _rel_max(y, tell.ellipse_matvec_torch(P, x, hi, *args)) <= 1e-5
    dense = tell.ellipse_sym(P.double(), *args)
    got = y.double() + (P[:, 6] ** 2).double()[:, None] * x.double()
    assert _rel_max(got, dense @ x.double()) <= 1e-4


@pytest.mark.parametrize("name", sorted(device_cases.CASES))
def test_entry_points_default_to_the_card(rng, name):
    """The device-rule cases of the CPU test, with numpy inputs and no
    device: every output is a CUDA tensor and matches the JAX package to
    the CPU test's bound."""
    port, ref = device_cases.CASES[name](rng)
    outputs = port()
    assert len(outputs) == len(ref), name
    for out, want in zip(outputs, ref):
        assert out.is_cuda, name
        np.testing.assert_allclose(out.cpu().numpy(), np.asarray(want),
                                   **device_cases.tolerance(name))


# ---------------------------------------------------------------------------
# PSD repair, factored kriging and the dense stochastic path on the card
# ---------------------------------------------------------------------------
CLIP = dict(k0=512, max_rank=2048, n_iter=4, rank_multiple=128)


def _smooth_grid(step=4.0):
    """Ellipse inputs (lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) of
    a global grid with smooth parameter fields, f32 on the card: a
    covariance with a decaying spectrum that is not positive definite."""
    lat = np.arange(-90 + step / 2, 90, step)
    lon = np.arange(-180 + step / 2, 180, step)
    la = np.radians(np.repeat(lat, lon.size))
    lo = np.radians(np.tile(lon, lat.size))
    fields = ((1800 + 900 * np.cos(la) ** 2)
              * np.exp(0.2 * np.sin(2 * lo + la)),
              (1200 + 500 * np.cos(la)) * np.exp(0.2 * np.cos(3 * lo)),
              0.4 * np.sin(lo - 2 * la), 0.8 + 0.4 * np.cos(la), la, lo)
    return tcov._ellipse_inputs(*(
        torch.as_tensor(a, dtype=torch.float32, device="cuda")
        for a in fields))


def _factors(n=3000, r=96, m=400, seed=0):
    """A factored covariance on the card (f32) and a month of
    observations with a diagonal error covariance."""
    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD

    g = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.linalg.qr(torch.randn((n, r), generator=g, device="cuda"))[0]
    gains = torch.sort(0.5 + 5 * torch.rand(r, generator=g, device="cuda"),
                       descending=True)[0]
    floor = 0.05 + 0.1 * torch.rand(n, generator=g, device="cuda")
    idx = torch.randperm(n, generator=g, device="cuda")[:m].sort()[0]
    y = torch.randn(m, generator=g, device="cuda")
    e = 0.1 + 0.05 * torch.rand(m, generator=g, device="cuda")
    return LowRankPSD(V, gains, floor), idx, y, e


def test_true_f32_products():
    """The port leaves TF32 off: an f32 product on the card is f32."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((512, 2048), generator=g, device="cuda")
    b = torch.randn((2048, 512), generator=g, device="cuda")
    assert _rel_max(a @ b, a.double() @ b.double()) <= 1e-5


def test_clip_of_the_bf16_operator():
    """K2's bf16 store through the trace-preserving clip: factors on the
    card, the trace kept, Ritz values within the store's noise of the
    f64 spectrum; and on the f32 matrix the partial clip against the
    full one."""
    from glomargridding_tpu_torch.ops import covariance_tools as tct

    args = _smooth_grid()
    before = COUNTS["k2.launches"]
    mv, n, trace = tcov.ellipse_covariance_operator(*args, v=1.5,
                                                    store="bf16")
    psd = tct.explained_variance_clip_lowrank(
        mv, n=n, trace=trace, target_variance_fraction=0.9, **CLIP)
    assert COUNTS["k2.launches"] > before
    assert psd.vectors.is_cuda and psd.vectors.dtype == torch.float32
    assert psd.n == n and psd.rank % 128 == 0
    assert abs(psd.trace() - trace) <= 1e-5 * trace
    assert float(psd.gains.min()) >= 0 and float(psd.floor.min()) > 0
    dense = tell.ellipse_sym(tell.pack_points(*args), 1.5)
    w = torch.linalg.eigvalsh(dense.double()).flip(0)
    r = psd.effective_rank
    ritz = psd.gains[:r].double() + psd.floor[0].double()
    assert float(torch.max(torch.abs(ritz - w[:r])) / w[0]) <= 2e-2
    partial = tct.explained_variance_clip(dense, 0.9, spectrum="partial",
                                          **CLIP)
    full = tct.explained_variance_clip(dense.double(), 0.9, spectrum="full")
    assert partial.is_cuda and partial.dtype == torch.float32
    scale = torch.max(torch.abs(dense)).item()
    assert torch.max(torch.abs(partial - full)).item() <= 1e-3 * scale
    wrong = tct.explained_variance_clip(dense, 0.8, spectrum="partial",
                                        **CLIP)
    assert torch.max(torch.abs(wrong - full)).item() > 1e-3 * scale


def test_factored_kriging_on_the_card():
    """f32 on the card against f64, the Woodbury route against the
    dense-E route, the factors against the dense class (Cholesky branch)
    and the cross-validation against the LOO identity in f64."""
    from glomargridding_tpu_torch.models import kriging as tkrig
    from glomargridding_tpu_torch.models import lowrank as tlr
    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD

    psd, idx, y, e = _factors()
    psd = psd.pad_rank(128)
    res = tlr.lowrank_kriging(psd, idx, y, e)
    assert all(a.is_cuda and a.dtype == torch.float32 for a in res)
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    dense_e = tlr._result(*tlr._lowrank_solve(
        psd.vectors, psd.gains, psd.floor, torch.diag(e), idx, y, 0,
        e_diag=False)[:3])
    before = COUNTS.copy()
    ok = tkrig.OrdinaryKriging(psd.to_dense(), idx, y, torch.diag(e))
    dense = (ok.solve(), ok.get_uncertainty(), ok.constraint_mask())
    assert COUNTS["kriging.solve.lu"] == before["kriging.solve.lu"]
    assert COUNTS["kriging.solve.cholesky"] > before["kriging.solve.cholesky"]
    for other in (tlr.lowrank_kriging(psd64, idx, y, e), dense_e, dense):
        for a, b in zip(res, other):
            assert _rel_max(a.double(), b.double()) <= 1e-3
    gen = torch.Generator(device="cuda").manual_seed(1)
    res_e, members = tlr.lowrank_ensemble_step(psd, idx, y, e, gen, 50)
    assert members.shape == (50, psd.n) and members.is_cuda
    assert bool(torch.isfinite(members).all())
    assert _rel_max(res_e.field, res.field) <= 1e-5
    _check_crossval_on_the_card(tlr.lowrank_crossval(psd, idx, y, e),
                                psd64, idx, y, e)


def _check_crossval_on_the_card(cv, psd64, idx, y, e):
    """The factored cross-validation against the LOO identity in f64."""
    V_o = psd64.vectors[idx]
    K = (V_o * psd64.gains[None, :]) @ V_o.T + torch.diag(
        psd64.floor[idx] + e.double())
    for a, b in zip(cv, tkk._loo_from_K(K, y.double(), 0.0, "ordinary")):
        assert a.is_cuda and _rel_max(a.double(), b) <= 1e-3


def test_stochastic_path_on_the_card():
    """The dense members on the card against the CPU on the same
    normals (f64), against the factored members, and the eigen-repair
    rescue of an indefinite matrix."""
    from glomargridding_tpu_torch.models import lowrank as tlr
    from glomargridding_tpu_torch.models import stochastic as tst
    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD

    psd, idx, y, e = _factors(n=1200, r=48, m=150)
    psd = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                     psd.floor.double())
    C, E = psd.to_dense(), torch.diag(e.double())
    g = torch.Generator(device="cuda").manual_seed(2)
    z_state = torch.randn((6, 1200), dtype=torch.float64, generator=g,
                          device="cuda")
    z_obs = torch.randn((6, 150), dtype=torch.float64, generator=g,
                        device="cuda")
    members, field = tst.batched_ensemble_step(C, E, idx, y.double(), 6,
                                               noise=(z_state, z_obs))
    assert members.is_cuda and field.is_cuda
    on_cpu, _ = tst.batched_ensemble_step(
        C.cpu(), E.cpu(), idx.cpu(), y.double().cpu(), 6,
        noise=(z_state.cpu(), z_obs.cpu()))
    assert _rel_max(members.cpu(), on_cpu) <= 1e-9
    L = torch.linalg.cholesky(C)
    want = tlr.lowrank_members_from_states(
        psd, idx, y, E, z_state @ L.T, z_obs * torch.sqrt(e.double()))
    assert _rel_max(members, want) <= 1e-9
    sk = tst.StochasticKriging(C, idx, y.double(), E)
    member = sk.solve(noise=(z_state[0], z_obs[0]))
    assert _rel_max(member, members[0]) <= 1e-9

    bad = tell.ellipse_sym(tell.pack_points(*_smooth_grid(6.0)), 1.5)
    assert int(tst.draw_factor(bad)[1]) != 0
    draws = tst.mv_normal_draw(torch.zeros(bad.shape[0], device="cuda"),
                               bad, 3, generator=g)
    assert draws.is_cuda and draws.shape == (3, bad.shape[0])
    assert bool(torch.isfinite(draws).all())


# ---------------------------------------------------------------------------
# The sharded paths (parallel/) on four slots of the card
# ---------------------------------------------------------------------------
def _card_mesh(n_grid=4, n_ens=1):
    from glomargridding_tpu_torch import parallel as tpar

    return tpar.make_mesh(n_grid=n_grid, n_ens=n_ens,
                          devices=["cuda"] * (n_grid * n_ens))


def test_sharded_paths_launch_the_kernels(monkeypatch):
    """Each sharded path goes through its kernels and never through the
    plain ellipse tile: K1 in the sharded kernel kriging, K4 in the
    sharded row blocks, K3 and K4 in the ring-SUMMA stream; each against
    its single-device counterpart (f32: 1e-5 of the output's scale; the
    row blocks against K2's matrix: 1e-6 of max |C|)."""
    from glomargridding_tpu_torch import parallel as tpar

    def refuse(*a, **k):
        raise AssertionError("the plain ellipse tile ran on the card")

    monkeypatch.setattr(tcov, "ellipse_tile_torch", refuse)
    mesh = _card_mesh()
    rng = np.random.default_rng(3)
    lat = np.repeat(np.arange(-86.0, 90.0, 4.0), 90)  # 44 x 90 cells
    lon = np.tile(np.arange(-178.0, 180.0, 4.0), 44)
    idx = np.sort(rng.choice(lat.size, 300, replace=False))
    obs, err = rng.normal(size=300), np.diag(0.1 + 0.05 * rng.random(300))
    kernel = tkk.variogram_kernel(MaternVariogram(psill=1.2, range=1500.0,
                                                  nu=0.5))
    args = (kernel, lat.astype(np.float32), lon.astype(np.float32), idx,
            obs.astype(np.float32), err.astype(np.float32))
    before = COUNTS["k1.launches"]
    sharded = tpar.sharded_kriging_from_kernel(mesh, *args, variance=1.2)
    assert COUNTS["k1.launches"] > before
    single = tkk.kriging_from_kernel(*args, variance=1.2)
    assert _rel_max(sharded[0].gather(), single.field) <= 1e-5

    n = lat.size  # 3,960
    fields = (rng.uniform(800, 2000, n), rng.uniform(400, 900, n),
              rng.uniform(-1, 1, n), rng.uniform(0.5, 1.5, n), lat, lon)
    fields = tuple(a.astype(np.float32) for a in fields)
    before = COUNTS["k4.launches"]
    cov = tpar.sharded_ellipse_covariance(mesh, *fields, v=1.5,
                                          max_dist=3000.0)
    assert COUNTS["k4.launches"] - before == 4
    P = tell.pack_points(*tcov._ellipse_inputs(*(
        torch.as_tensor(a, device="cuda") for a in fields[:4]),
        torch.deg2rad(torch.as_tensor(lat, dtype=torch.float32,
                                      device="cuda")),
        torch.deg2rad(torch.as_tensor(lon, dtype=torch.float32,
                                      device="cuda"))))
    dense = tell.ellipse_sym(P, 1.5, max_dist=3000.0)
    assert torch.max(torch.abs(cov.gather() - dense)).item() <= (
        1e-6 * torch.max(torch.abs(dense)).item())

    mv, _, _ = tpar.sharded_ellipse_stream_operator(mesh, *fields, v=1.5,
                                                    max_dist=3000.0)
    ref, _, _ = tcov.ellipse_covariance_operator(
        *tcov._ellipse_inputs(*(torch.as_tensor(a, device="cuda")
                                for a in fields[:4]), P[:, 0], P[:, 1]),
        v=1.5, max_dist=3000.0, store="stream")
    for k, counter in ((8, "k3.launches"), (40, "k4.launches")):
        x = torch.randn((n, k), device="cuda")
        before = COUNTS[counter]
        y = mv(x)
        assert COUNTS[counter] > before
        assert _rel_max(y, ref(x)) <= 1e-5


def test_sharded_factor_and_ensembles_on_the_card():
    """f64 on a 2 x 2 mesh of the card: the blocked Cholesky against
    ``torch.linalg`` (1e-10), the ensemble step and the factored ensemble
    against their single-device paths on the same normals (1e-9)."""
    from glomargridding_tpu_torch import parallel as tpar
    from glomargridding_tpu_torch.models import lowrank as tlr
    from glomargridding_tpu_torch.models import stochastic as tst
    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD

    psd, idx, y, e = _factors(n=1200, r=48, m=150)
    psd = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                     psd.floor.double())
    C, E, y = psd.to_dense(), torch.diag(e.double()), y.double()
    mesh = _card_mesh(2, 2)
    L = tpar.sharded_cholesky(mesh, C, n_blocks=8)
    assert _rel_max(L.gather(), torch.linalg.cholesky(C)) <= 1e-10
    g = torch.Generator(device="cuda").manual_seed(4)
    z = (torch.randn((6, 1200), dtype=torch.float64, generator=g,
                     device="cuda"),
         torch.randn((6, 150), dtype=torch.float64, generator=g,
                     device="cuda"))
    members, field, _ = tpar.ensemble_kriging_step(mesh, C, E, idx, y, 6,
                                                   noise=z)
    want, want_field = tst.batched_ensemble_step(C, E, idx, y, 6, noise=z)
    assert members.parts[0].is_cuda
    assert _rel_max(members.gather(), want) <= 1e-9
    assert _rel_max(field.gather(), want_field) <= 1e-9
    noise = tuple(torch.randn(s, dtype=torch.float64, generator=g,
                              device="cuda")
                  for s in ((1200, 6), (48, 6), (150, 6)))
    res, mem = tpar.sharded_lowrank_ensemble_step(mesh, psd, idx, y, e, None,
                                                  6, noise=noise)
    res_l, mem_l = tlr.lowrank_ensemble_step(psd, idx, y, e, None, 6,
                                             noise=noise)
    assert _rel_max(mem.gather(), mem_l) <= 1e-9
    assert _rel_max(res.field.gather(), res_l.field) <= 1e-9


# ---------------------------------------------------------------------------
# the 0.5-degree example's twin, stage by stage, on a 5-degree grid
# ---------------------------------------------------------------------------
def _quarter_degree_fit_on_the_card(tq, tmp_path, gen):
    """The quarter-degree twin's cube (against the CPU's on the same
    normals) and whole-grid fit (its checkpoint resumed): the fields."""
    lat, lon, glat, _ = tq.axes()
    sampler = tq.training_sampler(lat, lon)
    assert sampler.device.type == "cuda"
    noise = tq.cube_noise(sampler, gen)
    cube = tq.training_cube(sampler, noise)
    cpu = tq.training_cube(tq.training_sampler(lat, lon, device="cpu"),
                           [z.cpu() for z in noise])
    assert cube.is_cuda and _rel_max(cube.cpu(), cpu) <= 1e-4
    builder = tq.correlation(cube, lat, lon)
    ckpt = str(tmp_path / "fit.npz")
    params = tq.fit_ellipses(builder, checkpoint=ckpt)
    resumed = tq.fit_ellipses(builder, checkpoint=ckpt)
    for k in ("Lx", "Ly", "theta", "qc_code"):
        np.testing.assert_array_equal(np.asarray(params[k].values),
                                      np.asarray(resumed[k].values))
    fields, n_fit = tq.fitted_fields(params)
    assert n_fit >= 0.9 * glat.size
    return fields


def test_quarter_degree_stages_on_the_card(tmp_path, monkeypatch):
    """examples/torch_nonstationary_quarter_degree.py's stage functions on
    the card at 2,592 cells (the clip's k0 cut to 512, under n): the cube
    against the CPU's on the same normals, the whole-grid fit, its
    checkpoint resumed, the stream (K3 and K4) against the CPU's, the
    clip and the factored kriging against f64 factors."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import torch_nonstationary_quarter_degree as tq

    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD
    from glomargridding_tpu_torch.models import lowrank as tlr

    for name, value in dict(M_LAT=36, M_LON=72, N_OBS=300, N_MEMBERS=20,
                            CHUNK_SIZE=1024).items():
        monkeypatch.setattr(tq, name, value)
    monkeypatch.setitem(tq.CLIP_KW, "k0", 512)
    _, _, glat, glon = tq.axes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fields = _quarter_degree_fit_on_the_card(tq, tmp_path, gen)
    before = COUNTS.copy()
    mv, n, trace = tq.stream_operator(glat, glon, fields, 3000.0)
    mv_cpu, _, _ = tq.stream_operator(glat, glon, fields, 3000.0, "cpu")
    x = torch.randn((n, 9), generator=gen, device="cuda")
    for cols in (slice(0, 8), slice(0, 9)):
        assert _rel_max(mv(x[:, cols]).cpu(), mv_cpu(x[:, cols].cpu())) <= \
            1e-5
    psd, rank = tq.psd_repair(mv, n, trace, generator=gen)
    assert COUNTS["k3.launches"] > before["k3.launches"]
    assert COUNTS["k4.launches"] > before["k4.launches"]
    assert psd.vectors.is_cuda and psd.rank % tq.PAD_RANK == 0
    assert abs(psd.trace() - trace) <= 1e-5 * trace
    idx, truth, y, E = tq.observations(psd, gen)
    res, members = tq.ensemble(psd, idx, y, E, gen)
    assert members.shape == (20, n) and members.is_cuda
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    ref = tlr.lowrank_kriging(psd64, idx, y.double(), E.double())
    for a, b in zip(res[:2], ref[:2]):
        assert _rel_max(a.double(), b) <= 1e-3
