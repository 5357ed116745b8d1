"""The non-stationary (ellipse) covariance slice of the port against the
JAX package, on the same numpy inputs (CPU).

Here every tensor lies on the CPU, so the kernels' wrappers take their
plain twins; the CUDA kernels themselves run in tests/test_torch_cuda.py.
Tolerances:
- kernel twins against the Pallas kernels in interpret mode, f32: the
  JAX tests' own bounds, rtol 2e-4, atol 1e-5;
- ``ellipse_covariance_block`` and the builder against the jnp path, f64:
  rtol 1e-10 (same formula; the kernel orders' closed form and the
  reference's K_nu / Gamma form differ by rounding only);
- the matvec operators, f32: the JAX operator tests' bounds (stream
  2e-4, bf16 store 2e-2 of max |y|), against the dense product.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models.ellipse import covariance as jcov
from glomargridding_tpu.ops import distances as jdist
from glomargridding_tpu.ops.pallas import (
    ellipse_covariance_pallas,
    ellipse_covariance_pallas_sym,
    ellipse_matvec_pallas,
)
from glomargridding_tpu.ops.pallas.pairwise import TILE_P
from glomargridding_tpu_torch.convert import ellipse_builder_from_inputs
from glomargridding_tpu_torch.models.ellipse import covariance as tcov
from glomargridding_tpu_torch.models.ellipse import estimate as testimate
from glomargridding_tpu_torch.models.ellipse.model import EllipseModel
from glomargridding_tpu_torch.ops import distances as tdist
from glomargridding_tpu_torch.ops import variogram as tvario
from glomargridding_tpu_torch.ops.cuda import build
from glomargridding_tpu_torch.ops.cuda import ellipse as tell
from glomargridding_tpu_torch.ops.cuda import ellipse_nll
from glomargridding_tpu_torch.ops.cuda import pairwise as tpair
from glomargridding_tpu_torch.ops.special import HALF_INTEGER_ORDERS
from glomargridding_tpu_torch.utils.profiling import COUNTS

torch.set_num_threads(2)

METHODS = ["Modified_Met_Office", "Met_Office"]
NUS = [0.5, 1.5, 2.5, 3.5]
F32 = {"rtol": 2e-4, "atol": 1e-5}
F64 = {"rtol": 1e-10, "atol": 1e-14}


def _fields(rng, n, lat=60.0, dtype=np.float32):
    """lat-sorted points with heterogeneous ellipses (the JAX tests'
    ``_ellipse_inputs``), as numpy."""
    return {
        "lats": np.sort(rng.uniform(-lat, lat, n)).astype(dtype),
        "lons": rng.uniform(-180, 180, n).astype(dtype),
        "Lx": rng.uniform(800, 2000, n).astype(dtype),
        "Ly": rng.uniform(400, 800, n).astype(dtype),
        "theta": rng.uniform(-np.pi, np.pi, n).astype(dtype),
        "stdev": rng.uniform(0.5, 1.5, n).astype(dtype),
    }


def _jax_args(f):
    """(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) through the JAX
    package's geometry, so both sides start from the same values."""
    s00, s01, _, s11 = jdist.sigma_rot_flat(
        jnp.asarray(f["Lx"]), jnp.asarray(f["Ly"]), jnp.asarray(f["theta"])
    )
    return (
        jnp.radians(jnp.asarray(f["lats"])),
        jnp.radians(jnp.asarray(f["lons"])),
        jnp.stack([s00, s01, s11], axis=-1),
        jnp.sqrt(s00 * s11 - s01 * s01),
        jnp.asarray(f["stdev"]),
    )


def _torch_args(jargs):
    return tuple(torch.as_tensor(np.array(a)) for a in jargs)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", [None, *METHODS])
def test_displacements(rng, method):
    la1, lo1 = rng.uniform(-80, 80, 9), rng.uniform(-180, 180, 9)
    la2, lo2 = rng.uniform(-80, 80, 7), rng.uniform(-180, 180, 7)
    for args in ((la1, lo1), (la1, lo1, la2, lo2)):
        ref = jdist.displacements(*map(jnp.asarray, args),
                                  delta_x_method=method)
        ours = tdist.displacements(*map(torch.as_tensor, args),
                                   delta_x_method=method)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F64)
    with pytest.raises(ValueError, match="delta_x_method"):
        tdist.displacements(torch.zeros(2), torch.zeros(2),
                            delta_x_method="Cylinder")


def test_sigma_geometry(rng):
    Lx, Ly, th = rng.uniform(300, 900, 11), rng.uniform(100, 500, 11), \
        rng.uniform(-3, 3, 11)
    ours = tdist.sigma_rot_flat(*map(torch.as_tensor, (Lx, Ly, th)))
    ref = jdist.sigma_rot_flat(*map(jnp.asarray, (Lx, Ly, th)))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F64)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    np.testing.assert_allclose(_np(tdist.rot_mat(f64(0.7))),
                               np.asarray(jdist.rot_mat(0.7)), **F64)
    for theta in (None, 0.4):
        np.testing.assert_allclose(
            _np(tdist.sigma_rot_func(
                f64(700.0), f64(300.0), None if theta is None else f64(theta))),
            np.asarray(jdist.sigma_rot_func(700.0, 300.0, theta)), **F64,
        )


# ---------------------------------------------------------------------------
# the kernels' plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_dist", [0.0, 3000.0])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("nu", NUS)
def test_k4_twin_matches_pallas(rng, nu, method, max_dist):
    jargs = _jax_args(_fields(rng, 50))
    ref = np.asarray(ellipse_covariance_pallas(
        *jargs, v=nu, delta_x_method=method, max_dist=max_dist))
    ours = _np(tell.ellipse_covariance_cuda(
        *_torch_args(jargs), v=nu, delta_x_method=method,
        max_dist=max_dist))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **F32)


@pytest.mark.parametrize("max_dist", [0.0, 3000.0])
def test_k2_twin_matches_pallas(rng, max_dist):
    """K2's twin against the Pallas K2, and bitwise against K4's twin."""
    jargs = _jax_args(_fields(rng, 70))
    targs = _torch_args(jargs)
    ref = np.asarray(ellipse_covariance_pallas_sym(
        *jargs, v=1.5, max_dist=max_dist))
    ours = _np(tell.ellipse_sym(tell.pack_points(*targs), 1.5,
                                max_dist=max_dist))
    np.testing.assert_allclose(ours, ref, **F32)
    full = _np(tell.ellipse_covariance_cuda(*targs, v=1.5,
                                            max_dist=max_dist))
    assert (ours == full).all() and (ours == ours.T).all()


def test_k2_twin_bf16_store_and_padding(rng):
    """bf16 + add_diag=False + keep_pad: the stored-operator contract.
    The port pads to its own tile (64), with exact zeros."""
    jargs = _jax_args(_fields(rng, 40))
    targs = _torch_args(jargs)
    ref = np.asarray(ellipse_covariance_pallas_sym(
        *jargs, v=1.5, out_dtype=jnp.bfloat16, add_diag=False,
        keep_pad=True).astype(jnp.float32))[:40, :40]
    P = tell.pack_points(*targs)
    b16 = tell.ellipse_sym(P, 1.5, out_dtype=torch.bfloat16, add_diag=False,
                           keep_pad=True)
    f32 = tell.ellipse_sym(P, 1.5, add_diag=False, keep_pad=True)
    assert b16.shape == (tell.TILE, tell.TILE) and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))  # rounded once
    assert (_np(f32[40:]) == 0).all() and (_np(f32[:, 40:]) == 0).all()
    assert (np.diag(_np(f32)) == 0).all()
    ours = _np(b16.float())[:40, :40]
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 8e-3  # bf16 ulp


def test_k3_twin_matches_pallas_and_dense(rng):
    """The fused matvec's twin against the Pallas K3 and the dense f64
    product (the JAX test's 1e-4 bound), banded and unbanded."""
    n = 1300
    f = _fields(rng, n, lat=70.0)
    jargs = _jax_args(f)
    P = tell.pack_points(*_torch_args(jargs))
    X = rng.normal(size=(n, 3)).astype(np.float32)
    n_p = -(-n // TILE_P)
    cpad = n_p * TILE_P - n

    def edge(a):
        return jnp.pad(a, [(0, cpad)] + [(0, 0)] * (a.ndim - 1), mode="edge")

    lat_np = np.asarray(jargs[0], np.float64)
    for max_dist in (None, 2500.0):
        dense = np.asarray(jcov.build_ellipse_covariance(
            *jargs, v=1.5, max_dist=max_dist, use_pallas=False), np.float64)
        want = dense @ X
        diag_x = np.asarray(jargs[4])[:, None] ** 2 * X
        if max_dist is None:
            hi_p, hi = np.full(n_p, n_p - 1, np.int32), None
        else:
            _, _, hi_p = jcov._stream_band_plan(
                np.pad(lat_np, (0, cpad), mode="edge"), lat_np, n, TILE_P,
                max_dist, 256, TILE_P)
            _, _, hi = tcov._stream_band_plan(
                lat_np, lat_np, n, n, max_dist, tell.TILE, tell.TILE)
            assert (hi - np.arange(hi.size)).max() + 1 < hi.size  # banded
        y_ref = np.asarray(ellipse_matvec_pallas(
            *map(edge, jargs), jnp.pad(jnp.asarray(X), ((0, cpad), (0, 0))),
            jnp.asarray(hi_p), v=1.5, max_dist=max_dist or 0.0,
            bwu=int((hi_p - np.arange(n_p)).max() + 1)))[:n]
        y = _np(tell.ellipse_matvec(P, torch.as_tensor(X), hi, v=1.5,
                                    max_dist=max_dist))
        scale = np.abs(want).max()
        assert np.abs(y + diag_x - want).max() / scale < 1e-4, max_dist
        assert np.abs(y - y_ref).max() / scale < 1e-5, max_dist


def test_twins_reject_other_orders():
    P = tell.pack_points(*(torch.zeros(4),) * 2, torch.ones(4, 3),
                         torch.ones(4), torch.ones(4))
    for call in (
        lambda: tell.ellipse_tile(P, P, 1.2),
        lambda: tell.ellipse_sym(P, 4.5),
        lambda: tell.ellipse_matvec(P, torch.zeros(4, 1), None, v=2.0),
    ):
        with pytest.raises(ValueError, match="half-integer"):
            call()
    with pytest.raises(ValueError, match="delta_x_method"):
        tell.ellipse_tile(P, P, 0.5, "Cylinder")


def test_wrappers_reject_bad_arguments():
    P = tell.pack_points(*(torch.zeros(6),) * 2, torch.ones(6, 3),
                         torch.ones(6), torch.ones(6))
    cases = [
        (lambda: tell.ellipse_tile(P[:, :7], P, 0.5), ValueError),
        (lambda: tell.ellipse_tile(P.long(), P.long(), 0.5), TypeError),
        (lambda: tell.ellipse_tile(P, P.double(), 0.5), TypeError),
        (lambda: tell.ellipse_tile(P.numpy(), P, 0.5), TypeError),
        (lambda: tell.ellipse_tile(P.T.contiguous().T, P, 0.5), ValueError),
        (lambda: tell.ellipse_tile(P, P, 0.5, out=torch.empty(6, 5)),
         ValueError),
        (lambda: tell.ellipse_tile(P, P.to("meta"), 0.5), ValueError),
        (lambda: tell.ellipse_sym(P.double(), 0.5,
                                  out_dtype=torch.bfloat16), TypeError),
        (lambda: tell.ellipse_matvec(P.double(), torch.zeros(6, 1)),
         TypeError),
        (lambda: tell.ellipse_matvec(P, torch.zeros(6, 9)), ValueError),
        (lambda: tell.ellipse_matvec(P, torch.zeros(6, 1),
                                     np.array([1])), ValueError),
    ]
    for call, exc in cases:
        with pytest.raises(exc):
            call()


def _refused_unless(predicate, v, dtype, call):
    """call() where ``predicate(v, dtype)``, else its refusal: the order's
    ``ValueError`` or the dtype's ``TypeError``."""
    if predicate(v, dtype):
        return call()
    with pytest.raises(TypeError if v in HALF_INTEGER_ORDERS else ValueError):
        call()


def _k5_refusal(v, dtype):
    """(error, match) of K5 on CPU tensors: its predicate's refusal, else
    the device's."""
    if ellipse_nll.takes(v, 3, dtype):
        return ValueError, "CUDA tensors"
    if v in HALF_INTEGER_ORDERS:
        return TypeError, "float32 or float64"
    return ValueError, "nu in"


def _check_k5(v, dtype):
    """``_k5_takes`` on CUDA and CPU devices and lanes, and K5's refusal
    of CPU tensors after its predicate's."""
    model = EllipseModel(anisotropic=True, rotated=True,
                         physical_distance=True, v=v, unit_sigma=True)
    k5 = ellipse_nll.takes(v, model.n_params, dtype)
    for lane, device, takes in (("nm", "cuda", k5), ("nm", "cpu", False),
                                ("lm", "cuda", False)):
        assert testimate._k5_takes(model, lane, torch.device(device),
                                   dtype) is takes
    stack = [torch.ones(s, dtype=dtype) for s in ((1, 2, 3), (2, 4, 2),
                                                  (2, 4), (2, 4))]
    error, match = _k5_refusal(v, dtype)
    with pytest.raises(error, match=match):
        ellipse_nll.fisher_z_nll(*stack, torch.ones(2, dtype=torch.bool),
                                 v=v, fit_sigma=False)


def _build_and_stream(targs, v):
    """The whole matrix and a wide stream application of the points."""
    tcov.build_ellipse_covariance(*targs, v=v)
    mv, n, _ = tcov.ellipse_covariance_operator(*targs, v=v, store="stream")
    mv(torch.ones(n, tell.MV_W + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("v", [0.5, 1.5, 2.5, 3.5, 1.2, 2.0, 4.5])
def test_dispatch_rule(monkeypatch, rng, v, dtype):
    """Which (nu, dtype, device) each kernel module's predicate accepts,
    and that each wrapper refuses exactly what its predicate rejects:
    K2/K4 (``takes``) and K3 (``matvec_takes``) on CPU points, which run
    their twins (the device does not enter: the card runs the kernels,
    tests/test_torch_cuda.py), and so the build and the stream at a kernel
    order, which never give its points to the plain pair function; K5
    (``ellipse_nll.takes``), which the fit asks only for the Nelder-Mead
    lane on a CUDA device and which refuses CPU tensors after its
    predicate; K1 (``tile_route``) by nu alone."""
    def no_library():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(ellipse_nll, "_library", no_library)
    kernel_order = v in HALF_INTEGER_ORDERS
    assert tell.kernel_order(v) is kernel_order
    assert tell.takes(v, dtype) is (
        kernel_order and dtype in (torch.float32, torch.float64))
    assert tell.matvec_takes(v, dtype) is (
        kernel_order and dtype == torch.float32)
    assert ellipse_nll.takes(v, 3, dtype) is tell.takes(v, dtype)
    assert not ellipse_nll.takes(v, 1, dtype)
    P = tell.pack_points(*(torch.zeros(6),) * 2, torch.ones(6, 3),
                         torch.ones(6), torch.ones(6)).to(dtype)
    x = torch.zeros(6, 1, dtype=dtype)
    for predicate, call in (
        (tell.takes, lambda: tell.ellipse_tile(P, P, v)),
        (tell.takes, lambda: tell.ellipse_sym(P, v)),
        (tell.matvec_takes, lambda: tell.ellipse_matvec(P, x, None, v=v)),
    ):
        _refused_unless(predicate, v, dtype, call)
    if kernel_order:
        targs = [a.to(dtype) for a in _torch_args(_operator_case(rng, 10))]
        _refused_unless(tell.takes, v, dtype,
                        lambda: _build_and_stream(targs, v))
    _check_k5(v, dtype)
    vario = tvario.MaternVariogram(range=1.0, nu=v)
    assert tpair.tile_route(vario) == ("kernel" if kernel_order else "plain")
    if kernel_order:
        tpair.launch_args(vario, "haversine", 1.0, 6371.0)
    else:
        with pytest.raises(NotImplementedError):
            tpair.launch_args(vario, "haversine", 1.0, 6371.0)


def test_cpu_tensors_never_build_or_launch(monkeypatch, rng):
    def no_build(name):
        raise AssertionError("a CPU tensor must not trigger a build")

    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(build, "compile_library", no_build)
    launches = ("k4.launches", "k2.launches", "k3.launches")
    before = [COUNTS[k] for k in launches]
    P = tell.pack_points(*_torch_args(_jax_args(_fields(rng, 20))))
    tell.ellipse_tile(P, P, 0.5)
    tell.ellipse_sym(P, 0.5)
    tell.ellipse_matvec(P, torch.ones(20, 2), None, v=0.5)
    assert before == [COUNTS[k] for k in launches]


def test_import_builds_nothing_and_loads_no_jax():
    code = (
        "import sys\n"
        "import glomargridding_tpu_torch\n"
        "import glomargridding_tpu_torch.convert\n"
        "import glomargridding_tpu_torch.models.kriging\n"
        "import glomargridding_tpu_torch.models.ellipse.covariance\n"
        "from glomargridding_tpu_torch.ops.cuda import ellipse, pairwise\n"
        "assert ellipse._library.cache_info().currsize == 0\n"
        "assert pairwise._library.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'glomargridding_tpu')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the jnp-path block and the builder, f64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_md", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_ellipse_covariance_block_f64(rng, nu, method, use_md):
    a = _jax_args(_fields(rng, 23, dtype=np.float64))
    b = _jax_args(_fields(rng, 17, dtype=np.float64))
    kw = dict(v=nu, delta_x_method=method, max_dist=1500.0,
              use_max_dist=use_md)
    ref = np.asarray(jcov.ellipse_covariance_block(*a, *b, **kw))
    ours = _np(tcov.ellipse_covariance_block(*_torch_args(a),
                                             *_torch_args(b), **kw))
    np.testing.assert_allclose(ours, ref, **F64)


@pytest.mark.parametrize("nu", [1.5, 1.2], ids=["kernel", "general"])
def test_block_cutoff_at_zero(rng, nu):
    """`use_max_dist` with `max_dist` 0 zeroes every pair, as the
    reference's tile does, at a kernel order and at a general one; the
    general-order builder, whose tiles the reference builds the same way
    off the TPU, follows it (K2 reads 0 as no cutoff, as the reference's
    Pallas kernel does)."""
    jargs = _jax_args(_fields(rng, 11, dtype=np.float64))
    a = _torch_args(jargs)
    ours = _np(tcov.ellipse_covariance_block(
        *a, *a, v=nu, max_dist=0.0, use_max_dist=True))
    ref = np.asarray(jcov.ellipse_covariance_block(
        *jargs, *jargs, v=nu, max_dist=0.0, use_max_dist=True))
    np.testing.assert_allclose(ours, ref, **F64)
    assert not ours.any()
    if nu not in HALF_INTEGER_ORDERS:
        inp = _builder_inputs(rng)
        general = ellipse_builder_from_inputs(*inp.values(), v=nu,
                                              max_dist=0.0,
                                              precision=np.float64,
                                              device="cpu").cov_ns
        want = jcov.EllipseCovarianceBuilder(*inp.values(), v=nu,
                                             max_dist=0.0,
                                             precision=np.float64).cov_ns
        np.testing.assert_allclose(_np(general), np.asarray(want), **F64)


def test_block_general_order_not_ported(rng):
    """A general order, which no kernel takes, goes through the jnp-tile
    port with the general-order K_nu: the reference's tile, f64."""
    jargs = _jax_args(_fields(rng, 9, dtype=np.float64))
    a = _torch_args(jargs)
    for use_md in (False, True):
        ours = _np(tcov.ellipse_covariance_block(
            *a, *a, v=1.2, max_dist=1500.0, use_max_dist=use_md))
        ref = np.asarray(jcov.ellipse_covariance_block(
            *jargs, *jargs, v=1.2, max_dist=1500.0, use_max_dist=use_md))
        np.testing.assert_allclose(ours, ref, **F64)


def _builder_inputs(rng, nlat=9, nlon=12, dtype=np.float64):
    lats = np.linspace(-50, 55, nlat)
    lons = np.linspace(-170, 160, nlon)
    mask = rng.random((nlat, nlon)) < 0.25

    def field(lo, hi):
        return np.ma.masked_where(mask, rng.uniform(lo, hi, (nlat, nlon)))

    return dict(Lx=field(800, 2000), Ly=field(400, 900),
                theta=field(-1.0, 1.0), stdev=field(0.5, 1.5),
                lats=lats.astype(dtype), lons=lons.astype(dtype))


@pytest.mark.parametrize(
    "settings",
    [
        dict(v=0.5),
        dict(v=1.5, max_dist=2500.0, delta_x_method="Met_Office"),
        dict(v=2.5, covariance_method="batched", batch_size=17),
        dict(v=1.5, covariance_method="low_memory", use_pallas=False),
    ],
    ids=["auto", "cutoff", "batched", "low_memory"],
)
def test_builder_matches_reference_f64(rng, settings):
    inp = _builder_inputs(rng)
    kw = dict(precision=np.float64, **settings)
    ref = jcov.EllipseCovarianceBuilder(*inp.values(), **kw)
    ours = ellipse_builder_from_inputs(*inp.values(), **kw, device="cpu")
    assert ours.cov_ns.dtype == torch.float64
    assert ours.covar_size == ref.covar_size
    np.testing.assert_allclose(_np(ours.cov_ns), np.asarray(ref.cov_ns),
                               **F64)
    np.testing.assert_array_equal(ours.sigmas, ref.sigmas)
    np.testing.assert_array_equal(ours.sqrt_dets, ref.sqrt_dets)
    ours.calculate_cor()
    ref.calculate_cor()
    np.testing.assert_allclose(_np(ours.cor_ns), ref.cor_ns, **F64)
    ours.uncompress_cov()
    ref.uncompress_cov()
    np.testing.assert_allclose(_np(ours.cov_ns), ref.cov_ns, **F64)


@pytest.mark.parametrize("v", [1.5, 1.2], ids=["kernel", "general"])
def test_builder_routes_agree_bitwise(rng, monkeypatch, v):
    """The builder's matrix is the same bits whatever the reference's
    settings say (they select nothing: K2 at a kernel order, whose match
    with K4's tiles the card tests hold, tests/test_torch_cuda.py), and at
    a general order at two row-block heights (``_tile_rows`` under two
    limits)."""
    inp = _builder_inputs(rng, dtype=np.float32)

    def build(**kw):
        return ellipse_builder_from_inputs(*inp.values(), v=v,
                                           max_dist=3000.0, **kw,
                                           device="cpu")

    ours = build()
    cov = ours.cov_ns
    assert cov.dtype == torch.float32 and torch.equal(cov, cov.T)
    for kw in ({"use_pallas": False},
               {"use_pallas": False, "covariance_method": "batched",
                "batch_size": 13},
               {"covariance_method": "low_memory"}):
        assert torch.equal(build(**kw).cov_ns, cov), kw
    if v in HALF_INTEGER_ORDERS:
        return
    n = ours.covar_size
    pair_bytes = tell.tile_pair_bytes(v, torch.float32)
    assert tcov._tile_rows(n, pair_bytes, tcov._BUILD_LIMIT_BYTES) >= n
    monkeypatch.setattr(tcov, "_BUILD_LIMIT_BYTES", 0)
    assert tcov._tile_rows(n, pair_bytes, 0) == tell.TILE < n  # TILE rows
    assert torch.equal(build().cov_ns, cov)


def test_builder_orders(rng):
    inp = _builder_inputs(rng)
    with pytest.raises(ValueError, match="half-integer"):
        ellipse_builder_from_inputs(*inp.values(), v=1.2, use_pallas=True,
                                    device="cpu")
    # a general order builds by row blocks through the jnp-tile port
    general = ellipse_builder_from_inputs(*inp.values(), v=1.2,
                                          precision=np.float64,
                                          device="cpu").cov_ns
    ref = jcov.EllipseCovarianceBuilder(*inp.values(), v=1.2,
                                        precision=np.float64).cov_ns
    np.testing.assert_allclose(_np(general), np.asarray(ref), **F64)
    with pytest.raises(ValueError, match="delta_x_method"):
        ellipse_builder_from_inputs(*inp.values(), v=0.5,
                                    delta_x_method="Cylinder", device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        ellipse_builder_from_inputs(*inp.values(), v=0.5,
                                    covariance_method="batched", device="cpu")


# ---------------------------------------------------------------------------
# the matvec operators
# ---------------------------------------------------------------------------
def _operator_case(rng, n, lat=60.0):
    f = _fields(rng, n, lat=lat)
    f.update(Lx=rng.uniform(800, 1600, n).astype(np.float32),
             Ly=rng.uniform(400, 900, n).astype(np.float32),
             theta=rng.uniform(-0.6, 0.6, n).astype(np.float32))
    return _jax_args(f)


def test_stream_operator_matches_reference(rng):
    """Unbanded stream: narrow (K3 twin) and wide (K4 twin + GEMM)
    applications against the JAX operator and the dense product."""
    n = 300
    jargs = _operator_case(rng, n)
    dense = np.asarray(jcov.build_ellipse_covariance(
        *jargs, v=1.5, use_pallas=False), np.float64)
    jmv, _, jtrace = jcov.ellipse_covariance_operator(
        *jargs, v=1.5, store="stream", n_blocks=7)
    mv, n_out, trace = tcov.ellipse_covariance_operator(
        *_torch_args(jargs), v=1.5, store="stream", n_blocks=7)
    assert n_out == n and trace == pytest.approx(jtrace, rel=1e-6)
    assert not mv.band_stats["banded"] and mv.band_stats["use_fused"]
    for k in (7, 12):  # narrow (<= 8 columns) and wide
        X = rng.normal(size=(n, k)).astype(np.float32)
        got = _np(mv(torch.as_tensor(X)))
        np.testing.assert_allclose(got, dense @ X, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, np.asarray(jmv(jnp.asarray(X))),
                                   rtol=2e-4, atol=2e-4)
    got1 = _np(mv(torch.as_tensor(X[:, 0])))
    assert got1.shape == (n,)
    np.testing.assert_allclose(got1, dense @ X[:, 0], rtol=2e-4, atol=2e-4)


def test_banded_stream_exact_vs_dense(rng):
    """With max_dist the stream skips the tiles the band plan proves zero:
    narrow and wide applications against the dense masked product, the
    JAX operator, and the port's unbanded stream with the same cutoff."""
    n, max_dist = 1500, 1500.0
    jargs = _operator_case(rng, n, lat=75.0)
    targs = _torch_args(jargs)
    dense = np.asarray(jcov.build_ellipse_covariance(
        *jargs, v=1.5, max_dist=max_dist, use_pallas=False), np.float64)
    jmv, _, _ = jcov.ellipse_covariance_operator(
        *jargs, v=1.5, store="stream", max_dist=max_dist, n_blocks=6)
    mv, _, _ = tcov.ellipse_covariance_operator(
        *targs, v=1.5, store="stream", max_dist=max_dist, n_blocks=6)
    stats = mv.band_stats
    assert stats["banded"] and stats["bw"] < n
    assert stats["wide_pairs"] < n * n
    assert stats["fused_pairs"] < n * n / 2 + n * tell.TILE
    P = tell.pack_points(*targs)
    block = tcov._block_rows(n, 6)
    full = tcov._row_windows(n, block, [0] * -(-n // block), n)
    for k in (5, 12):
        X = rng.normal(size=(n, k)).astype(np.float32)
        got = _np(mv(torch.as_tensor(X)))
        np.testing.assert_allclose(got, dense @ X, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, np.asarray(jmv(jnp.asarray(X))),
                                   rtol=2e-4, atol=2e-4)
    # wide banded == wide unbanded: omitted tiles are exact zeros, and each
    # row block sums its own window
    x = torch.as_tensor(X)
    lat = np.asarray(jargs[0], np.float64)
    lat_pad = np.pad(lat, (0, -(-n // block) * block - n), mode="edge")
    col_starts, bw, _ = tcov._stream_band_plan(
        lat_pad, lat, n, block, max_dist, tell.TILE, tell.TILE)
    banded = tcov._apply_wide(P, x, tcov._row_windows(
        n, block, col_starts, bw), 1.5, "Modified_Met_Office", max_dist)
    unbanded = tcov._apply_wide(P, x, full, 1.5, "Modified_Met_Office",
                                max_dist)
    np.testing.assert_allclose(_np(banded), _np(unbanded), rtol=2e-6,
                               atol=2e-6)


def test_wide_stream_column_chunks(rng, monkeypatch):
    """The column-chunked wide path (forced by shrinking the tile limit)
    matches the single-window path: only the GEMM's summation order
    differs."""
    n = 700
    targs = _torch_args(_operator_case(rng, n, lat=75.0))
    X = torch.as_tensor(rng.normal(size=(n, 10)).astype(np.float32))
    mv, _, _ = tcov.ellipse_covariance_operator(
        *targs, v=1.5, store="stream", max_dist=2500.0, n_blocks=5)
    want = _np(mv(X))
    monkeypatch.setattr(tcov, "_TILE_LIMIT_BYTES", 0)
    monkeypatch.setattr(tcov, "_CHUNK_BYTES", 1)
    np.testing.assert_allclose(_np(mv(X)), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("v", [0.5, 1.5, 1.2])
def test_bf16_operator(rng, v):
    """bf16 store (K2's padded store at a kernel order, row blocks at a
    general one): 2e-2 of max |y| against the dense product, and against
    the JAX bf16 operator."""
    n = 300
    jargs = _operator_case(rng, n)
    dense = np.asarray(jcov.build_ellipse_covariance(
        *jargs, v=v, use_pallas=False), np.float64)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    want = dense @ X
    scale = np.abs(want).max()
    jmv, _, jtrace = jcov.ellipse_covariance_operator(
        *jargs, v=v, store="bf16", n_blocks=7)
    mv, n_out, trace = tcov.ellipse_covariance_operator(
        *_torch_args(jargs), v=v, store="bf16", n_blocks=7)
    assert n_out == n and trace == pytest.approx(jtrace, rel=1e-6)
    got = _np(mv(torch.as_tensor(X)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / scale < 2e-2
    assert np.abs(got - np.asarray(jmv(jnp.asarray(X)))).max() / scale < 2e-2
    np.testing.assert_allclose(_np(mv(torch.as_tensor(X[:, 0]))), got[:, 0],
                               rtol=1e-6, atol=1e-6)


def test_operator_rejects(rng):
    targs = _torch_args(_operator_case(rng, 10))
    with pytest.raises(ValueError, match="half-integer"):
        tcov.ellipse_covariance_operator(*targs, v=1.2, assemble="pallas")
    with pytest.raises(ValueError, match="store"):
        tcov.ellipse_covariance_operator(*targs, v=0.5, store="disk")
    with pytest.raises(ValueError, match="assemble"):
        tcov.ellipse_covariance_operator(*targs, v=0.5, assemble="lu")


def test_band_plan_matches_reference(rng):
    """The band plan is the reference's numpy, at the port's tile sizes."""
    n, block = 6000, 512
    lat = np.sort(rng.uniform(-1.2, 1.2, n))
    lat_pad = np.pad(lat, (0, (-n) % block), mode="edge")
    for chunk, chunk_p in ((256, 512), (tell.TILE, tell.TILE)):
        ours = tcov._stream_band_plan(lat_pad, lat, n, block, 800.0, chunk,
                                      chunk_p)
        ref = jcov._stream_band_plan(lat_pad, lat, n, block, 800.0, chunk,
                                     chunk_p)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    amin = rng.uniform(-85, 85, 23)
    amax = amin + rng.uniform(0, 3, 23)
    b = rng.uniform(-80, 80, 37)
    for bmin in (np.sort(b), b):  # sorted and unsorted column intervals
        bmax = bmin + 1.0
        for a, r in zip(tcov._interval_windows(amin, amax, bmin, bmax, 4.0),
                        jcov._interval_windows(amin, amax, bmin, bmax, 4.0)):
            np.testing.assert_array_equal(a, r)
