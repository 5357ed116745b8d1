"""PyTorch port vs the JAX package: distances, special functions and
variograms, on the same numpy inputs.

Tolerance: rtol 1e-10 in f64 (both sides evaluate the same formula in
the same order); where f32 is compared it is stated per test.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.ops import distances as jdist
from glomargridding_tpu.ops import sampling as jsampling
from glomargridding_tpu.ops import special as jspecial
from glomargridding_tpu.ops import variogram as jvario
from glomargridding_tpu.utils import arrays as jarrays
from glomargridding_tpu.utils import frames as jframes
from glomargridding_tpu_torch import types as ttypes
from glomargridding_tpu_torch import utils as tutils
from glomargridding_tpu_torch.convert import variogram_from_params
from glomargridding_tpu_torch.ops import distances as tdist
from glomargridding_tpu_torch.ops import sampling as tsampling
from glomargridding_tpu_torch.ops import special as tspecial
from glomargridding_tpu_torch.ops import variogram as tvario

torch.set_num_threads(2)

RTOL = 1e-10
HALF_INTEGER_NUS = [0.5, 1.5, 2.5, 3.5]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_asin_poly_matches_reference_f64():
    x = np.concatenate([[0.0, 1.0, 1e-12], np.linspace(0, 1, 1001)])
    ours = tdist.asin_poly(_t(x)).numpy()
    ref = np.asarray(jdist.asin_poly(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=0)


def test_asin_poly_zero_is_not_zero():
    """The value at 0 decides whether a haversine self-pair hits the
    Matern d == 0 branch; it must equal the reference's bit for bit."""
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        ours = tdist.asin_poly(torch.zeros(1, dtype=dtype)).item()
        ref = float(jdist.asin_poly(jnp.zeros(1, jdtype))[0])
        assert ours == ref
        assert ours > 0.0
    # in f32 it is 1.19e-7 rad: a self-pair sits 1.5e-3 km apart
    f32 = tdist.asin_poly(torch.zeros(1, dtype=torch.float32)).item()
    assert 1.1e-7 < f32 < 1.3e-7


def test_asin_poly_f32():
    """f32 against the reference's f32: one ulp near pi/2."""
    x = np.linspace(0, 1, 513).astype(np.float32)
    ours = tdist.asin_poly(_t(x)).numpy()
    ref = np.asarray(jdist.asin_poly(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2.5e-7)


def test_haversine_matrix(rng):
    lat1, lon1 = rng.uniform(-89, 89, 23), rng.uniform(-180, 180, 23)
    lat2, lon2 = rng.uniform(-89, 89, 17), rng.uniform(-180, 180, 17)
    ours = tdist.haversine_matrix(lat1, lon1, lat2, lon2,
                                  device="cpu").numpy()
    ref = np.asarray(jdist.haversine_matrix(lat1, lon1, lat2, lon2))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-9)
    sym = tdist.haversine_matrix(lat1, lon1, device="cpu").numpy()
    np.testing.assert_allclose(
        sym, np.asarray(jdist.haversine_matrix(lat1, lon1)),
        rtol=RTOL, atol=1e-9,
    )


@pytest.mark.parametrize("nu", HALF_INTEGER_NUS)
def test_xv_kv_half_integer(nu):
    x = np.concatenate([[0.0, -1.0, 1e-9], np.geomspace(1e-6, 60.0, 400)])
    ours = tspecial.xv_kv_half_integer(nu, _t(x)).numpy()
    ref = np.asarray(jspecial.xv_kv_half_integer(nu, jnp.asarray(x)))
    assert np.isnan(ours[0]) and np.isnan(ours[1])
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=0)
    # xv_kv dispatches to the same closed form
    np.testing.assert_allclose(
        tspecial.xv_kv(nu, _t(x)).numpy(), ours, rtol=0, atol=0
    )


def test_xv_kv_general_order_not_ported():
    """A general order takes the Temme/Steed K_nu (held against the JAX
    package in test_torch_special.py), NaN at x <= 0; the closed form
    still refuses it."""
    x = torch.tensor([-1.0, 0.0, 0.5, 3.0], dtype=torch.float64)
    out = tspecial.xv_kv(0.7, x).numpy()
    assert np.isnan(out[:2]).all()
    np.testing.assert_allclose(
        out[2:], (x[2:] ** 0.7 * tspecial.kv(0.7, x[2:])).numpy(),
        rtol=1e-15)
    with pytest.raises(ValueError, match="half-integer"):
        tspecial.xv_kv_half_integer(1.0, torch.ones(3))


def test_gamma_fn():
    for v in (0.5, 1.5, 2.5, 3.7):
        assert tspecial.gamma_fn(v) == jspecial.gamma_fn(v)


def _distances(rng):
    d = rng.uniform(0.0, 4000.0, (9, 11))
    d[0, :3] = 0.0  # the Matern d == 0 branch
    d[1, :3] = [1500.0, 1499.999, 1500.001]  # spherical range edge
    return d


FAMILY_CASES = (
    [("spherical", None, None), ("gaussian", None, None),
     ("exponential", None, None)]
    + [("matern", nu, m) for nu in HALF_INTEGER_NUS
       for m in ("sklearn", "gstat", "karspeck")]
)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,nu,method", FAMILY_CASES)
def test_vario_kernel(rng, kind, nu, method, fused):
    d = _distances(rng)
    args = (1.3, 0.2, 1500.0, 1.6)
    ours = tvario._vario_kernel(
        _t(d), *args, kind=kind, nu=nu, method=method, fused=fused
    ).numpy()
    ref = np.asarray(
        jvario._vario_kernel(
            jnp.asarray(d), *args, kind=kind, nu=nu, method=method,
            fused=fused,
        )
    )
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-14)


def test_vario_kernel_rejects_unknown():
    d = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="kind"):
        tvario._vario_kernel(d, 1.0, 0.0, 1.0, 1.0, kind="linear")
    with pytest.raises(ValueError, match="method"):
        tvario._vario_kernel(
            d, 1.0, 0.0, 1.0, 1.0, kind="matern", nu=0.5, method="bogus"
        )


JAX_MODELS = [
    jvario.SphericalVariogram(psill=1.1, nugget=0.1, effective_range=900.0),
    jvario.GaussianVariogram(psill=1.1, nugget=0.1, effective_range=900.0),
    jvario.ExponentialVariogram(psill=1.1, nugget=0.1, effective_range=900.0),
    jvario.MaternVariogram(psill=1.1, nugget=0.1, effective_range=900.0,
                           nu=1.5, method="karspeck"),
    jvario.MaternVariogram(psill=0.9, range=700.0, nu=2.5, method="gstat"),
]


@pytest.mark.parametrize("jmodel", JAX_MODELS, ids=lambda v: v._kind)
def test_variogram_classes(rng, jmodel):
    """The dataclasses resolve ranges as the reference does, and
    fit/covariance keep the container type (ndarray in, ndarray out)."""
    model = variogram_from_params(jmodel._kind, dataclasses.asdict(jmodel))
    assert model.range == jmodel.range
    assert model.effective_range == jmodel.effective_range
    d = _distances(rng)
    fit = model.fit(d)
    assert isinstance(fit, np.ndarray)
    np.testing.assert_allclose(
        fit, np.asarray(jmodel.fit(d)), rtol=RTOL, atol=1e-14
    )
    cov = model.covariance(_t(d))
    assert isinstance(cov, torch.Tensor)
    np.testing.assert_allclose(
        cov.numpy(), np.asarray(jmodel.covariance(d)), rtol=RTOL, atol=1e-14
    )
    np.testing.assert_allclose(
        model.covariance(d, variance=2.0),
        np.asarray(jmodel.covariance(d, variance=2.0)),
        rtol=RTOL, atol=1e-14,
    )
    np.testing.assert_allclose(
        tvario.variogram_to_covariance(fit, 1.2),
        np.asarray(jvario.variogram_to_covariance(np.asarray(fit), 1.2)),
        rtol=RTOL,
    )


def test_variogram_range_required():
    with pytest.raises(ValueError, match="range"):
        tvario.ExponentialVariogram(psill=1.0)
    with pytest.raises(NotImplementedError):
        tvario.Variogram()._kernel(torch.ones(2))


def test_import_does_not_load_jax():
    """The port imports neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import glomargridding_tpu_torch\n"
        "import glomargridding_tpu_torch.convert\n"
        "import glomargridding_tpu_torch.models.kernel_kriging\n"
        "import glomargridding_tpu_torch.ops.cuda.pairwise\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'glomargridding_tpu')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


# --- the rest of ops/distances, the helpers and dense_matvec: f64, 1e-12
TIGHT = dict(rtol=1e-12, atol=1e-12)


def _frame(rng, n=8):
    import pandas as pd

    return pd.DataFrame({"lat": rng.uniform(-80, 80, n),
                         "lon": rng.uniform(-180, 180, n)})


@pytest.mark.parametrize("name", ["euclidean_matrix",
                                  "cartesian_euclidean_matrix"])
@pytest.mark.parametrize("two_sets", [False, True])
def test_distance_matrices_match_reference(name, two_sets):
    rng = np.random.default_rng(5)
    a = rng.uniform(-80, 80, (2, 9))
    b = rng.uniform(-180, 180, (2, 9))
    args = (a[0], b[0], a[1][:5], b[1][:5]) if two_sets else (a[0], b[0])
    ours = getattr(tdist, name)(*args, device="cpu")
    ref = getattr(jdist, name)(*map(jnp.asarray, args))
    assert ours.shape == ((9, 5) if two_sets else (9, 9))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TIGHT)


def test_scalar_geometry_matches_reference():
    ours = tdist.radial_dist(10.0, 20.0, -35.0, 140.0)
    np.testing.assert_allclose(
        ours.item(), float(jdist.radial_dist(10.0, 20.0, -35.0, 140.0)),
        **TIGHT)
    m = np.array([[3.0, 1.0], [0.5, 2.0]])
    np.testing.assert_allclose(tdist.inv_2d(torch.as_tensor(m)).numpy(),
                               np.asarray(jdist.inv_2d(jnp.asarray(m))),
                               **TIGHT)
    np.testing.assert_allclose(tdist.inv_2d(torch.as_tensor(m)).numpy(),
                               np.linalg.inv(m), **TIGHT)
    sigma = tdist.sigma_rot_func(torch.tensor(1500.0, dtype=torch.float64),
                                 torch.tensor(800.0, dtype=torch.float64),
                                 torch.tensor(0.4, dtype=torch.float64))
    jsigma = jdist.sigma_rot_func(1500.0, 800.0, 0.4)
    np.testing.assert_allclose(
        tdist.tau_dist(300.0, -120.0, sigma).item(),
        float(jdist.tau_dist(300.0, -120.0, jsigma)), **TIGHT)


@pytest.mark.parametrize("theta", [None, 0.7])
def test_mahal_dist_func_matches_reference(theta):
    rng = np.random.default_rng(6)
    dx, dy = rng.uniform(-3000, 3000, (2, 30))
    th = None if theta is None else torch.tensor(theta, dtype=torch.float64)
    ours = tdist.mahal_dist_func(torch.as_tensor(dx), torch.as_tensor(dy),
                                 1500.0, 800.0, th)
    ref = jdist.mahal_dist_func(jnp.asarray(dx), jnp.asarray(dy), 1500.0,
                                800.0, theta)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TIGHT)
    # the elementwise form agrees with the 2 x 2 algebra
    if theta is not None:
        sigma = tdist.sigma_rot_func(*(torch.tensor(v, dtype=torch.float64)
                                       for v in (1500.0, 800.0, theta)))
        np.testing.assert_allclose(
            ours[0].item(), tdist.tau_dist(dx[0], dy[0], sigma).item(),
            rtol=1e-12)


@pytest.mark.parametrize("method", ["Met_Office", "Modified_Met_Office"])
def test_tau_dist_matrix_matches_reference(method):
    rng = np.random.default_rng(7)
    lats, lons = rng.uniform(-70, 70, 11), rng.uniform(-180, 180, 11)
    ours = tdist.tau_dist_matrix(lats, lons, 1500.0, 800.0,
                                 torch.tensor(0.3, dtype=torch.float64),
                                 delta_x_method=method, device="cpu")
    ref = jdist.tau_dist_matrix(jnp.asarray(lats), jnp.asarray(lons), 1500.0,
                                800.0, 0.3, delta_x_method=method)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("name", [
    "haversine_distance_from_frame", "euclidean_distance",
    "cartesian_euclidean_from_frame", "haversine_gaussian"])
def test_frame_forms_match_reference(name):
    df = _frame(np.random.default_rng(8))
    ours = getattr(tdist, name)(df, device="cpu")
    assert isinstance(ours, np.ndarray)
    np.testing.assert_allclose(ours, getattr(jdist, name)(df), **TIGHT)
    renamed = df.rename(columns={"lat": "y", "lon": "x"})
    if name != "haversine_gaussian":
        np.testing.assert_allclose(
            tdist.calculate_distance_matrix(
                renamed, getattr(tdist, name), "y", "x", device="cpu"),
            ours, **TIGHT)
        with pytest.raises(ValueError, match="'lat' and 'lon'"):
            getattr(tdist, name)(renamed, device="cpu")
    else:
        with pytest.raises(tutils.ColumnNotFoundError, match="lat, lon"):
            tdist.haversine_gaussian(renamed, device="cpu")


def test_tmerc_and_tau_dist_from_frame_match_reference():
    rng = np.random.default_rng(9)
    lats, lons = 52.0 + rng.uniform(-2, 2, 7), -3.0 + rng.uniform(-2, 2, 7)
    for ours, ref in zip(tdist.tmerc_forward(lats, lons, 52.5, -2.5),
                         jdist.tmerc_forward(lats, lons, 52.5, -2.5)):
        np.testing.assert_array_equal(ours, ref)
    df = _frame(rng, 7).assign(
        lat=lats, lon=lons, grid_lat=52.5, grid_lon=-2.5, grid_lx=300.0,
        grid_ly=150.0, grid_theta=0.4)
    for displacement in ("tmerc", "tangent"):
        np.testing.assert_allclose(
            tdist.tau_dist_from_frame(df, displacement, device="cpu"),
            jdist.tau_dist_from_frame(df, displacement), **TIGHT)
    with pytest.raises(ValueError, match="unknown displacement"):
        tdist.tau_dist_from_frame(df, "utm", device="cpu")
    with pytest.raises(tutils.ColumnNotFoundError, match="grid_theta"):
        tdist.tau_dist_from_frame(df.drop(columns="grid_theta"),
                                  device="cpu")


def test_unit_conversions_and_types_are_the_reference_values():
    for deg in (0.5, 7.0, 50.0):
        assert tutils.deg_to_km(deg) == jframes.deg_to_km(deg)
        assert tutils.deg_to_nm(deg) == jframes.deg_to_nm(deg)
        assert tutils.km_to_deg(111.0 * deg) == jframes.km_to_deg(111.0 * deg)
    from glomargridding_tpu import types as jtypes

    for name in ("ModelType", "FForm", "SuperCategory", "DeltaXMethod",
                 "CovarianceMethod", "KrigMethod"):
        assert getattr(ttypes, name) == getattr(jtypes, name), name


def test_host_helpers_match_reference():
    rng = np.random.default_rng(10)
    mask = rng.random(20) < 0.3
    packed = rng.normal(size=int((~mask).sum()))
    for kw in (dict(), dict(fill_value=np.nan), dict(apply_mask=True),
               dict(dtype=np.float32)):
        ours = tutils.uncompress_masked(packed, mask, **kw)
        ref = jarrays.uncompress_masked(packed, mask, **kw)
        assert type(ours) is type(ref) and ours.dtype == ref.dtype
        np.testing.assert_array_equal(np.ma.filled(ours, -1.0),
                                      np.ma.filled(ref, -1.0))
    np.testing.assert_array_equal(
        tutils.uncompress_masked(torch.as_tensor(packed), mask),
        jarrays.uncompress_masked(packed, mask))
    with pytest.raises(ValueError, match="does not align"):
        tutils.uncompress_masked(packed[:-1], mask)
    grid = np.arange(-87.5, 90, 5.0)
    values = np.concatenate([rng.uniform(-95, 95, 30), [0.0, -85.0, 2.5]])
    for ours, ref in zip(tutils.find_nearest(grid, values),
                         jarrays.find_nearest(grid, values)):
        np.testing.assert_array_equal(ours, ref)
    for value in ([1, 2], "ab", 3, None, np.zeros(2)):
        assert tutils.is_iter(value) == jarrays.is_iter(value)
    for num in (0, 1023, 1024, 5 * 1024**3, 1e30):
        assert tutils.sizeof_fmt(num) == jarrays.sizeof_fmt(num)
    arr = np.arange(3.0)
    assert isinstance(tutils.mask_array(arr), np.ma.MaskedArray)
    masked = np.ma.masked_less(arr, 1.0)
    assert tutils.mask_array(masked) is masked
    with pytest.raises(TypeError, match="not a numpy array"):
        tutils.mask_array([1.0, 2.0])


@pytest.mark.parametrize("store,compute", [
    ("bfloat16", "float32"), ("float32", "float32"), ("float32", "float64")])
def test_dense_matvec_store_and_accumulation(store, compute):
    """``dense_matvec(cov, compute_dtype)`` against the reference for the
    three store/accumulate pairs: v is rounded to the store's dtype, the
    products are exact in the accumulator's, and the sum runs in it.
    (bf16, f32) and (f32, f64): both sides sum exact products in a wider
    dtype, 1e-6 / 1e-12 of max |y|; (f32, f32): the order of an f32 sum,
    1e-5."""
    rng = np.random.default_rng(11)
    n = 96
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = (A @ A.T / n).astype(np.float32)
    v = rng.normal(size=(n, 3))
    cov_t = torch.as_tensor(A).to(getattr(torch, store))
    cov_j = jnp.asarray(A).astype(getattr(jnp, store))
    mv_t = tsampling.dense_matvec(cov_t, compute_dtype=getattr(torch, compute))
    mv_j = jsampling.dense_matvec(cov_j, compute_dtype=getattr(jnp, compute))
    tol = {"bfloat16": 1e-6, "float32": 1e-5}[store] if (
        compute == "float32") else 1e-12
    for vec in (v, v[:, 0]):
        ours = mv_t(torch.as_tensor(vec))
        ref = np.asarray(mv_j(jnp.asarray(vec)))
        assert ours.dtype == torch.float64 and ours.shape == ref.shape
        scale = np.abs(ref).max()
        assert np.abs(ours.numpy() - ref).max() <= tol * scale
    if compute == "float64":
        # f64 accumulation is visible: it beats the f32 product
        exact = A.astype(np.float64) @ v.astype(np.float32).astype(np.float64)
        f32 = tsampling.dense_matvec(cov_t)(torch.as_tensor(v)).numpy()
        assert np.abs(mv_t(torch.as_tensor(v)).numpy() - exact).max() < (
            0.01 * np.abs(f32 - exact).max())
