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
from glomargridding_tpu.ops import special as jspecial
from glomargridding_tpu.ops import variogram as jvario
from glomargridding_tpu_torch.convert import variogram_from_params
from glomargridding_tpu_torch.ops import distances as tdist
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
    with pytest.raises(NotImplementedError, match="Queue 1"):
        tspecial.xv_kv(0.7, torch.ones(3, dtype=torch.float64))
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
