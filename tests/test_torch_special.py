"""The general-order K_nu of the port (``ops/special``) against the JAX
package's and ``scipy.special.kv``, and the Matern paths it opens.

Bounds. f64: the JAX value to rtol 1e-12 (the same steps in the same
order; measured ~4e-15), scipy's to 1e-10 (the reference's own bound,
``tests/test_special.py``); the gradient against ``jax.grad`` to 1e-12
and against ``scipy.special.kvp`` to 1e-10. f32: 5e-5 relative off the
f32 underflow tail, the reference's bound (measured ~3e-6). The Matern
paths through it in f64: rtol 1e-10 (sums run in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import kv as scipy_kv
from scipy.special import kvp as scipy_kvp

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.models.ellipse import model as jmodel
from glomargridding_tpu.ops import special as jspecial
from glomargridding_tpu.ops import variogram as jvario
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.ops import special as tspecial
from glomargridding_tpu_torch.ops import variogram as tvario
from glomargridding_tpu_torch.ops.cuda import pairwise as tpair

torch.set_num_threads(2)

GENERAL = [0.3, 0.7, 1.0, 1.25, 2.0, 2.7, 4.2]
HALF = [0.5, 1.5, 2.5, 3.5]
# 0, negatives, tiny values, both sides of the switch at 2 and far out
X = np.concatenate([
    [0.0, -1.0, -1e-8, 1e-300, 1e-12, 1e-6],
    np.linspace(1e-4, 2.0, 120), [np.nextafter(2.0, 3.0)],
    np.linspace(2.001, 60.0, 120), [300.0, 700.0],
])
POSITIVE = X[3:]


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("v", GENERAL + HALF)
def test_kv_matches_jax_and_scipy_f64(v):
    ours = tspecial.kv(v, _t(X)).numpy()
    ref = np.asarray(jspecial.kv(v, jnp.asarray(X)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=1e-12)
    sp = scipy_kv(v, X)
    ok = np.isfinite(sp) & (sp > 0)
    np.testing.assert_allclose(ours[ok], sp[ok], rtol=1e-10)
    guarded = tspecial.kv_nan_guard(v, _t(X)).numpy()
    np.testing.assert_array_equal(
        np.isnan(guarded),
        np.isnan(np.asarray(jspecial.kv_nan_guard(v, jnp.asarray(X)))))


@pytest.mark.parametrize("v", GENERAL + [1.5])
def test_kv_gradient_matches_jax_and_scipy(v):
    x = _t(POSITIVE[2:]).requires_grad_(True)
    (ours,) = torch.autograd.grad(tspecial.kv(v, x).sum(), x)
    ref = np.asarray(jax.grad(lambda z: jspecial.kv(v, z).sum())(
        jnp.asarray(POSITIVE[2:])))
    # atol: the last values are subnormal (K_v(700) ~ 1e-306)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(ours.numpy(), scipy_kvp(v, POSITIVE[2:]),
                               rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("v", [0.3, 1.0, 1.2, 2.7, 3.0, 0.5, 1.5])
def test_kv_f32_within_the_reference_bound(v):
    x = POSITIVE[3:]
    ours = tspecial.kv(v, _t(x, torch.float32)).numpy()
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    ref = scipy_kv(v, x)
    sel = ref > 1e-30  # off the f32 underflow tail
    rel = np.abs(ours[sel] - ref[sel]) / ref[sel]
    assert rel.max() < 5e-5


def test_kv_edges_and_symmetry():
    out = tspecial.kv(1.2, _t([0.0, -1.0])).numpy()
    assert np.isinf(out[0]) and np.isnan(out[1])
    assert np.isnan(tspecial.kv_nan_guard(1.2, _t([0.0])).numpy()).all()
    np.testing.assert_array_equal(tspecial.kv(-1.2, _t(POSITIVE)).numpy(),
                                  tspecial.kv(1.2, _t(POSITIVE)).numpy())
    # an integer tensor is taken as f32, as the reference does
    assert tspecial.kv(1.2, torch.tensor([1, 2])).dtype == torch.float32


@pytest.mark.parametrize("v", GENERAL + HALF)
def test_xv_kv_matches_jax(v):
    ours = tspecial.xv_kv(v, _t(X)).numpy()
    ref = np.asarray(jspecial.xv_kv(v, jnp.asarray(X)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    keep = ~np.isnan(ref)
    np.testing.assert_allclose(ours[keep], ref[keep], rtol=1e-12)
    # the gradient at x <= 0 (entries the callers mask) is 0, not NaN
    x = _t(np.delete(X, 3)).requires_grad_(True)  # K_v(1e-300) overflows
    out = tspecial.xv_kv(v, x)
    (g,) = torch.autograd.grad(torch.where(x > 0, out, 0.0).sum(), x)
    assert np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("method", ["sklearn", "gstat", "karspeck"])
def test_matern_general_order_matches_jax(rng, method):
    d = np.concatenate([[0.0], rng.uniform(0.0, 5000.0, 60)])
    kw = dict(psill=1.3, nugget=0.1, range=900.0, nu=1.0, method=method)
    ours, ref = tvario.MaternVariogram(**kw), jvario.MaternVariogram(**kw)
    np.testing.assert_allclose(ours.fit(d), np.asarray(ref.fit(d)),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(ours.covariance(d),
                               np.asarray(ref.covariance(d)),
                               rtol=1e-10, atol=1e-14)


def test_variogram_kernel_general_order_on_the_cpu(rng):
    """``VariogramKernel`` at nu = 1.0 on CPU tensors: the plain tile,
    against the JAX kernel's tile."""
    vario = jvario.MaternVariogram(psill=1.2, nugget=0.05, range=1500.0,
                                   nu=1.0)
    jkern = jkk.variogram_kernel(vario)
    tkern = convert.kernel_from_params(dataclasses.asdict(vario),
                                       jkern.distance, jkern.var,
                                       jkern.radius)
    la = np.radians(rng.uniform(-80, 80, (2, 30)))
    lo = np.radians(rng.uniform(-180, 180, (2, 30)))
    args = (la[0], lo[0], la[1], lo[1])
    np.testing.assert_allclose(
        tkern(*map(_t, args)).numpy(),
        np.asarray(jkern(*map(jnp.asarray, args))), rtol=1e-10, atol=1e-14)
    self_tile = tkern(*map(_t, (la[0], lo[0], la[0], lo[0])))
    assert np.isfinite(self_tile.numpy()).all()


@pytest.mark.parametrize("nu,route", [(1.0, "plain"), (1.25, "plain"),
                                      (4.5, "plain"), (0.5, "kernel"),
                                      (1.5, "kernel"), (2.5, "kernel"),
                                      (3.5, "kernel")])
def test_tile_route_is_chosen_from_nu(nu, route):
    """K1 has templates for nu in {0.5, 1.5, 2.5, 3.5}; a CUDA tile at any
    other order takes the plain tile, chosen from nu before any launch."""
    assert tpair.tile_route(tvario.MaternVariogram(range=1.0, nu=nu)) == route
    assert tpair.tile_route(tvario.ExponentialVariogram(range=1.0)) == (
        "kernel")


def test_ellipse_model_general_order_likelihood(rng):
    """``EllipseModel(v=1.0)``: the Fisher-z likelihood and its gradient,
    and the residuals' forward-mode Jacobian, against the JAX package's,
    with a masked zero displacement (K_nu is +inf there)."""
    jm = jmodel.EllipseModel(True, True, True, 1.0, unit_sigma=False)
    tm = convert.ellipse_model_from_params(vars(jm))
    X = rng.uniform(-2500, 2500, size=(50, 2))
    y = np.clip(rng.uniform(-0.2, 0.95, 50), -0.99, 0.99)
    w = (rng.random(50) > 0.3).astype(float)
    X[5], w[5] = 0.0, 0.0
    z = np.arctanh(np.where(w > 0, y, 0.0))
    p = np.array([1100.0, 700.0, 0.3, 0.2])
    pt = _t(p).requires_grad_(True)
    value = tm._nll_fit_z(pt, _t(X), _t(z), _t(w))
    (grad,) = torch.autograd.grad(value, pt)
    ref, ref_grad = jax.value_and_grad(
        lambda q: jm._nll_fit_z(q, jnp.asarray(X), jnp.asarray(z),
                                jnp.asarray(w)))(jnp.asarray(p))
    np.testing.assert_allclose(value.item(), float(ref), rtol=1e-10)
    assert np.isfinite(grad.numpy()).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-9,
                               atol=1e-12 * np.abs(ref_grad).max())
    J = torch.func.jacfwd(lambda q: tm._residuals_fit_z(
        q, _t(X), _t(z), _t(w)))(_t(p)).numpy()
    ref_J = np.asarray(jax.jacfwd(lambda q: jm._residuals_fit_z(
        q, jnp.asarray(X), jnp.asarray(z), jnp.asarray(w)))(jnp.asarray(p)))
    np.testing.assert_allclose(J, ref_J, rtol=1e-9,
                               atol=1e-12 * np.abs(ref_J).max())
