"""Maximum-likelihood variogram fitting (``ops/variogram_fit``) against
the JAX package, on the CPU in f64 on the same numpy inputs; and the
slice end to end: a spherical-harmonic truth, its observations, the fit
and kriging with the fitted variogram.

Bounds. The likelihood: rtol 1e-12 (the same formula; the Cholesky
sums in another order); its gradient against ``jax.grad``: 1e-9.
Nelder-Mead takes the reference's steps in f64, but the last bits of the
likelihood differ (XLA's and PyTorch's exp and log round differently), so
once two vertices are nearly equal a comparison may go the other way: the
iteration counts are held within 5 (equal, or 1-4 apart, measured) and the
optimum to rtol 1e-6, the simplex's size when it stops (xatol = 1e-6 in
log-space; measured 2e-15 to 5e-8). The port's
L-BFGS has its own line search (per-lane Armijo backtracking, the
reference's is optax's zoom): it is held at the optimum only, the
parameters to rtol 1e-5 (each side stops at |grad| <= 1e-9 in log-space;
measured ~2e-7) and the likelihood to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.ops import sphere as jsphere
from glomargridding_tpu.ops import variogram_fit as jfit
from glomargridding_tpu.ops.distances import haversine_matrix
from glomargridding_tpu.ops.variogram import MaternVariogram
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.ops import sphere as tsphere
from glomargridding_tpu_torch.ops import variogram_fit as tfit

torch.set_num_threads(2)

START = (0.5, 500.0, 0.2)


def _draws(rng, n=200, psill=1.5, range_km=1500.0, nugget=0.05, nu=1.5):
    lats = rng.uniform(-60, 60, n)
    lons = rng.uniform(-180, 180, n)
    d = np.array(haversine_matrix(lats, lons))
    cov = np.asarray(
        MaternVariogram(psill=psill, nugget=0.0, range=range_km, nu=nu)
        .covariance(d, variance=psill)
    ) + nugget * np.eye(n)
    return d, rng.multivariate_normal(np.zeros(n), cov)


MODELS = [("matern", 0.5), ("matern", 1.5), ("matern", 1.0),
          ("exponential", None), ("gaussian", None)]


@pytest.mark.parametrize("kind,nu", MODELS)
def test_likelihood_and_gradient_match_jax(rng, kind, nu):
    d, y = _draws(rng)
    method = "sklearn" if kind == "matern" else None
    p = np.array([0.9, 1100.0, 0.08])
    pt = torch.tensor(p, requires_grad=True)
    ours = tfit.gp_negative_log_likelihood(pt, torch.as_tensor(d),
                                           torch.as_tensor(y), kind=kind,
                                           nu=nu, method=method)
    (grad,) = torch.autograd.grad(ours, pt)

    def ref(q):
        return jfit.gp_negative_log_likelihood(
            q, jnp.asarray(d), jnp.asarray(y), kind=kind, nu=nu,
            method=method)

    value, ref_grad = jax.value_and_grad(ref)(jnp.asarray(p))
    np.testing.assert_allclose(ours.item(), float(value), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-9)


@pytest.mark.parametrize("nu", [1.5, 1.0])
def test_gradient_is_finite_at_zero_distance(rng, nu):
    """A distance matrix with an exact-zero diagonal (the port's own
    ``haversine_matrix`` gives one): the Matern entries there take the
    nugget, and the gradient stays finite. The reference's is NaN
    there (its ``haversine_matrix`` leaves ~1e-13 on the diagonal)."""
    d, y = _draws(rng, n=60)
    np.fill_diagonal(d, 0.0)
    p = np.array([0.9, 1100.0, 0.08])
    pt = torch.tensor(p, requires_grad=True)
    value = tfit.gp_negative_log_likelihood(
        pt, torch.as_tensor(d), torch.as_tensor(y), kind="matern", nu=nu,
        method="sklearn")
    (grad,) = torch.autograd.grad(value, pt)
    assert np.isfinite(grad.numpy()).all()
    ref = float(jfit.gp_negative_log_likelihood(
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(y), kind="matern", nu=nu,
        method="sklearn"))
    np.testing.assert_allclose(value.item(), ref, rtol=1e-12)


def test_failed_cholesky_is_nan(rng):
    """An indefinite K gives NaN, as the reference's Cholesky does, so
    that a simplex takes the point for worse than any other."""
    d, y = _draws(rng, n=40)
    value = tfit.gp_negative_log_likelihood(
        torch.tensor([1.0, 1000.0, -5.0], dtype=torch.float64),
        torch.as_tensor(d), torch.as_tensor(y), kind="matern", nu=1.5,
        method="sklearn")
    assert np.isnan(value.item())


@pytest.mark.parametrize("kind", ["matern", "exponential"])
def test_nelder_mead_matches_jax_step_for_step(rng, kind):
    # the exponential model is Matern 0.5: draw from it
    d, y = _draws(rng, nu=1.5 if kind == "matern" else 0.5)
    kw = dict(kind=kind, nu=1.5, guesses=START, optimizer="Nelder-Mead",
              tol=1e-6)
    ours = tfit.fit_variogram_mle(d, y, device="cpu", **kw)
    ref = jfit.fit_variogram_mle(d, y, **kw)
    assert abs(ours.nit - ref.nit) <= 5 and ours.success == ref.success
    np.testing.assert_allclose(ours[:4], ref[:4], rtol=1e-6)


def test_lbfgs_matches_jax_at_the_optimum(rng):
    d, y = _draws(rng)
    kw = dict(nu=1.5, guesses=START, optimizer="L-BFGS-B", tol=1e-9)
    ours = tfit.fit_variogram_mle(d, y, device="cpu", **kw)
    ref = jfit.fit_variogram_mle(d, y, **kw)
    assert ours.success and ref.success
    np.testing.assert_allclose(ours[:3], ref[:3], rtol=1e-5)
    np.testing.assert_allclose(ours.nll, ref.nll, rtol=1e-12)


def test_float32_likelihood_is_summed_in_float64(rng):
    """On f32 data the likelihood is a float64 value: the f32 simplex
    then stops within 1e-2 of the f64 fit (measured 7.6e-4). The
    reference sums in f32, and its f32 simplex, whose vertices tie below
    the sum's resolution, stops a third short (the control; measured
    0.33)."""
    d, y = _draws(rng, n=300)
    kw = dict(nu=1.5, optimizer="Nelder-Mead")
    f64 = tfit.fit_variogram_mle(d, y, device="cpu", **kw)
    d32, y32 = d.astype(np.float32), y.astype(np.float32)
    value = tfit.gp_negative_log_likelihood(
        torch.tensor([1.0, 1000.0, 0.1], dtype=torch.float32),
        torch.as_tensor(d32), torch.as_tensor(y32), kind="matern", nu=1.5,
        method="sklearn")
    assert value.dtype == torch.float64
    f32 = tfit.fit_variogram_mle(d32, y32, device="cpu", **kw)
    ref32 = jfit.fit_variogram_mle(jnp.asarray(d32), jnp.asarray(y32), **kw)

    def rel(fit):
        return max(abs(p - q) / q for p, q in zip(fit[:3], f64[:3]))

    assert rel(f32) < 1e-2
    assert rel(ref32) > 1e-2


def test_bad_optimizer_rejected(rng):
    d, y = _draws(rng, n=40)
    with pytest.raises(ValueError, match="optimizer"):
        tfit.fit_variogram_mle(d, y, optimizer="Powell", device="cpu")


def test_slice_end_to_end(rng):
    """One spherical-harmonic truth at 10 degrees (the reference's
    normals replayed), 300 noisy observations, the Nelder-Mead variogram
    fit and ordinary kriging with the fitted variogram: JAX against the
    port in f64. The fitted parameters as above, to rtol 1e-6; the kriged
    field, uncertainty and mask, from the same parameters, to 1e-9."""
    lats = np.arange(-85.0, 90.0, 10.0)
    lons = np.arange(-175.0, 180.0, 10.0)
    corr = jsphere.matern_correlation(1.5, 2500.0)
    L = 32
    key = jax.random.key(11)
    jsampler = jsphere.SphericalHarmonicSampler(
        corr, 1.2, lats, lons, l_max=L, dtype=jnp.float64, member_batch=1)
    truth_j = np.asarray(jsampler.draw(key, 1))[0]
    kc, ks = jax.random.split(key)
    noise = [np.array(jax.random.normal(k, (1, L + 1, L + 1), jnp.float64))
             for k in (kc, ks)]
    tsampler = tsphere.SphericalHarmonicSampler(
        corr, 1.2, lats, lons, l_max=L, dtype=torch.float64, device="cpu")
    truth = tsampler.draw(1, noise=noise)[0].numpy()
    np.testing.assert_allclose(truth, truth_j, rtol=1e-10,
                               atol=1e-10 * np.abs(truth_j).max())

    glat, glon = np.repeat(lats, lons.size), np.tile(lons, lats.size)
    idx = np.sort(rng.choice(glat.size, 300, replace=False))
    y = truth[idx] + np.sqrt(0.05) * rng.normal(size=idx.size)
    d = np.array(haversine_matrix(glat[idx], glon[idx]))
    kw = dict(nu=1.5, guesses=(1.0, 1500.0, 0.1), optimizer="Nelder-Mead")
    fit = tfit.fit_variogram_mle(d, y, device="cpu", **kw)
    fit_j = jfit.fit_variogram_mle(d, y, **kw)
    assert abs(fit.nit - fit_j.nit) <= 5
    np.testing.assert_allclose(fit[:4], fit_j[:4], rtol=1e-6)

    vario = MaternVariogram(psill=fit_j.psill, nugget=0.0, range=fit_j.range,
                            nu=1.5)
    jkern = jkk.variogram_kernel(vario)
    tkern = convert.kernel_from_params(dataclasses.asdict(vario),
                                       jkern.distance, jkern.var,
                                       jkern.radius)
    err = np.diag(np.full(idx.size, fit_j.nugget))
    ours = tkk.kriging_from_kernel(tkern, glat, glon, idx, y, err,
                                   variance=fit_j.psill, n_blocks=3,
                                   device="cpu")
    ref = jkk.kriging_from_kernel(jkern, glat, glon, idx, y, err,
                                  variance=fit_j.psill, n_blocks=3)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)
    # the field recovers the truth better than the prior
    rmse = np.sqrt(np.mean((ours.field.numpy() - truth) ** 2))
    assert rmse < 0.5 * np.std(truth)
