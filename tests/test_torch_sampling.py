"""Matrix-free Gaussian sampling (``ops/sampling``: the Chebyshev square
root, the kernel-streamed matvec, the power iteration) against the JAX
package, on the CPU in f64 on the same numpy inputs and replayed normals.

Bounds: the coefficients are the same numpy code (exact); products and
recurrences in f64 to rtol 1e-10 (sums in another order; measured
~1e-14); the Chebyshev square root against ``eigh``'s to the reference's
1e-5 (the expansion's own accuracy at degree 120).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.ops import sampling as jsamp
from glomargridding_tpu.ops.variogram import MaternVariogram
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-12)


def _spd(rng, n=96, nugget=0.05):
    pts = rng.uniform(0, 1, size=(n, 2))
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    return np.exp(-d / 0.3) + nugget * np.eye(n)


def _interval(cov):
    w = np.linalg.eigvalsh(cov)
    return float(w[0]) * 0.9, float(w[-1]) * 1.1


@pytest.mark.parametrize("lam_min,lam_max,degree",
                         [(0.05, 60.0, 138), (0.5, 30.0, 60), (1.0, 2.0, 3)])
def test_chebyshev_sqrt_coeffs_are_the_reference_coeffs(lam_min, lam_max,
                                                        degree):
    np.testing.assert_array_equal(
        tsamp.chebyshev_sqrt_coeffs(lam_min, lam_max, degree),
        jsamp.chebyshev_sqrt_coeffs(lam_min, lam_max, degree))


def test_chebyshev_apply_matches_jax_and_eigh(rng):
    cov = _spd(rng)
    lam_min, lam_max = _interval(cov)
    z = rng.normal(size=(cov.shape[0], 4))
    coeffs = tsamp.chebyshev_sqrt_coeffs(lam_min, lam_max, 120)
    ours = tsamp.chebyshev_apply(
        tsamp.dense_matvec(torch.as_tensor(cov), torch.float64),
        torch.as_tensor(z), coeffs, lam_min, lam_max).numpy()
    ref = np.asarray(jsamp.chebyshev_apply(
        jsamp.dense_matvec(jnp.asarray(cov), jnp.float64), jnp.asarray(z),
        jnp.asarray(coeffs), lam_min, lam_max))
    np.testing.assert_allclose(ours, ref, **F64)
    ww, vv = np.linalg.eigh(cov)
    np.testing.assert_allclose(ours, (vv * np.sqrt(ww)) @ vv.T @ z,
                               rtol=1e-5, atol=1e-7)
    # a plain callable is a matvec too
    A = torch.as_tensor(cov)
    plain = tsamp.chebyshev_apply(lambda v: A @ v, torch.as_tensor(z),
                                  coeffs, lam_min, lam_max).numpy()
    np.testing.assert_allclose(plain, ours, rtol=1e-12)


def _kernels(nu=1.5):
    vario = MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=nu)
    jkern = jkk.variogram_kernel(vario)
    return jkern, convert.kernel_from_params(
        dataclasses.asdict(vario), jkern.distance, jkern.var, jkern.radius)


@pytest.mark.parametrize("n_blocks", [1, 4, 7])
def test_kernel_matvec_matches_jax(rng, n_blocks):
    """The port's row blocks are ceil(n / n_blocks), the reference's are
    rounded up to 256 rows: the values do not depend on the blocking."""
    n = 70
    la = np.radians(rng.uniform(-60, 60, n))
    lo = np.radians(rng.uniform(-180, 180, n))
    v = rng.normal(size=(n, 3))
    jkern, tkern = _kernels()
    ours = tsamp.kernel_matvec(tkern, la, lo, n_blocks=n_blocks,
                               device="cpu")(torch.as_tensor(v)).numpy()
    ref = np.asarray(jsamp.kernel_matvec(jkern, jnp.asarray(la),
                                         jnp.asarray(lo), n_blocks=4)(
        jnp.asarray(v)))
    np.testing.assert_allclose(ours, ref, **F64)
    # a vector is taken as one column
    one = tsamp.kernel_matvec(tkern, la, lo, n_blocks=n_blocks,
                              device="cpu")(torch.as_tensor(v[:, 0]))
    np.testing.assert_allclose(one.numpy(), ref[:, 0], **F64)


def test_estimate_spectral_range_matches_jax(rng):
    cov = _spd(rng)
    key = jax.random.key(1)
    start = np.array(jax.random.normal(key, (cov.shape[0], 1), jnp.float64))
    ours = tsamp.estimate_spectral_range(
        tsamp.dense_matvec(torch.as_tensor(cov), torch.float64),
        cov.shape[0], dtype=torch.float64, noise=start, device="cpu")
    ref = jsamp.estimate_spectral_range(
        jsamp.dense_matvec(jnp.asarray(cov), jnp.float64), cov.shape[0], key,
        dtype=jnp.float64)
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
    w = np.linalg.eigvalsh(cov)
    assert w[-1] * 0.99 <= ours[1] <= w[-1] * 1.2 and ours[0] > 0
    # from a generator
    gen = torch.Generator().manual_seed(0)
    drawn = tsamp.estimate_spectral_range(
        tsamp.dense_matvec(torch.as_tensor(cov), torch.float64),
        cov.shape[0], dtype=torch.float64, generator=gen, device="cpu")
    assert w[-1] * 0.99 <= drawn[1] <= w[-1] * 1.2


def test_sample_mvn_chebyshev_matches_jax(rng):
    """Replayed normals through the kernel-streamed matvec, f64."""
    n = 60
    la = np.radians(rng.uniform(-60, 60, n))
    lo = np.radians(rng.uniform(-180, 180, n))
    jkern, tkern = _kernels(0.5)
    jmv = jsamp.kernel_matvec(jkern, jnp.asarray(la), jnp.asarray(lo),
                              n_blocks=2)
    tmv = tsamp.kernel_matvec(tkern, la, lo, n_blocks=2, device="cpu")
    key = jax.random.key(2)
    z = np.array(jax.random.normal(key, (n, 5), jnp.float64))
    lam_max = 1.05 * float(np.linalg.eigvalsh(np.asarray(jmv(jnp.eye(n))))[-1])
    kw = dict(lam_min=0.01, lam_max=lam_max, degree=40)
    ours = tsamp.sample_mvn_chebyshev(tmv, n, 5, dtype=torch.float64,
                                      noise=z, device="cpu", **kw)
    ref = jsamp.sample_mvn_chebyshev(key, jmv, n, 5, dtype=jnp.float64, **kw)
    assert ours.shape == (5, n)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F64)
    with pytest.raises(ValueError, match="noise has shape"):
        tsamp.sample_mvn_chebyshev(tmv, n, 4, dtype=torch.float64, noise=z,
                                   device="cpu", **kw)


def test_coeffs_reject_nonpositive_floor():
    with pytest.raises(ValueError, match="lam_min"):
        tsamp.chebyshev_sqrt_coeffs(0.0, 1.0, 10)


def test_out_of_interval_diverges(rng):
    """lam_max below the matrix spectrum (the sill instead of the
    spectral bound) makes the polynomial blow up: the failure mode that
    ``estimate_spectral_range`` exists to prevent."""
    cov = _spd(rng, n=64)
    w = np.linalg.eigvalsh(cov)
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample_mvn_chebyshev(
        tsamp.dense_matvec(torch.as_tensor(cov, dtype=torch.float32)), 64, 8,
        float(w[0]) * 0.9, float(w[-1]) * 0.2, degree=60, generator=gen,
        device="cpu").numpy()
    assert (~np.isfinite(draws)).any() or np.abs(draws).max() > 100
    good = tsamp.sample_mvn_chebyshev(
        tsamp.dense_matvec(torch.as_tensor(cov, dtype=torch.float32)), 64, 8,
        *_interval(cov), degree=60, generator=gen, device="cpu").numpy()
    assert np.isfinite(good).all() and np.abs(good).max() < 10
