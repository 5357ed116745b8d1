"""Spherical-harmonic sampling (``ops/sphere``) and the spectral route of
``precompute_states`` against the JAX package, on the CPU on the same
inputs and replayed ``jax.random`` normals.

Bounds. The host functions are copies: 1e-12. The device Legendre table
in f64 against the host table: 1e-11 (measured 3e-13). In f32 at 1 degree
and L = 256 against the host f64 table: the reference's 2e-3 (its test,
``tests/test_sphere.py``; measured 7e-4), and against the JAX package's
device table 1e-3 (the same recurrence, rounded in another order:
measured 1.6e-4). Draws in f64: 1e-10 of max |f| (measured ~6e-16); in
f32, 1e-5 of max |f| at L <= 64. Statistics: the reference's own bounds.
Every sampler here has l_max <= 64 (the table test excepted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import stochastic as jst
from glomargridding_tpu.ops import sphere as jsphere
from glomargridding_tpu_torch.models import stochastic as tst
from glomargridding_tpu_torch.ops import sphere as tsphere

torch.set_num_threads(2)

LATS = np.arange(-80.0, 81.0, 20.0)
LONS = np.arange(0.0, 360.0, 30.0)


def test_host_functions_are_the_reference_functions():
    corr = tsphere.matern_correlation(1.5, 2000.0)
    gam = np.linspace(0.0, np.pi, 50)
    np.testing.assert_allclose(
        corr(gam), jsphere.matern_correlation(1.5, 2000.0)(gam), rtol=1e-12)
    np.testing.assert_allclose(tsphere.angular_power(corr, 48),
                               jsphere.angular_power(corr, 48), rtol=1e-12,
                               atol=1e-15)
    lats = np.arange(-89.5, 90.0, 7.0)
    np.testing.assert_allclose(tsphere.legendre_table(40, lats),
                               jsphere.legendre_table(40, lats), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tsphere.dft_tables(64, LONS),
                               jsphere.dft_tables(64, LONS), rtol=1e-12,
                               atol=1e-15)


def _plain_f32_table(L, x):
    """The same recurrence in plain f32, the diagonal seeded as an
    unscaled product: cos(lat)^m seeds flush to 0 near the poles."""
    x = torch.as_tensor(x, dtype=torch.float32)
    sx = torch.sqrt(torch.clamp(1 - x * x, min=0.0))
    P = torch.zeros((L + 1, L + 1, x.shape[0]), dtype=torch.float32)
    P[0, 0] = float(np.sqrt(1 / (4 * np.pi)))
    for m in range(1, L + 1):
        coef = -float(np.sqrt((2 * m + 1) / (2.0 * m)))
        P[m, m] = coef * sx * P[m - 1, m - 1]
    for m in range(L):
        P[m + 1, m] = x * float(np.sqrt(2 * m + 3.0)) * P[m, m]
    for l in range(2, L + 1):
        m = np.arange(l - 1)
        a = torch.as_tensor(np.sqrt((4.0 * l * l - 1) / (l * l - m * m)),
                            dtype=torch.float32)[:, None]
        b = torch.as_tensor(np.sqrt(((l - 1.0) ** 2 - m * m)
                                    / (4.0 * (l - 1.0) ** 2 - 1)),
                            dtype=torch.float32)[:, None]
        P[l, : l - 1] = a * (x[None, :] * P[l - 1, : l - 1]
                             - b * P[l - 2, : l - 1])
    return P


def test_device_legendre_table():
    """f64 is the host table; f32 keeps the lanes a plain f32 recurrence
    loses (that control misses the host table by > 1e-2)."""
    lats = np.arange(-89.5, 90.0, 1.0)
    L = 256
    host = tsphere.legendre_table(L, lats)
    x = np.sin(np.radians(lats))
    f64 = tsphere._legendre_table_device(torch.as_tensor(x), L).numpy()
    np.testing.assert_allclose(f64, host, rtol=0, atol=1e-11)
    f32 = tsphere._legendre_table_device(
        torch.as_tensor(x, dtype=torch.float32), L).numpy()
    assert f32.dtype == np.float32
    assert np.abs(f32 - host).max() < 2e-3
    ref = np.asarray(jsphere._legendre_table_device(
        jnp.asarray(x, jnp.float32), L))
    assert np.abs(f32 - ref).max() < 1e-3
    plain = _plain_f32_table(L, x).numpy()
    assert np.abs(plain - host).max() > 1e-2


def _replayed(key, n, L, member_batch, nugget, M, dtype=jnp.float64):
    """The reference's normals for ``draw(key, n)`` in `dtype` (jax.random
    draws other values in f32 than in f64): coefficients at the
    rounded-up count, split from the key (after the nugget split)."""
    k = key
    if nugget > 0:
        k, kn = jax.random.split(key)
    n_eff = member_batch * (-(-n // member_batch))
    kc, ks = jax.random.split(k)
    noise = [np.array(jax.random.normal(kk, (n_eff, L + 1, L + 1), dtype))[:n]
             for kk in (kc, ks)]
    if nugget > 0:
        noise.append(np.array(jax.random.normal(kn, (n, M), dtype)))
    return noise


@pytest.mark.parametrize("n", [5, 8, 13])
@pytest.mark.parametrize("nugget", [0.0, 0.3])
def test_draw_replays_jax(n, nugget):
    """Counts below, at and above member_batch (8)."""
    corr = jsphere.matern_correlation(1.5, 3000.0)
    L = 32
    key = jax.random.key(n)
    kw = dict(l_max=L, nugget=nugget, member_batch=8)
    ref = np.asarray(jsphere.SphericalHarmonicSampler(
        corr, 1.3, LATS, LONS, dtype=jnp.float64, **kw).draw(key, n))
    noise = _replayed(key, n, L, 8, nugget, LATS.size * LONS.size)
    ours = tsphere.SphericalHarmonicSampler(
        corr, 1.3, LATS, LONS, dtype=torch.float64, device="cpu",
        **kw).draw(n, noise=noise)
    assert ours.shape == (n, LATS.size * LONS.size)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-10 * scale)
    # f32 on the same normals, against the reference's f32 draw
    ref32 = np.asarray(jsphere.SphericalHarmonicSampler(
        corr, 1.3, LATS, LONS, dtype=jnp.float32, **kw).draw(key, n))
    ours32 = tsphere.SphericalHarmonicSampler(
        corr, 1.3, LATS, LONS, dtype=torch.float32, device="cpu",
        **kw).draw(n, noise=_replayed(key, n, L, 8, nugget,
                                      LATS.size * LONS.size, jnp.float32))
    np.testing.assert_allclose(ours32.numpy(), ref32, rtol=0,
                               atol=1e-5 * scale)


def test_synthesize_matches_jax():
    corr = jsphere.matern_correlation(0.5, 1500.0)
    L = 24
    jsampler = jsphere.SphericalHarmonicSampler(corr, 1.0, LATS, LONS,
                                                l_max=L, dtype=jnp.float64)
    key = jax.random.key(4)
    ref = np.asarray(jsphere._synthesize(key, jsampler.c_l, jsampler.P_table,
                                         jsampler.trig, 3))
    z = _replayed(key, 3, L, 3, 0.0, 0)
    ours = tsphere._synthesize(*(torch.as_tensor(np.array(a)) for a in (
        jsampler.c_l, jsampler.P_table, jsampler.trig, *z)))
    assert ours.shape == (3, LATS.size, LONS.size)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_member_batch_does_not_change_draws():
    corr = jsphere.matern_correlation(1.5, 3000.0)

    def draws(batch, table):
        gen = torch.Generator().manual_seed(5)
        return tsphere.SphericalHarmonicSampler(
            corr, 1.0, LATS, LONS, l_max=24, nugget=0.1, member_batch=batch,
            table=table, dtype=torch.float64, device="cpu").draw(
                7, generator=gen)

    a = draws(2, "device")
    np.testing.assert_allclose(draws(64, "device").numpy(), a.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(draws(3, "host").numpy(), a.numpy(),
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="table"):
        draws(2, "disk")


def test_sample_covariance_matches_the_kernel():
    """Draws from a torch generator: the sample covariance is variance *
    corr(great-circle angle), the reference's test and bounds."""
    lats = np.arange(-60.0, 61.0, 30.0)
    lons = np.arange(-180.0, 180.0, 60.0)
    corr = tsphere.matern_correlation(nu=1.5, range_km=8000.0)
    sampler = tsphere.SphericalHarmonicSampler(
        corr, variance=2.0, lats_deg=lats, lons_deg=lons, l_max=64,
        member_batch=4000, device="cpu")
    assert sampler.truncation_fraction > 0.999
    gen = torch.Generator().manual_seed(0)
    draws = sampler.draw(12_000, generator=gen).double().numpy()
    sample_cov = np.cov(draws.T)
    la = np.radians(np.repeat(lats, len(lons)))
    lo = np.radians(np.tile(lons, len(lats)))
    a = (np.sin((la[:, None] - la[None, :]) / 2) ** 2
         + np.cos(la)[:, None] * np.cos(la)[None, :]
         * np.sin((lo[:, None] - lo[None, :]) / 2) ** 2)
    expected = 2.0 * corr(2 * np.arcsin(np.sqrt(np.clip(a, 0, 1))))
    # 12k draws: sampling noise ~ 2 / sqrt(12000) ~ 2%
    assert np.abs(sample_cov - expected).max() < 0.15
    np.testing.assert_allclose(np.diag(sample_cov), np.diag(expected),
                               rtol=0.05)


def test_precompute_states_spectral_matches_jax():
    """The spectral route: the reference's sampler defaults (f32, l_max
    3 n_lat, member_batch 64) on replayed normals; f32 bound as above."""
    lats = np.arange(-75.0, 76.0, 30.0)
    lons = np.arange(0.0, 360.0, 45.0)
    corr = jsphere.matern_correlation(0.5, 2500.0)
    key = jax.random.key(9)
    M = lats.size * lons.size
    ref = np.asarray(jst.precompute_states(
        key, 3, corr_fn=corr, variance=1.1, lats_deg=lats, lons_deg=lons,
        nugget=0.05))
    noise = _replayed(key, 3, 3 * lats.size, 64, 0.05, M, jnp.float32)
    ours = tst.precompute_states(3, corr_fn=corr, variance=1.1,
                                 lats_deg=lats, lons_deg=lons, nugget=0.05,
                                 noise=noise, device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == (3, M)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
