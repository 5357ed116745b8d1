"""The streamed kriging slice: PyTorch port vs the JAX package.

The same numpy inputs go through ``glomargridding_tpu.models.
kernel_kriging`` and ``glomargridding_tpu_torch.models.kernel_kriging``;
the port's kernel is built only through ``convert.kernel_from_params``
from the reference kernel's own parameters. All in f64 (x64 is on for the
test session); tolerance rtol 1e-8 with an absolute floor of 1e-10 for
outputs that cross zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.ops.distances import haversine_matrix
from glomargridding_tpu.ops.variogram import (
    ExponentialVariogram,
    MaternVariogram,
)
from glomargridding_tpu_torch.convert import kernel_from_params
from glomargridding_tpu_torch.models import kernel_kriging as tkk

torch.set_num_threads(2)

RTOL, ATOL = 1e-8, 1e-10


def _grid_problem(rng, n_lat=12, n_lon=24, n_obs=20):
    lat = np.arange(-82.5, 90, 180.0 / n_lat)
    lon = np.arange(-172.5, 180, 360.0 / n_lon)
    glat = np.repeat(lat, n_lon)
    glon = np.tile(lon, n_lat)
    m = len(glat)
    idx = np.sort(rng.choice(m, n_obs, replace=False))
    obs = rng.normal(size=n_obs)
    err = np.diag(0.1 + 0.05 * rng.random(n_obs))
    return glat, glon, idx, obs, err


def _kernels(jvario, distance="haversine", variance=None):
    jkern = jkk.variogram_kernel(jvario, distance=distance, variance=variance)
    tkern = kernel_from_params(
        dataclasses.asdict(jvario), jkern.distance, jkern.var, jkern.radius
    )
    return jkern, tkern


def _close(ours, ref):
    np.testing.assert_allclose(
        np.asarray(ours), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


MODELS = {
    "matern15": MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=1.5),
    "matern05-nugget": MaternVariogram(psill=1.0, nugget=0.1, range=1500.0,
                                       nu=0.5),
    "exponential": ExponentialVariogram(psill=1.0, nugget=0.0, range=900.0),
}


@pytest.mark.parametrize("distance", ["haversine", "chordal", "cartesian"])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("method", ["ordinary", "simple"])
def test_kriging_matches_reference(rng, method, model, distance):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels(MODELS[model], distance)
    variance = float(jkern.var)
    kw = dict(error_cov=err, variance=variance, method=method, mean=0.3,
              n_blocks=5)
    ref = jkk.kriging_from_kernel(jkern, glat, glon, idx, obs, **kw)
    ours = tkk.kriging_from_kernel(tkern, glat, glon, idx, obs, **kw,
                                   device="cpu")
    assert isinstance(ours, tkk.KrigingResult)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float64 and o.shape == (len(glat),)
        _close(o, r)


def test_kriging_without_error_cov(rng):
    glat, glon, idx, obs, _ = _grid_problem(rng)
    jkern, tkern = _kernels(MODELS["matern05-nugget"])
    ref = jkk.kriging_from_kernel(jkern, glat, glon, idx, obs, variance=1.1)
    ours = tkk.kriging_from_kernel(tkern, glat, glon, idx, obs, variance=1.1,
                                   device="cpu")
    for o, r in zip(ours, ref):
        _close(o, r)


def test_block_invariance(rng, monkeypatch):
    """Result independent of the block count (ragged last blocks
    included) and of the row panels of L^-1 (three of 8, 8 and 4 rows
    for the 20 observations, against one); the block widths follow the
    tile kernel's column tile."""
    glat, glon, idx, obs, err = _grid_problem(rng, n_lat=18, n_lon=36)
    _, tkern = _kernels(MODELS["matern15"])
    base = tkk.kriging_from_kernel(tkern, glat, glon, idx, obs, err,
                                   variance=1.2, n_blocks=1, device="cpu")
    assert tkk._TRI_PANEL_ROWS >= len(idx)
    for n_blocks, panel in ((2, None), (3, None), (7, None), (16, None),
                            (10_000, None), (1, 8), (3, 8)):
        if panel is not None:
            monkeypatch.setattr(tkk, "_TRI_PANEL_ROWS", panel)
        other = tkk.kriging_from_kernel(tkern, glat, glon, idx, obs, err,
                                        variance=1.2, n_blocks=n_blocks,
                                        device="cpu")
        for o, b in zip(other, base):
            np.testing.assert_allclose(o.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-14)
    assert tkk._blocks(648, 3) == [(0, 256), (256, 512), (512, 648)]
    assert tkk._blocks(648, 10_000)[-1] == (640, 648)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 41])
def test_tri_colsq_matches_dense_product(n, dtype):
    """Row panels of 8 (n = 1, h - 1, h, h + 1, 3h + 17: one panel, a
    whole and a ragged last one) give the dense product's column sums of
    squares: to 1e-12 in f64, to f32 rounding (64 eps) in f32."""
    g = torch.Generator().manual_seed(n)
    A = torch.randn((n, n), generator=g, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.T / n + torch.eye(n, dtype=A.dtype))
    Linv = torch.linalg.solve_triangular(L, torch.eye(n, dtype=A.dtype),
                                         upper=False).to(dtype)
    Cc = torch.randn((n, 37), generator=g, dtype=torch.float64).to(dtype)
    want = torch.sum((Linv @ Cc) ** 2, 0)
    rtol = 1e-12 if dtype == torch.float64 else 64 * torch.finfo(dtype).eps
    for panel in (8, n):
        got = tkk._tri_colsq(Linv, Cc, panel)
        assert got.dtype == dtype and got.shape == (37,)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=0)


def test_months_scan_matches_reference(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels(MODELS["matern05-nugget"])
    T = 3
    idx_m = np.stack([idx] * T)
    obs_m = np.stack([rng.normal(size=len(idx)) for _ in range(T)])
    err_m = np.stack([err * (1.0 + 0.1 * t) for t in range(T)])
    args = (glat, glon, idx_m, obs_m, err_m)
    ref = jkk.months_scan_kriging(jkern, *args, variance=1.1)
    ours = tkk.months_scan_kriging(tkern, *args, variance=1.1, device="cpu")
    for o, r in zip(ours, ref):
        assert o.shape == (T, len(glat))
        _close(o, r)
    # the fields-only branch: no triangular inverse, same fields
    ref_f = jkk.months_scan_kriging(jkern, *args, variance=1.1,
                                    diagnostics=False)
    ours_f = tkk.months_scan_kriging(tkern, *args, variance=1.1,
                                     diagnostics=False, device="cpu")
    _close(ours_f, ref_f)
    _close(ours_f, ours[0])


def test_pad_month_observations(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    months = ([idx, idx[:12]], [obs, obs[:12]], [err, err[:12, :12]])
    for o, r in zip(tkk.pad_month_observations(*months),
                    jkk.pad_month_observations(*months)):
        np.testing.assert_array_equal(o, r)
    with pytest.raises(ValueError, match="bucket"):
        tkk.pad_month_observations([idx], [obs], [err], bucket=3)


def test_ensemble_with_reference_noise(rng):
    """Injected noise: the reference's own draws (jax.random.normal with
    the key the reference uses), so field and members must agree."""
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels(MODELS["matern15"])
    n_members = 16
    key = jax.random.key(0)
    noise = np.array(
        jax.random.normal(key, (n_members, len(idx)), jnp.float64)
    )
    ref_f, ref_m = jkk.ensemble_from_kernel(
        jkern, glat, glon, idx, obs, err, key, n_members=n_members,
        n_blocks=3,
    )
    ours_f, ours_m = tkk.ensemble_from_kernel(
        tkern, glat, glon, idx, obs, err, n_members=n_members, n_blocks=3,
        noise=noise, device="cpu",
    )
    assert ours_m.shape == (n_members, len(glat))
    _close(ours_f, ref_f)
    _close(ours_m, ref_m)
    with pytest.raises(ValueError, match="noise"):
        tkk.ensemble_from_kernel(tkern, glat, glon, idx, obs, err,
                                 n_members=3, noise=noise, device="cpu")


def test_ensemble_generator_draws(rng):
    """Without noise the draws come from the generator: same seed, same
    members; the field does not depend on the draws."""
    glat, glon, idx, obs, err = _grid_problem(rng)
    _, tkern = _kernels(MODELS["matern15"])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tkk.ensemble_from_kernel(tkern, glat, glon, idx, obs, err,
                                        gen, n_members=8, n_blocks=2,
                                        device="cpu")

    (f0, m0), (f1, m1), (f2, m2) = run(0), run(0), run(1)
    assert torch.equal(m0, m1)
    assert not torch.equal(m0, m2)
    torch.testing.assert_close(f0, f2, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["ordinary", "simple"])
@pytest.mark.parametrize("diag_error", [False, True])
def test_kriging_crossval_matches_reference(rng, method, diag_error):
    glat, glon, idx, obs, err = _grid_problem(rng, n_obs=14)
    jkern, tkern = _kernels(MODELS["matern15"])
    e = np.diag(err).copy() if diag_error else err
    ref = jkk.kriging_crossval(jkern, glat, glon, idx, obs, error_cov=e,
                               mean=0.2, method=method)
    ours = tkk.kriging_crossval(tkern, glat, glon, idx, obs, error_cov=e,
                                mean=0.2, method=method, device="cpu")
    assert isinstance(ours, tkk.CrossValResult)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("method", ["ordinary", "simple"])
def test_crossval_from_covariance_matches_reference(rng, method):
    glat, glon, idx, obs, err = _grid_problem(rng, n_obs=18)
    vario = MODELS["matern15"]
    d = np.asarray(haversine_matrix(glat, glon))
    cov = 1.2 - np.asarray(vario.fit(jnp.asarray(d)))
    full_err = np.full(len(glat), 0.12)  # grid-sized: subset to idx
    for e in (err, full_err, np.diag(full_err)):
        ref = jkk.crossval_from_covariance(cov, idx, obs, error_cov=e,
                                           method=method)
        ours = tkk.crossval_from_covariance(cov, idx, obs, error_cov=e,
                                            method=method, device="cpu")
        for o, r in zip(ours, ref):
            _close(o, r)
    with pytest.raises(ValueError, match="matches neither"):
        tkk.crossval_from_covariance(cov, idx, obs, error_cov=np.ones(7),
                                     device="cpu")


def test_unknown_method_and_distance(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    _, tkern = _kernels(MODELS["matern15"])
    for fn in (tkk.kriging_from_kernel, tkk.kriging_crossval):
        with pytest.raises(ValueError, match="method"):
            fn(tkern, glat, glon, idx, obs, err, method="bogus",
               device="cpu")
    with pytest.raises(ValueError, match="method"):
        tkk.crossval_from_covariance(np.eye(3), [0], [1.0], method="bogus",
                                     device="cpu")
    with pytest.raises(ValueError, match="distance"):
        tkk.variogram_kernel(tkern.variogram, distance="manhattan")


def test_float32_inputs_stay_float32(rng):
    """The main path runs in f32: f32 tensors in, f32 out, close to the
    f64 result (f32 eps times cond(K) at this size, atol 1e-4)."""
    glat, glon, idx, obs, err = _grid_problem(rng)
    _, tkern = _kernels(MODELS["matern15"])
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in (glat, glon)]
    res32 = tkk.kriging_from_kernel(
        tkern, *f32, torch.as_tensor(idx), torch.as_tensor(obs).float(),
        torch.as_tensor(err).float(), variance=1.2,
    )
    res64 = tkk.kriging_from_kernel(tkern, glat, glon, idx, obs, err,
                                    variance=1.2, device="cpu")
    for a, b in zip(res32, res64):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
