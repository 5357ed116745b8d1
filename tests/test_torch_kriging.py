"""Dense kriging classes of the port against the JAX package (CPU), and
the non-stationary slice end to end.

Same numpy inputs on both sides, f64, rtol 1e-8 unless stated (both
sides factor the same matrix; LAPACK calls and summation orders differ).
The GeoStats.jl golden file is held to the JAX test's own bounds.
"""

from contextlib import nullcontext
from itertools import product

import numpy as np
import pandas as pd
import pytest
import torch

from glomargridding_tpu.grid import (
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)
from glomargridding_tpu.models import kriging as jkrig
from glomargridding_tpu.models.ellipse import EllipseCovarianceBuilder
from glomargridding_tpu.models.kernel_kriging import (
    crossval_from_covariance as j_crossval,
)
from glomargridding_tpu.ops.distances import cartesian_euclidean_from_frame
from glomargridding_tpu.ops.variogram import MaternVariogram
from glomargridding_tpu.utils import arrays as jarrays
from glomargridding_tpu_torch.convert import ellipse_builder_from_inputs
from glomargridding_tpu_torch.models import kriging as tkrig
from glomargridding_tpu_torch.models.kernel_kriging import (
    crossval_from_covariance as t_crossval,
)
from glomargridding_tpu_torch.utils import arrays as tarrays
from glomargridding_tpu_torch.utils.profiling import COUNTS

from conftest import reference_data_path

torch.set_num_threads(2)

RTOL, ATOL = 1e-8, 1e-10


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _golden():
    with open(reference_data_path("geostatsjl_ord_krig_results.dat")) as f:
        vals = [float(line) for line in f]
    return np.reshape(vals, (20, 20), "F")


def _setup():
    """The GeoStats.jl configuration: a Matern(1.5) VARIOGRAM matrix on a
    20 x 20 planar grid (zero diagonal: not positive definite)."""
    grid = grid_from_resolution(1, [(1, 21), (1, 21)], ["lat", "lon"])
    obs = pd.DataFrame({"lat": [5.0, 15.0, 10.0], "lon": [5.0, 10.0, 15.0],
                        "val": [1.0, 0.0, 1.0]})
    obs = map_to_grid(obs, grid, grid_coords=["lat", "lon"])
    dist = grid_to_distance_matrix(grid, cartesian_euclidean_from_frame)
    variogram = MaternVariogram(range=35 / 3, psill=4.0, nugget=0.0, nu=1.5)
    covariance = np.asarray(variogram.fit(dist.values))
    return covariance, obs["grid_idx"].to_numpy(), obs["val"].to_numpy()


def _error_cov(shape, idx, rng, nan_at=None):
    err = np.full(shape, np.nan)
    vals = rng.random((3, 3))
    vals = vals @ vals.T
    if nan_at is not None:
        vals[nan_at, nan_at] = np.nan
    for (i, j), v in zip(product(idx, idx), vals.flatten()):
        err[i, j] = v
    return err


def _spd_case(rng, m=120, n=15):
    """A true covariance (SPD): exponential kernel on random points."""
    pts = rng.uniform(0, 10, (m, 2))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    cov = 1.5 * np.exp(-d / 3.0)
    idx = np.sort(rng.choice(m, n, replace=False))
    return cov, idx, rng.normal(size=n), np.diag(0.1 + 0.05 * rng.random(n))


def test_ordinary_golden_lu_branch():
    """GeoStats.jl: the variogram matrix is indefinite, so _solve_sym
    takes the LU branch; class and function forms."""
    cov, idx, obs = _setup()
    before = COUNTS.copy()
    field = tkrig.OrdinaryKriging(cov, idx, obs, device="cpu").solve()
    assert COUNTS["kriging.solve.lu"] == before["kriging.solve.lu"] + 1
    assert COUNTS["kriging.solve.cholesky"] == before["kriging.solve.cholesky"]
    np.testing.assert_allclose(_golden(), _np(field).reshape(20, 20),
                               rtol=1e-7, atol=1e-9)
    with pytest.warns(DeprecationWarning):
        k, _ = tkrig.kriging_ordinary(cov[np.ix_(idx, idx)], cov[idx], obs,
                                      cov, device="cpu")
    np.testing.assert_allclose(_golden(), _np(k).reshape(20, 20),
                               rtol=1e-7, atol=1e-9)


def test_ordinary_from_weights_and_inverse():
    cov, idx, obs = _setup()
    S, SS = cov[np.ix_(idx, idx)], cov[idx]
    n, m = SS.shape
    S_ext = np.block([[S, np.ones((n, 1))], [np.ones((1, n)), 0]])
    W = np.linalg.solve(S_ext, np.concatenate([SS, np.ones((1, m))])).T
    ok = tkrig.OrdinaryKriging(cov, idx, obs, device="cpu")
    ok.set_kriging_weights(W)
    np.testing.assert_allclose(_golden(), _np(ok.solve()).reshape(20, 20),
                               rtol=1e-7, atol=1e-12)
    ok = tkrig.OrdinaryKriging(cov, idx, obs, device="cpu")
    ok.kriging_weights_from_inverse(ok.extended_inverse(np.linalg.inv(S)))
    np.testing.assert_allclose(_golden(), _np(ok.solve()).reshape(20, 20),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("n", [10, 100])
def test_extended_inverse(rng, n):
    A = rng.random((n, n))
    S = A @ A.T + n * np.eye(n)
    ours = _np(tkrig._extended_inverse(np.linalg.inv(S)))
    S_ext = np.block([[S, np.ones((n, 1))], [np.ones((1, n)), 0]])
    np.testing.assert_allclose(ours, np.linalg.inv(S_ext), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(
        ours, jkrig._extended_inverse(np.linalg.inv(S)), rtol=1e-10)
    with pytest.raises(ValueError, match="matrix"):
        tkrig._extended_inverse(np.ones(3))


def _compare(ours, ref):
    np.testing.assert_allclose(_np(ours.solve()), ref.solve(), rtol=RTOL,
                               atol=ATOL)
    with np.errstate(invalid="ignore"):
        np.testing.assert_allclose(_np(ours.get_uncertainty()),
                                   ref.get_uncertainty(), rtol=1e-7,
                                   atol=1e-9)
    np.testing.assert_allclose(_np(ours.constraint_mask()),
                               ref.constraint_mask(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(ours.kriging_weights),
                               np.asarray(ref.kriging_weights), rtol=1e-7,
                               atol=ATOL)


@pytest.mark.parametrize("convention", ["reference", "textbook"])
@pytest.mark.parametrize("case", ["golden", "spd"])
def test_ordinary_matches_reference(rng, case, convention):
    if case == "golden":
        cov, idx, obs = _setup()
        err = _error_cov(cov.shape, idx, rng)
    else:
        cov, idx, obs, err = _spd_case(rng)
    args = (cov, idx, obs, err)
    ref = jkrig.OrdinaryKriging(*args, uncertainty=convention)
    with pytest.warns(UserWarning) if case == "golden" else nullcontext():
        # the golden variogram system has genuinely negative variances
        ours = tkrig.OrdinaryKriging(*args, uncertainty=convention,
                                     device="cpu")
        _compare(ours, ref)
    # injected weights honour the convention too
    W = np.asarray(ref.kriging_weights)
    again = tkrig.OrdinaryKriging(*args, uncertainty=convention,
                                  device="cpu")
    again.set_kriging_weights(W)
    with np.errstate(invalid="ignore"):
        np.testing.assert_allclose(
            _np(again.get_uncertainty()), ref.get_uncertainty(),
            rtol=1e-6, atol=1e-8)


def test_simple_matches_reference_cholesky_branch(rng):
    cov, idx, obs, err = _spd_case(rng)
    before = COUNTS.copy()
    ours = tkrig.SimpleKriging(cov, idx, obs, err, device="cpu")
    ref = jkrig.SimpleKriging(cov, idx, obs, err)
    _compare(ours, ref)
    assert COUNTS["kriging.solve.cholesky"] > before["kriging.solve.cholesky"]
    assert COUNTS["kriging.solve.lu"] == before["kriging.solve.lu"]
    # a new solver with the mean
    shifted = tkrig.SimpleKriging(cov, idx, obs, err,
                                  device="cpu").solve(mean=2.5)
    np.testing.assert_allclose(_np(shifted), ref.solve() + 2.5, rtol=RTOL)
    # weights from an inverse, and the uncertainty from set weights
    K = cov[np.ix_(idx, idx)] + err
    inv = tkrig.SimpleKriging(cov, idx, obs, err, device="cpu")
    inv.kriging_weights_from_inverse(np.linalg.inv(K))
    np.testing.assert_allclose(_np(inv.get_uncertainty()),
                               ref.get_uncertainty(), rtol=1e-7)
    np.testing.assert_allclose(_np(inv.constraint_mask()),
                               ref.constraint_mask(), rtol=1e-7)
    with pytest.warns(DeprecationWarning):
        k, u = tkrig.kriging_simple(K, cov[idx], obs, cov, device="cpu")
    np.testing.assert_allclose(_np(k), ref.solve(), rtol=RTOL)
    np.testing.assert_allclose(_np(u), ref.get_uncertainty(), rtol=1e-7)
    np.testing.assert_allclose(
        _np(tkrig.constraint_mask(K, cov[idx], cov, device="cpu")),
        jkrig.constraint_mask(K, cov[idx], cov), rtol=RTOL)
    with pytest.raises(KeyError):
        tkrig.SimpleKriging(cov, idx, obs, err, device="cpu").get_uncertainty()
    with pytest.raises(TypeError):  # abstract
        tkrig.Kriging(cov, idx, obs)


def test_filter_bad_error_cov_values(rng):
    cov, idx, obs = _setup()
    err = _error_cov(cov.shape, idx, rng, nan_at=2)
    msg = (
        "Have nans or zeros on the error covariance diagonal. "
        f"At positions {idx[2]}. Filtering input accordingly"
    )
    with pytest.warns(UserWarning, match=msg):
        ok = tkrig.OrdinaryKriging(cov, idx, obs, err, device="cpu")
    assert _np(ok.idx).tolist() == idx[:2].tolist()
    assert _np(ok.obs).tolist() == obs[:2].tolist()
    assert ok.error_cov.shape == (2, 2)
    with pytest.raises(ValueError, match="uncertainty"):
        tkrig.OrdinaryKriging(cov, idx, obs, uncertainty="bogus",
                              device="cpu")


def test_prep_obs_for_kriging():
    args = (np.array([0, 3, 5, 7, 9]), np.array([3, 7]),
            np.array([[0.5, 0.5, 0.0], [0.0, 0.0, 1.0]]),
            np.array([1.0, 3.0, 5.0]))
    for mode in (0, 1, 2):
        ours = tkrig.prep_obs_for_kriging(*args, remove_obs_mean=mode)
        ref = jkrig.prep_obs_for_kriging(*args, remove_obs_mean=mode)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b)
    err = np.array([[1.0, 0.2], [0.2, 2.0]])
    np.testing.assert_allclose(
        tkrig.prep_obs_for_kriging(*args, remove_obs_mean=3,
                                   error_cov=err)[1],
        jkrig.prep_obs_for_kriging(*args, remove_obs_mean=3,
                                   error_cov=err)[1])
    with pytest.raises(ValueError):
        tkrig.prep_obs_for_kriging(*args, remove_obs_mean=3)
    np.testing.assert_array_equal(
        tkrig.get_unmasked_obs_indices(np.array([[2, 4, 6, 8]]),
                                       np.array([8, 2])),
        jkrig.get_unmasked_obs_indices(np.array([[2, 4, 6, 8]]),
                                       np.array([8, 2])))


def test_array_helpers(rng):
    x = np.array([-1e-10, 0.5, -0.3, 2.0])
    with pytest.warns(UserWarning, match="Small negative"):
        ours = tarrays.adjust_small_negative(torch.as_tensor(x))
    with pytest.warns(UserWarning):
        ref = jarrays.adjust_small_negative(x)
    np.testing.assert_array_equal(_np(ours), ref)
    a, b = rng.integers(0, 20, 30), rng.integers(0, 20, 25)
    for u, v in zip(tarrays.intersect_mtlb(a, b), jarrays.intersect_mtlb(a, b)):
        np.testing.assert_array_equal(u, v)
    cov, _, _, _ = _spd_case(rng, m=12, n=3)
    cov[0, 5] = cov[5, 0] = 0.0
    ref = jarrays.cov_2_cor(cov.copy())
    np.testing.assert_allclose(tarrays.cov_2_cor(cov.copy()), ref, rtol=RTOL)
    np.testing.assert_allclose(_np(tarrays.cov_2_cor(torch.as_tensor(cov))),
                               ref, rtol=RTOL)
    z = rng.normal(size=12)
    want = jarrays.get_spatial_mean(z, cov + np.eye(12))
    assert tarrays.get_spatial_mean(z, cov + np.eye(12)) == pytest.approx(
        want, rel=RTOL)
    assert tarrays.get_spatial_mean(
        z, torch.as_tensor(cov + np.eye(12))) == pytest.approx(want, rel=RTOL)


# ---------------------------------------------------------------------------
# the slice end to end: ellipse covariance -> ordinary kriging
# ---------------------------------------------------------------------------
def _ellipse_inputs(rng, nlat=10, nlon=14):
    mask = rng.random((nlat, nlon)) < 0.2

    def field(lo, hi):
        return np.ma.masked_where(mask, rng.uniform(lo, hi, (nlat, nlon)))

    return (field(800, 2000), field(400, 900), field(-1.0, 1.0),
            field(0.5, 1.5), np.linspace(-45, 60, nlat),
            np.linspace(-175, 150, nlon))


@pytest.mark.parametrize("max_dist", [None, 3000.0])
def test_ellipse_ordinary_kriging_end_to_end(rng, max_dist):
    """JAX builder + JAX OrdinaryKriging against the port's builder (via
    convert.py) + the port's OrdinaryKriging, f64, rtol 1e-8; and the
    cross-validation on the same matrix."""
    inputs = _ellipse_inputs(rng)
    settings = dict(v=1.5, max_dist=max_dist, precision=np.float64)
    jb = EllipseCovarianceBuilder(*inputs, **settings)
    tb = ellipse_builder_from_inputs(*inputs, **settings, device="cpu")
    m = tb.covar_size
    idx = np.sort(rng.choice(m, 25, replace=False))
    obs = rng.normal(size=25)
    err = np.diag(0.1 + 0.05 * rng.random(25))
    ref = jkrig.OrdinaryKriging(np.asarray(jb.cov_ns), idx, obs, err)
    ours = tkrig.OrdinaryKriging(tb.cov_ns, idx, obs, err)
    _compare(ours, ref)
    for method in ("ordinary", "simple"):
        cv_t = t_crossval(tb.cov_ns, idx, obs, np.diag(err), method=method)
        cv_j = j_crossval(np.asarray(jb.cov_ns), idx, obs, np.diag(err),
                          method=method)
        for a, b in zip(cv_t, cv_j):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
