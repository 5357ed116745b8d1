"""The port's factored kriging (``models.lowrank``) against the JAX
package on the CPU, and the repair-to-ensemble slice as a whole.

Both packages krige the same factored covariance: the reference
``LowRankPSD``'s three arrays go through
``convert.lowrank_psd_from_arrays``. The ensemble's standard normals are
the reference's own, replayed from its key sequence. Every output is held
to 1e-9 of its largest magnitude in f64 and 1e-4 in f32; the slice as a
whole (builder, clip, ensemble) to 1e-7 in f64.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eigsh import JDTYPE, reference_draws

from glomargridding_tpu.models import lowrank as jlr
from glomargridding_tpu.models.ellipse import EllipseCovarianceBuilder
from glomargridding_tpu.models.kernel_kriging import (
    pad_month_observations as j_pad_months,
)
from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.models import kriging as tkrig
from glomargridding_tpu_torch.models import lowrank as tlr
from glomargridding_tpu_torch.models.kernel_kriging import (
    _loo_from_K,
    pad_month_observations,
)
from glomargridding_tpu_torch.ops import covariance_tools as tct
from glomargridding_tpu_torch.utils.profiling import COUNTS

torch.set_num_threads(2)

TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
DTYPES = [torch.float64, torch.float32]
N, R, M = 240, 24, 40


def _close(ours, theirs, dtype, tol=None):
    theirs = np.asarray(theirs)
    ours = ours.numpy()
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    scale = max(np.max(np.abs(theirs)), 1e-30)
    assert np.max(np.abs(ours - theirs)) <= (tol or TOL[dtype]) * scale


def _problem(rng, dtype, n=N, r=R, m=M, pad=0):
    """A factored covariance (non-uniform floor, scaled columns, `pad`
    zero-gain columns) in both packages, and one month of observations."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    V = np.linalg.qr(rng.normal(size=(n, r)))[0]
    V = (V * rng.uniform(0.7, 1.3, size=(n, 1))).astype(npd)
    g = np.sort(rng.uniform(0.5, 6.0, r))[::-1].astype(npd)
    f = rng.uniform(0.05, 0.2, n).astype(npd)
    jpsd = jct.LowRankPSD(jnp.asarray(V), jnp.asarray(g), jnp.asarray(f))
    if pad:
        jpsd = jpsd.pad_rank(r + pad)
    tpsd = convert.lowrank_psd_from_arrays(
        np.asarray(jpsd.vectors), np.asarray(jpsd.gains),
        np.asarray(jpsd.floor), device="cpu")
    idx = np.sort(rng.choice(n, m, replace=False))
    obs = rng.normal(size=m).astype(npd)
    return jpsd, tpsd, idx, obs


def _error_cov(rng, kind, dtype, m=M):
    npd = np.float64 if dtype == torch.float64 else np.float32
    e = (0.1 + 0.05 * rng.random(m)).astype(npd)
    if kind == "vector":
        return e
    if kind == "diagonal":
        return np.diag(e)
    B = rng.normal(size=(m, 3)).astype(npd) * 0.1
    return np.diag(e) + B @ B.T


def _ensemble_noise(key, n, r, m, members, dtype):
    """The reference's three draws, in its order."""
    k_state, k_obs = jax.random.split(key)
    k1, k2 = jax.random.split(k_state)
    jd = JDTYPE[dtype]
    return tuple(np.array(jax.random.normal(k, shape, jd)) for k, shape in (
        (k1, (n, members)), (k2, (r, members)), (k_obs, (m, members))))


E_KINDS = ["vector", "diagonal", "dense"]


def test_convert_lowrank_psd(rng):
    jpsd, tpsd, _, _ = _problem(rng, torch.float32)
    assert isinstance(tpsd, tct.LowRankPSD)
    assert tpsd.vectors.dtype == torch.float32
    assert tpsd.vectors.device.type == "cpu"
    _close(tpsd.to_dense(), jpsd.to_dense(), torch.float32)
    V, g, f = (np.asarray(a) for a in (jpsd.vectors, jpsd.gains, jpsd.floor))
    with pytest.raises(ValueError, match="do not match"):
        convert.lowrank_psd_from_arrays(V, g[:-1], f, device="cpu")
    with pytest.raises(ValueError, match=r"\(n, r\)"):
        convert.lowrank_psd_from_arrays(V[:, 0], g, f, device="cpu")
    kept = convert.lowrank_psd_from_arrays(torch.from_numpy(V), g, f)
    assert kept.gains.device.type == "cpu"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", E_KINDS)
def test_lowrank_kriging_matches_reference(rng, kind, dtype):
    jpsd, tpsd, idx, obs = _problem(rng, dtype, pad=8)
    E = _error_cov(rng, kind, dtype)
    ours = tlr.lowrank_kriging(tpsd, idx, obs, E)
    theirs = jlr.lowrank_kriging(jpsd, idx, obs, E)
    assert isinstance(ours, tlr.LowRankKrigingResult)
    for a, b in zip(ours, theirs):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", E_KINDS)
def test_lowrank_ensemble_step_matches_reference(rng, kind, dtype):
    jpsd, tpsd, idx, obs = _problem(rng, dtype)
    E = _error_cov(rng, kind, dtype)
    key = jax.random.key(9)
    noise = _ensemble_noise(key, N, R, M, 6, dtype)
    res_t, mem_t = tlr.lowrank_ensemble_step(tpsd, idx, obs, E, n_members=6,
                                             noise=noise)
    res_j, mem_j = jlr.lowrank_ensemble_step(jpsd, idx, obs, E, key, 6)
    for a, b in zip(res_t, res_j):
        _close(a, b, dtype)
    _close(mem_t, mem_j, dtype)
    # the field does not depend on the draws
    _close(res_t.field, jlr.lowrank_kriging(jpsd, idx, obs, E).field, dtype)


def test_ensemble_generator_and_noise_checks(rng):
    _, tpsd, idx, obs = _problem(rng, torch.float64)
    E = _error_cov(rng, "vector", torch.float64)
    gen = torch.Generator().manual_seed(5)
    _, a = tlr.lowrank_ensemble_step(tpsd, idx, obs, E, gen, 4)
    gen.manual_seed(5)
    _, b = tlr.lowrank_ensemble_step(tpsd, idx, obs, E, gen, n_members=4)
    assert a.shape == (4, N)
    torch.testing.assert_close(a, b)
    # the generator draws z1, z2, zo in the documented order
    gen.manual_seed(5)
    noise = [torch.randn(s, dtype=torch.float64, generator=gen)
             for s in ((N, 4), (R, 4), (M, 4))]
    _, c = tlr.lowrank_ensemble_step(tpsd, idx, obs, E, n_members=4,
                                     noise=noise)
    torch.testing.assert_close(a, c)
    with pytest.raises(ValueError, match="noise has shape"):
        tlr.lowrank_ensemble_step(tpsd, idx, obs, E, n_members=5,
                                  noise=noise)
    with pytest.raises(ValueError, match="noise must hold"):
        tlr.lowrank_ensemble_step(tpsd, idx, obs, E, n_members=4,
                                  noise=noise[:2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_woodbury_route_matches_dense_route(rng, dtype):
    """Diagonal E (Woodbury, r-sized solves, one refinement step) against
    the same E through the m-sized Cholesky, in the port alone."""
    _, tpsd, idx, obs = _problem(rng, dtype, pad=8)
    e = _error_cov(rng, "vector", dtype)
    key = jax.random.key(2)
    noise = _ensemble_noise(key, N, R + 8, M, 5, dtype)
    V, g, f = tpsd.vectors, tpsd.gains, tpsd.floor
    args = (torch.from_numpy(idx), torch.from_numpy(obs), 5)
    wood = tlr._lowrank_solve(V, g, f, torch.from_numpy(e), *args,
                              e_diag=True, noise=noise)
    chol = tlr._lowrank_solve(V, g, f, torch.from_numpy(np.diag(e)), *args,
                              e_diag=False, noise=noise)
    # a 1-D E without the flag still takes the Cholesky route, correctly
    bypass = tlr._lowrank_solve(V, g, f, torch.from_numpy(e), *args,
                                e_diag=False, noise=noise)
    tol = 1e-9 if dtype == torch.float64 else 2e-4
    for a, b, c in zip(wood, chol, bypass):
        _close(a, b.numpy(), dtype, tol)
        _close(c, b.numpy(), dtype, tol)
    assert tlr._is_diagonal(torch.from_numpy(e))
    assert tlr._is_diagonal(torch.from_numpy(np.diag(e)))
    assert tlr._is_diagonal(torch.from_numpy(np.stack([np.diag(e)] * 2)))
    assert not tlr._is_diagonal(
        torch.from_numpy(_error_cov(rng, "dense", dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", E_KINDS)
def test_lowrank_months_scan_matches_reference(rng, kind, dtype):
    """Three months (one ragged, padded): the reference's scan, and the
    port's own per-month calls."""
    jpsd, tpsd, _, _ = _problem(rng, dtype)
    npd = obs_dtype = np.float64 if dtype == torch.float64 else np.float32
    T, members = 3, 4
    sizes = [M, M - 7, M]
    idx_l = [np.sort(rng.choice(N, s, replace=False)) for s in sizes]
    obs_l = [rng.normal(size=s).astype(obs_dtype) for s in sizes]
    err_l = [_error_cov(rng, "dense" if kind == "dense" else "diagonal",
                        dtype, s) for s in sizes]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        idx_m, obs_m, err_m = pad_month_observations(idx_l, obs_l, err_l)
        j_idx, j_obs, j_err = j_pad_months(idx_l, obs_l, err_l)
    np.testing.assert_array_equal(np.asarray(idx_m), np.asarray(j_idx))
    idx_m, obs_m, err_m = (np.asarray(a) for a in (idx_m, obs_m, err_m))
    obs_m, err_m = obs_m.astype(npd), err_m.astype(npd)
    if kind == "vector":
        err_m = np.stack([np.diag(e) for e in err_m])
    key = jax.random.key(13)
    keys = jax.random.split(key, T)
    noise = [_ensemble_noise(keys[t], N, R, M, members, dtype)
             for t in range(T)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res_t, mem_t = tlr.lowrank_months_scan(
            tpsd, idx_m, obs_m, err_m, n_members=members, noise=noise)
        res_j, mem_j = jlr.lowrank_months_scan(
            jpsd, idx_m, obs_m, err_m, key, n_members=members)
    assert mem_t.shape == (T, members, N)
    for a, b in zip(res_t, res_j):
        _close(a, b, dtype)
    _close(mem_t, mem_j, dtype)
    _check_months_one_by_one(tpsd, (idx_m, obs_m, err_m), members, noise,
                             res_t, mem_t)
    # diagnostics off: the field stays, the diagonals are zero
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bare, none = tlr.lowrank_months_scan(tpsd, idx_m, obs_m, err_m,
                                             diagnostics=False)
    assert none.shape == (T, 0, N)
    _close(bare.field, res_j.field, dtype)
    assert not bare.uncertainty.any() and not bare.constraint_mask.any()


def _check_months_one_by_one(tpsd, months, members, noise, res_t, mem_t):
    """Each month of the scan equals the port's own call on it."""
    idx_m, obs_m, err_m = months
    for t in range(len(idx_m)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one, mem = tlr.lowrank_ensemble_step(
                tpsd, idx_m[t], obs_m[t], err_m[t], n_members=members,
                noise=noise[t])
        for a, b in zip(res_t, one):
            torch.testing.assert_close(a[t], b)
        torch.testing.assert_close(mem_t[t], mem)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_members_from_states_matches_reference(rng, dtype):
    jpsd, tpsd, idx, obs = _problem(rng, dtype)
    E = _error_cov(rng, "dense", dtype)
    states = rng.normal(size=(5, N)).astype(obs.dtype)
    eps = 0.1 * rng.normal(size=(5, M)).astype(obs.dtype)
    ours = tlr.lowrank_members_from_states(tpsd, idx, obs, E, states, eps)
    theirs = jlr.lowrank_members_from_states(jpsd, idx, obs, E, states, eps)
    _close(ours, theirs, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["ordinary", "simple"])
@pytest.mark.parametrize("kind", ["vector", "dense"])
def test_lowrank_crossval_matches_reference(rng, kind, method, dtype):
    jpsd, tpsd, idx, obs = _problem(rng, dtype)
    E = _error_cov(rng, kind, dtype)
    ours = tlr.lowrank_crossval(tpsd, idx, obs, E, mean=0.2, method=method)
    theirs = jlr.lowrank_crossval(jpsd, idx, obs, E, mean=0.2, method=method)
    assert type(ours).__name__ == type(theirs).__name__ == "CrossValResult"
    for a, b in zip(ours, theirs):
        _close(a, b, dtype)
    if dtype == torch.float64:
        K = tpsd.to_dense()[np.ix_(idx, idx)] + torch.from_numpy(
            np.diag(E) if kind == "vector" else E)
        for a, b in zip(ours, _loo_from_K(K, torch.from_numpy(obs), 0.2,
                                          method)):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="Unknown kriging method"):
        tlr.lowrank_crossval(tpsd, idx, obs, E, method="universal")


@pytest.mark.parametrize("kind", E_KINDS)
def test_factored_path_matches_dense_ordinary_kriging(rng, kind):
    """Field, uncertainty and constraint mask off the factors against
    the port's dense OrdinaryKriging on to_dense()."""
    _, tpsd, idx, obs = _problem(rng, torch.float64, pad=8)
    E = _error_cov(rng, kind, torch.float64)
    res = tlr.lowrank_kriging(tpsd, idx, obs, E)
    before = COUNTS.copy()
    dense = tkrig.OrdinaryKriging(
        tpsd.to_dense(), idx, obs, np.diag(E) if kind == "vector" else E)
    want = (dense.solve(), dense.get_uncertainty(), dense.constraint_mask())
    assert COUNTS["kriging.solve.lu"] == before["kriging.solve.lu"]
    assert COUNTS["kriging.solve.cholesky"] > before["kriging.solve.cholesky"]
    for a, b in zip(res, want):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_duplicate_indices_warn(rng):
    _, tpsd, idx, obs = _problem(rng, torch.float64)
    e = _error_cov(rng, "vector", torch.float64)
    dup = idx.copy()
    dup[1] = dup[0]
    with pytest.warns(UserWarning, match="multiple observations"):
        assert not tlr.check_idx_unique(dup, e)
    with pytest.warns(UserWarning, match="multiple observations"):
        tlr.lowrank_kriging(tpsd, dup, obs, e)
    # duplicates under a pad-sized error are the padding convention
    e_pad = e.copy()
    e_pad[:2] = 1e8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tlr.check_idx_unique(dup, e_pad)
        assert tlr.check_idx_unique(dup, torch.from_numpy(np.diag(e_pad)))
        assert tlr.check_idx_unique(idx)


# ---------------------------------------------------------------------------
# the slice as a whole: covariance -> clip -> pad -> ensemble
# ---------------------------------------------------------------------------
def _ellipse_inputs(rng, nlat=12, nlon=24):
    def field(lo, hi):
        return rng.uniform(lo, hi, (nlat, nlon))

    return (field(4000, 8000), field(2500, 5000), field(-1.0, 1.0),
            field(0.5, 1.5), np.linspace(-82.5, 82.5, nlat),
            np.linspace(-172.5, 172.5, nlon))


def test_repair_to_ensemble_slice_matches_reference(rng):
    """A 12 x 24 grid, 60 observations, 8 members, f64: the JAX builder,
    clip and ensemble step against the port's chain, to 1e-7."""
    inputs = _ellipse_inputs(rng)
    settings = dict(v=1.5, precision=np.float64)
    jcov = EllipseCovarianceBuilder(*inputs, **settings).cov_ns
    tcov = convert.ellipse_builder_from_inputs(
        *inputs, **settings, device="cpu").cov_ns
    n = tcov.shape[0]
    assert n == 288
    key_clip, key_ens = jax.random.key(21), jax.random.key(22)
    clip = dict(target_variance_fraction=0.9, k0=32, max_rank=256, n_iter=4,
                rank_multiple=8)
    jpsd = jct.explained_variance_clip_lowrank(
        jnp.asarray(jcov), key=key_clip, **clip).pad_rank(16)
    tpsd = tct.explained_variance_clip_lowrank(
        tcov, draw=reference_draws(key_clip), **clip).pad_rank(16)
    assert (tpsd.rank, tpsd.effective_rank) == (
        jpsd.rank, jpsd.effective_rank)
    assert tpsd.trace() == pytest.approx(float(torch.trace(tcov)), rel=1e-9)

    idx = np.sort(rng.choice(n, 60, replace=False))
    truth = np.asarray(jpsd.draw(jax.random.key(23), 1))[0]
    e = 0.05 + 0.05 * rng.random(60)
    obs = truth[idx] + np.sqrt(e) * rng.normal(size=60)
    # a Ritz vector is defined up to sign: where the two clips chose
    # opposite signs, the port is given the negated normal, so that both
    # ensembles draw the same states
    z1, z2, zo = _ensemble_noise(key_ens, n, tpsd.rank, 60, 8, torch.float64)
    sign = np.sign(np.sum(tpsd.vectors.numpy() * np.asarray(jpsd.vectors),
                          axis=0))
    sign[sign == 0] = 1.0  # zero-gain padding columns
    noise = (z1, sign[:, None] * z2, zo)
    res_t, mem_t = tlr.lowrank_ensemble_step(tpsd, idx, obs, e, n_members=8,
                                             noise=noise)
    res_j, mem_j = jlr.lowrank_ensemble_step(jpsd, idx, obs, e, key_ens, 8)
    for a, b in zip(res_t, res_j):
        _close(a, b, torch.float64, 1e-7)
    _close(mem_t, mem_j, torch.float64, 1e-7)
    cv_t = tlr.lowrank_crossval(tpsd, idx, obs, e)
    cv_j = jlr.lowrank_crossval(jpsd, idx, obs, e)
    for a, b in zip(cv_t, cv_j):
        _close(a, b, torch.float64, 1e-7)
