"""The port's two-stage stochastic kriging (``models.stochastic``) against
the JAX package on the CPU, f64, to 1e-9 of each output's magnitude.

The standard normals are the reference's own, replayed from its key
sequence and injected as ``noise=``. Where a factor comes from an
eigendecomposition (the rescue of an indefinite matrix), its columns are
defined up to sign: the test reads the signs off the two factors and
negates the matching normals, so that both packages draw the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import stochastic as jst
from glomargridding_tpu_torch.models import stochastic as tst

torch.set_num_threads(2)

TOL = 1e-9
N, M = 90, 14


def _close(ours, theirs, tol=TOL):
    theirs = np.asarray(theirs)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == theirs.shape
    scale = max(np.max(np.abs(theirs)), 1e-30)
    assert np.max(np.abs(ours - theirs)) <= tol * scale


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float64))


def _spd(rng, n=N):
    pts = rng.uniform(0, 10, (n, 2))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    return 1.5 * np.exp(-d / 3.0)


def _indefinite(rng, n=N, n_neg=5):
    """Distinct eigenvalues, the smallest `n_neg` of them negative."""
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    w = np.sort(rng.uniform(0.05, 3.0, n))
    w[:n_neg] = -np.linspace(0.3, 0.1, n_neg)
    return (Q * w) @ Q.T


def _case(rng, cov=None):
    cov = _spd(rng) if cov is None else cov
    idx = np.sort(rng.choice(N, M, replace=False))
    obs = rng.normal(size=M)
    B = 0.1 * rng.normal(size=(M, 3))
    err = np.diag(0.1 + 0.05 * rng.random(M)) + B @ B.T
    return cov, idx, obs, err


def _factor_signs(cov):
    """Signs that turn the port's eigen-repaired factor of `cov` into
    the reference's, after checking that they do."""
    F_t = tst.eigen_repaired_factor(torch.from_numpy(cov)).numpy()
    F_j = np.asarray(jst.eigen_repaired_factor(cov))
    sign = np.sign(np.sum(F_t * F_j, axis=0))
    _close(F_t * sign, F_j)
    return sign


def test_draw_factor_and_draws(rng):
    cov = _spd(rng)
    L, info = tst.draw_factor(torch.from_numpy(cov))
    assert int(info) == 0
    _close(L, jst.draw_factor(cov))
    bad = tst.draw_factor(torch.from_numpy(_indefinite(rng)))[1]
    assert int(bad) != 0
    key = jax.random.key(3)
    loc = rng.normal(size=N)
    z = _normal(key, (6, N))
    ours = tst.draws_from_factor(L, torch.from_numpy(loc), 6, noise=z)
    _close(ours, jst.draws_from_factor(key, jnp.asarray(L.numpy()),
                                       jnp.asarray(loc), 6))
    gen = torch.Generator().manual_seed(1)
    a = tst.draws_from_factor(L, torch.from_numpy(loc), 6, generator=gen)
    gen.manual_seed(1)
    want = loc + torch.randn((6, N), dtype=torch.float64,
                             generator=gen).numpy() @ L.numpy().T
    _close(a, want)


def test_eigen_repaired_factor(rng, caplog):
    cov = _indefinite(rng)
    _factor_signs(cov)
    F = tst.eigen_repaired_factor(torch.from_numpy(cov), eigen_fudge=1e-6)
    w, v = np.linalg.eigh(cov)
    repaired = (v * np.maximum(w, 1e-6)) @ v.T
    _close(F @ F.T, repaired)
    assert "Negative eigenvalues detected" in caplog.text
    with pytest.raises(ValueError, match="unexpectedly large"):
        tst.eigen_repaired_factor(torch.from_numpy(cov), strict=True)
    with pytest.raises(ValueError, match="unexpectedly large"):
        jst.eigen_repaired_factor(cov, strict=True)


@pytest.mark.parametrize("ndraws", [1, 5])
@pytest.mark.parametrize("matrix", ["spd", "indefinite"])
def test_mv_normal_draw_matches_reference(rng, matrix, ndraws):
    cov = _spd(rng) if matrix == "spd" else _indefinite(rng)
    loc = rng.normal(size=N)
    key = jax.random.key(8)
    z = _normal(key, (ndraws, N))
    if matrix == "indefinite":
        z = z * _factor_signs(cov)[None, :]
    ours = tst.mv_normal_draw(loc, cov, ndraws, noise=z, device="cpu")
    theirs = jst.mv_normal_draw(key, loc, cov, ndraws)
    assert ours.shape == ((N,) if ndraws == 1 else (ndraws, N))
    assert np.isfinite(ours.numpy()).all()
    _close(ours, theirs)


def test_mv_normal_draw_arguments(rng):
    cov = _spd(rng, 12)
    with pytest.raises(ValueError, match="2D"):
        tst.mv_normal_draw(np.zeros(12), cov[0], device="cpu")
    with pytest.raises(ValueError, match="square"):
        tst.mv_normal_draw(np.zeros(12), cov[:, :5], device="cpu")
    with pytest.raises(ValueError, match="unexpectedly large"):
        tst.mv_normal_draw(np.zeros(N), _indefinite(rng), strict=True,
                           device="cpu")
    a = tst.scipy_mv_normal_draw(np.zeros(12), cov, 3, device="cpu")
    b = tst.scipy_mv_normal_draw(np.zeros(12), cov, 3, device="cpu")
    assert a.shape == (3, 12) and not torch.equal(a, b)
    gen = torch.Generator().manual_seed(2)
    c = tst.mv_normal_draw(np.zeros(12), cov, 400, generator=gen,
                           device="cpu")
    assert abs(float(c.var(0).mean()) - 1.5) < 0.2


@pytest.mark.parametrize("convention", ["reference", "textbook"])
def test_stochastic_kriging_matches_reference(rng, convention):
    cov, idx, obs, err = _case(rng)
    key = jax.random.key(4)
    key_state, key_obs = jax.random.split(key)
    noise = (_normal(key_state, (N,)), _normal(key_obs, (M,)))
    ours = tst.StochasticKriging(cov, idx, obs, err, uncertainty=convention,
                                 device="cpu")
    theirs = jst.StochasticKriging(cov, idx, obs, err,
                                   uncertainty=convention)
    member_t = ours.solve(noise=noise)
    member_j = theirs.solve(key=key)
    _close(member_t, member_j)
    for name in ("gridded_field", "simulated_obs", "simulated_grid",
                 "epsilon", "kriging_weights", "simple_kriging_weights"):
        _close(getattr(ours, name), getattr(theirs, name))
    _close(ours.get_uncertainty(), theirs.get_uncertainty())
    _close(ours.constraint_mask(), theirs.constraint_mask())
    # member = field + epsilon, epsilon = simulated grid - state
    torch.testing.assert_close(member_t, ours.gridded_field + ours.epsilon)


def test_stochastic_kriging_predrawn_state(rng):
    cov, idx, obs, err = _case(rng)
    key = jax.random.key(6)
    _, key_obs = jax.random.split(key)
    states_j = jst.precompute_states(jax.random.key(5), 3, covariance=cov)
    states_t = tst.precompute_states(
        3, covariance=cov, noise=_normal(jax.random.key(5), (3, N)),
        device="cpu")
    _close(states_t, states_j)
    ours = tst.StochasticKriging(cov, idx, obs, err, device="cpu")
    theirs = jst.StochasticKriging(cov, idx, obs, err)
    member_t = ours.solve(simulated_state=states_t[1],
                          noise=(None, _normal(key_obs, (M,))))
    member_j = theirs.solve(simulated_state=states_j[1], key=key)
    _close(member_t, member_j)
    _close(ours.simulated_obs, theirs.simulated_obs)
    # no noise, no generator: a fresh seed each call
    a = ours.solve(simulated_state=states_t[1])
    b = ours.solve(simulated_state=states_t[1])
    assert a.shape == (N,) and not torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    c = ours.solve(generator=gen)
    gen.manual_seed(3)
    torch.testing.assert_close(c, ours.solve(generator=gen))


@pytest.mark.parametrize("convention", ["reference", "textbook"])
def test_kriging_weights_from_inverse(rng, convention):
    cov, idx, obs, err = _case(rng)
    inv = np.linalg.inv(cov[np.ix_(idx, idx)] + err)
    ours = tst.StochasticKriging(cov, idx, obs, err, uncertainty=convention,
                                 device="cpu")
    theirs = jst.StochasticKriging(cov, idx, obs, err,
                                   uncertainty=convention)
    ours.kriging_weights_from_inverse(inv)
    theirs.kriging_weights_from_inverse(inv)
    _close(ours.kriging_weights, theirs.kriging_weights)
    _close(ours.simple_kriging_weights, theirs.simple_kriging_weights)
    _close(ours.get_uncertainty(), theirs.get_uncertainty())
    _close(ours.constraint_mask(), theirs.constraint_mask())
    key = jax.random.key(10)
    key_state, key_obs = jax.random.split(key)
    member_t = ours.solve(noise=(_normal(key_state, (N,)),
                                 _normal(key_obs, (M,))))
    _close(member_t, theirs.solve(key=key), 1e-8)
    # and the weights agree with the factorisation's
    fresh = tst.StochasticKriging(cov, idx, obs, err, device="cpu")
    fresh.get_kriging_weights()
    torch.testing.assert_close(ours.kriging_weights, fresh.kriging_weights,
                               rtol=1e-7, atol=1e-9)
    with pytest.raises(ValueError, match="side length"):
        ours.kriging_weights_from_inverse(inv[:-1, :-1])
    injected = tst.StochasticKriging(cov, idx, obs, err, device="cpu")
    injected.set_simple_kriging_weights(fresh.simple_kriging_weights.numpy())
    torch.testing.assert_close(injected.constraint_mask(),
                               fresh.constraint_mask())


def test_stochastic_kriging_arguments(rng):
    cov, idx, obs, err = _case(rng)
    with pytest.raises(ValueError, match="must be provided"):
        tst.StochasticKriging(cov, idx, obs, None, device="cpu")
    with pytest.raises(ValueError, match="convention"):
        tst.StochasticKriging(cov, idx, obs, err, uncertainty="other",
                              device="cpu")
    k = tst.StochasticKriging(cov, idx, obs, err, device="cpu")
    with pytest.raises(KeyError):
        k.get_uncertainty()
    with pytest.raises(KeyError):
        k.constraint_mask()
    with pytest.raises(ValueError, match="provide either"):
        tst.precompute_states(2, device="cpu")
    # the spectral route (held against the JAX package in
    # test_torch_sphere.py)
    states = tst.precompute_states(
        2, corr_fn=lambda g: np.exp(-g), variance=1.0,
        lats_deg=np.arange(-60.0, 61.0, 30.0),
        lons_deg=np.arange(0.0, 360.0, 60.0), device="cpu")
    assert states.shape == (2, 30) and bool(torch.isfinite(states).all())


def test_stochastic_kriging_rescues_an_indefinite_covariance(rng):
    """Cholesky of C fails: both packages redraw the state through the
    eigen-repaired factor and still agree."""
    cov, idx, obs, err = _case(rng, _indefinite(rng))
    # keep the observation system solvable: a generous error variance
    err = err + 0.5 * np.eye(M)
    key = jax.random.key(12)
    key_state, key_obs = jax.random.split(key)
    z_state = _normal(key_state, (1, N))[0] * _factor_signs(cov)
    ours = tst.StochasticKriging(cov, idx, obs, err, device="cpu")
    theirs = jst.StochasticKriging(cov, idx, obs, err)
    member_t = ours.solve(noise=(z_state, _normal(key_obs, (M,))))
    member_j = theirs.solve(key=key)
    assert np.isfinite(member_t.numpy()).all()
    _close(member_t, member_j, 1e-8)


@pytest.mark.parametrize("matrix", ["spd", "indefinite"])
def test_batched_ensemble_step_matches_reference(rng, matrix):
    cov, idx, obs, err = _case(
        rng, None if matrix == "spd" else _indefinite(rng))
    if matrix == "indefinite":
        err = err + 0.5 * np.eye(M)
    members = 7
    key = jax.random.key(14)
    pairs = [jax.random.split(k) for k in jax.random.split(key, members)]
    z_state = np.stack([_normal(k1, (N,)) for k1, _ in pairs])
    z_obs = np.stack([_normal(k2, (M,)) for _, k2 in pairs])
    if matrix == "indefinite":
        z_state = z_state * _factor_signs(cov)[None, :]
    mem_t, field_t = tst.batched_ensemble_step(
        cov, err, idx, obs, members, noise=(z_state, z_obs), device="cpu")
    mem_j, field_j = jst.batched_ensemble_step(key, cov, err, idx, obs,
                                               members)
    assert mem_t.shape == (members, N)
    assert np.isfinite(mem_t.numpy()).all()
    tol = TOL if matrix == "spd" else 1e-8
    _close(field_t, field_j, tol)
    _close(mem_t, mem_j, tol)
    gen = torch.Generator().manual_seed(9)
    a, _ = tst.batched_ensemble_step(cov, err, idx, obs, 3, generator=gen,
                                     device="cpu")
    gen.manual_seed(9)
    b, _ = tst.batched_ensemble_step(torch.from_numpy(cov), err, idx, obs, 3,
                                     generator=gen)
    torch.testing.assert_close(a, b)


def test_dense_members_match_the_factored_ones(rng):
    """Same states and observation noise: ``batched_ensemble_step`` on
    to_dense() against ``lowrank_members_from_states``."""
    from glomargridding_tpu_torch.models.lowrank import (
        lowrank_members_from_states,
    )
    from glomargridding_tpu_torch.ops.covariance_tools import LowRankPSD

    r = 12
    V = torch.from_numpy(np.linalg.qr(rng.normal(size=(N, r)))[0])
    g = torch.from_numpy(np.sort(rng.uniform(0.5, 4.0, r))[::-1].copy())
    f = torch.from_numpy(rng.uniform(0.05, 0.2, N))
    psd = LowRankPSD(V, g, f)
    _, idx, obs, err = _case(rng)
    dense = psd.to_dense()
    z_state = torch.from_numpy(rng.normal(size=(5, N)))
    z_obs = torch.from_numpy(rng.normal(size=(5, M)))
    mem, _ = tst.batched_ensemble_step(dense, err, idx, obs, 5,
                                       noise=(z_state, z_obs))
    L = torch.linalg.cholesky(dense)
    LE = torch.linalg.cholesky(torch.from_numpy(err))
    want = lowrank_members_from_states(psd, idx, obs, err, z_state @ L.T,
                                       z_obs @ LE.T)
    torch.testing.assert_close(mem, want, rtol=1e-8, atol=1e-10)
