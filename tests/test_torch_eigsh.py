"""The port's partial eigensolver (``ops.eigsh``) against the JAX package
on the CPU.

Same numpy matrix on both sides (the fixture of ``tests/test_eigsh.py``:
a Gaussian kernel matrix with a decaying spectrum plus a small indefinite
low-rank perturbation), and the same random start blocks: the port's
``draw`` replays the reference's key sequence (one ``split`` per stage of
``adaptive_topk_eigh``; ``topk_eigh`` draws from its key directly).
Bounds: Ritz values to 1e-8 of theta_1 in f64 (1e-4 in f32), the
retained rank equal, Ritz vectors up to sign to 1e-6 (1e-4 in f32).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.ops import eigsh as jeig
from glomargridding_tpu_torch.ops import eigsh as teig

torch.set_num_threads(2)

VAL_TOL = {torch.float64: 1e-8, torch.float32: 1e-4}
VEC_TOL = {torch.float64: 1e-6, torch.float32: 1e-4}
JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def damaged_kernel_cov(n, rng, damage=0.05, length=0.02):
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    A = np.exp(-d2 / length)
    P = rng.normal(size=(n, 32)) / np.sqrt(n)
    A = A - damage * (P @ P.T)
    return 0.5 * (A + A.T)


def reference_draws(key, split=True):
    """The port's ``draw`` from the reference's key: the adaptive solver
    splits once per stage and draws from the sub-key; ``topk_eigh``
    (split=False) draws from the key itself, every time."""
    state = {"key": key}

    def draw(shape, dtype):
        sub = state["key"]
        if split:
            state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(
            np.array(jax.random.normal(sub, shape, JDTYPE[dtype])))

    return draw


def variance_accept(A, fraction):
    target = fraction * float(np.trace(A))

    def accept(w):
        hit = np.nonzero(np.cumsum(w) > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    return accept


def assert_pairs_match(ours, theirs, r, dtype):
    """Ritz values over theta_1 and the first r vectors up to sign."""
    (w_t, V_t), (w_j, V_j) = ours, theirs
    w_j, V_j, V_t = np.asarray(w_j), np.asarray(V_j), V_t.numpy()
    assert w_t.shape == w_j.shape and V_t.shape == V_j.shape
    assert np.max(np.abs(w_t - w_j)) <= VAL_TOL[dtype] * abs(w_j[0])
    sign = np.sign(np.sum(V_t[:, :r] * V_j[:, :r], axis=0))
    assert np.max(np.abs(V_t[:, :r] * sign - V_j[:, :r])) <= VEC_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cholqr2_matches_reference(rng, dtype):
    n, w = 700, 40
    A = damaged_kernel_cov(n, rng)
    Y = (A @ rng.normal(size=(n, w))).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    Q_t, ok_t = teig._cholqr2(torch.from_numpy(Y))
    Q_j, ok_j = jeig._cholqr2(jnp.asarray(Y))
    assert bool(ok_t) and bool(ok_j)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(Q_t.numpy(), np.asarray(Q_j), atol=tol)
    eye = (Q_t.T @ Q_t).numpy()
    np.testing.assert_allclose(eye, np.eye(w), atol=tol)
    # a Gram matrix that overflows is reported, not raised
    big = torch.from_numpy(Y.astype(np.float64)) * 1e200
    assert not bool(teig._cholqr2(big)[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_topk_eigh_matches_reference(rng, dtype):
    n, k = 512, 40
    A = damaged_kernel_cov(n, rng).astype(JDTYPE[dtype])
    key = jax.random.key(1)
    theirs = jeig.topk_eigh(jnp.asarray(A), k, key=key, dtype=JDTYPE[dtype])
    ours = teig.topk_eigh(A, k, draw=reference_draws(key, split=False),
                          device="cpu")
    assert ours[1].dtype == dtype
    assert_pairs_match(ours, theirs, 24, dtype)
    if dtype == torch.float64:
        w_full = np.linalg.eigvalsh(A)[::-1]
        np.testing.assert_allclose(ours[0][:16], w_full[:16], rtol=1e-8)


def test_topk_eigh_generator_callable_and_full_width(rng):
    """The default start block is deterministic; a generator and a
    callable operator reach the same head; k + oversample >= n is exact."""
    n, k = 300, 20
    A = damaged_kernel_cov(n, rng)
    At = torch.from_numpy(A)
    w_full = np.linalg.eigvalsh(A)[::-1]
    w0, _ = teig.topk_eigh(At, k)
    w1, _ = teig.topk_eigh(At, k)
    np.testing.assert_array_equal(w0, w1)
    gen = torch.Generator().manual_seed(7)
    w2, V2 = teig.topk_eigh(lambda X: At @ X, k, n, generator=gen,
                            dtype=torch.float64)
    assert V2.device.type == "cpu" and V2.dtype == torch.float64
    np.testing.assert_allclose(w2[:10], w_full[:10], rtol=1e-6)
    np.testing.assert_allclose(w0[:10], w_full[:10], rtol=1e-6)
    w3, V3 = teig.topk_from_callable(lambda X: A @ X.numpy(), n, k,
                                     device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(w3[:10], w_full[:10], rtol=1e-6)
    with pytest.raises(ValueError, match="n is required"):
        teig.topk_eigh(lambda X: X, k, device="cpu")
    with pytest.raises(ValueError, match="square"):
        teig.topk_eigh(np.zeros((3, 4)), 2, device="cpu")
    small = damaged_kernel_cov(24, rng)
    w, V = teig.topk_eigh(small, 24, device="cpu")
    np.testing.assert_allclose(w, np.linalg.eigvalsh(small)[::-1],
                               rtol=1e-10, atol=1e-12)
    assert V.shape == (24, 24)


jeig_lock_min_n = jeig._LOCK_MIN_N


@pytest.fixture(autouse=True)
def reference_locks_too(monkeypatch):
    """The port widens by Ritz locking at every size; the reference does
    so only from ``_LOCK_MIN_N`` points on. Step-for-step parity needs
    the same flavour, so the reference's threshold is lowered to 0 for
    the tests of this file (as ``tests/test_eigsh.py`` itself does)."""
    monkeypatch.setattr(jeig, "_LOCK_MIN_N", 0)


# name: (fraction of the trace, solver arguments, the log line that shows
# the case took the intended path)
ADAPTIVE_CASES = {
    "structural_accept": (0.5, dict(k0=64), "structural accept"),
    "residual_accept": (0.9, dict(k0=48, tol=1e-6), "round=0"),
    "extra_round": (0.9, dict(k0=48, n_iter=1, tol=1e-7), "round=1"),
    "locked_widening": (0.9, dict(k0=8), "widening 8 -> 16"),
    "rank_multiple": (0.9, dict(k0=48, tol=1e-6, rank_multiple=16),
                      "round=0"),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(ADAPTIVE_CASES))
def test_adaptive_topk_eigh_matches_reference(rng, caplog, name, dtype):
    fraction, kw, marker = ADAPTIVE_CASES[name]
    n = 512
    A = damaged_kernel_cov(n, rng).astype(JDTYPE[dtype])
    accept = variance_accept(A.astype(np.float64), fraction)
    if dtype == torch.float32:  # the tolerances an f32 solve can reach
        kw = {**kw, **({"tol": 1e-3} if "tol" in kw else {})}
        if name == "extra_round":
            kw["tol"] = 2e-4
    key = jax.random.key(7)
    w_j, V_j, r_j = jeig.adaptive_topk_eigh(
        jnp.asarray(A), accept, key=key, dtype=JDTYPE[dtype], **kw)
    with caplog.at_level(logging.INFO, logger=teig.logger.name):
        w_t, V_t, r_t = teig.adaptive_topk_eigh(
            A, accept, draw=reference_draws(key), device="cpu", **kw)
    assert marker in caplog.text, caplog.text
    assert r_t == r_j
    assert_pairs_match((w_t, V_t), (w_j, V_j), r_t, dtype)
    if name == "rank_multiple":
        assert V_t.shape[1] % 16 == 0 and V_t.shape[1] >= r_t
    else:
        assert V_t.shape[1] == r_t
    if dtype == torch.float64:
        w_full = np.linalg.eigvalsh(A)[::-1]
        np.testing.assert_allclose(w_t[:r_t], w_full[:r_t], rtol=1e-6)


def test_adaptive_locked_widening(rng, caplog, monkeypatch):
    """Ritz locking, which the port uses at every size, freezes
    converged pairs and still lands on the reference's jointly widened
    answer (its flavour below 200,000 points) and on LAPACK's."""
    monkeypatch.setattr(jeig, "_LOCK_MIN_N", jeig_lock_min_n)
    n = 512
    A = damaged_kernel_cov(n, rng)
    accept = variance_accept(A, 0.9)
    key = jax.random.key(3)
    w_j, V_j, r_j = jeig.adaptive_topk_eigh(jnp.asarray(A), accept, k0=8,
                                            key=key)
    with caplog.at_level(logging.INFO, logger=teig.logger.name):
        w_t, V_t, r_t = teig.adaptive_topk_eigh(
            A, accept, k0=8, draw=reference_draws(key), device="cpu")
    locks = [rec.args[3] for rec in caplog.records
             if "widening" in rec.getMessage()]
    assert locks and max(locks) > 0, caplog.text
    assert r_t == r_j
    w_full = np.linalg.eigvalsh(A)[::-1]
    np.testing.assert_allclose(w_t[:r_t], w_full[:r_t], rtol=1e-8)
    assert np.max(np.abs(w_t[:r_t] - np.asarray(w_j)[:r_t])) <= 1e-8 * w_j[0]
    V_t, V_j = V_t.numpy(), np.asarray(V_j)
    sign = np.sign(np.sum(V_t * V_j, axis=0))
    assert np.max(np.abs(V_t * sign - V_j)) <= 1e-6


def test_adaptive_predict_narrows_the_widening(rng, caplog):
    """A rank prediction narrows the doubling and reaches the same
    pairs as the reference given the same prediction."""
    n = 512
    A = damaged_kernel_cov(n, rng)
    accept = variance_accept(A, 0.9)

    def predict(w, k):
        return k + 4

    key = jax.random.key(5)
    w_j, V_j, r_j = jeig.adaptive_topk_eigh(
        jnp.asarray(A), accept, k0=16, key=key, predict=predict,
        rank_multiple=4)
    with caplog.at_level(logging.INFO, logger=teig.logger.name):
        w_t, V_t, r_t = teig.adaptive_topk_eigh(
            A, accept, k0=16, draw=reference_draws(key), predict=predict,
            rank_multiple=4, device="cpu")
    steps = [(rec.args[0], rec.args[1], rec.args[2])
             for rec in caplog.records if "widening" in rec.getMessage()]
    assert steps and all(k < nxt <= dbl for k, nxt, dbl in steps), steps
    assert any(nxt < dbl for _, nxt, dbl in steps), steps
    assert r_t == r_j
    assert_pairs_match((w_t, V_t), (w_j, V_j), r_t, torch.float64)


def test_householder_rescue(monkeypatch):
    """An operator whose Gram matrix overflows (entries ~1e200 in f64)
    takes the Householder-QR rescue in both solvers and still returns
    the reference's leading pairs."""
    calls = {"n": 0}
    real = teig._householder_iterate

    def spy(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(teig, "_householder_iterate", spy)
    n = 128
    rng = np.random.default_rng(5)
    Qb = np.linalg.qr(rng.normal(size=(n, n)))[0]
    s = np.exp(-np.arange(n) / 3.0)
    scale = 1e200
    A = scale * ((Qb * s[None, :]) @ Qb.T)
    key = jax.random.key(2)

    w_j, V_j = jeig.topk_eigh(jnp.asarray(A), 5, key=key, oversample=16)
    w_t, V_t = teig.topk_eigh(A, 5, draw=reference_draws(key, split=False),
                              oversample=16, device="cpu")
    assert calls["n"] == 1
    np.testing.assert_allclose(w_t, scale * s[:5], rtol=1e-8)
    assert_pairs_match((w_t, V_t), (w_j, V_j), 5, torch.float64)
    # a generator is wound back, so the rescue restarts from the block
    # the failed iteration started from
    gen = torch.Generator().manual_seed(11)
    w_g, _ = teig.topk_eigh(A, 5, generator=gen, oversample=16)
    np.testing.assert_allclose(w_g, scale * s[:5], rtol=1e-8)
    after = torch.randn(3, generator=gen)
    gen.manual_seed(11)
    torch.randn((n, 21), dtype=torch.float64, generator=gen)
    torch.testing.assert_close(after, torch.randn(3, generator=gen))

    calls["n"] = 0
    w_j, V_j, r_j = jeig.adaptive_topk_eigh(
        jnp.asarray(A), lambda w: 3, k0=8, key=key, oversample=16)
    w_t, V_t, r_t = teig.adaptive_topk_eigh(
        A, lambda w: 3, k0=8, draw=reference_draws(key), oversample=16,
        device="cpu")
    assert calls["n"] >= 1 and r_t == r_j == 3
    assert_pairs_match((w_t, V_t), (w_j, V_j), 3, torch.float64)


def test_partial_spectrum_error_and_whole_space(rng):
    """A flat spectrum cannot be clipped within max_rank; a block as wide
    as the space is solved exactly."""
    n = 96
    A = np.eye(n) + 1e-3 * damaged_kernel_cov(n, rng)
    accept = variance_accept(A, 0.9)
    with pytest.raises(teig.PartialSpectrumError, match="max_rank=16"):
        teig.adaptive_topk_eigh(A, accept, k0=8, max_rank=16, device="cpu")
    assert issubclass(teig.PartialSpectrumError, ValueError)
    w, V, r = teig.adaptive_topk_eigh(A, accept, k0=8, max_rank=n,
                                      device="cpu")
    w_full = np.linalg.eigvalsh(A)[::-1]
    np.testing.assert_allclose(w, w_full, rtol=1e-10)
    assert r == accept(w_full) and V.shape == (n, r)
    with pytest.raises(ValueError, match="k must be"):
        teig.adaptive_topk_eigh(A, accept, k0=0, device="cpu")


def test_residual_helpers_match_reference(rng):
    n, w = 200, 12
    A = damaged_kernel_cov(n, rng)
    Q = np.linalg.qr(rng.normal(size=(n, w)))[0]
    B = A @ Q
    theta, U = np.linalg.eigh(Q.T @ B)
    theta, U = theta[::-1].copy(), U[:, ::-1].copy()
    args_t = [torch.from_numpy(a) for a in (Q, B, U, theta)]
    args_j = [jnp.asarray(a) for a in (Q, B, U, theta)]
    # the port keeps no separate residual-norm helper: the third output
    # of its Ritz rotation is the reference's
    np.testing.assert_allclose(
        teig._rotate_ritz(*args_t)[2].numpy(),
        np.asarray(jeig._ritz_residual_norms(*args_j)), rtol=1e-10)
    for got, want in zip(teig._rotate_ritz(*args_t),
                         jeig._rotate_ritz(*args_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-14)
    mask = (np.arange(w) < 7).astype(np.float64)
    got = teig._resid_and_vectors(*args_t, torch.from_numpy(mask))
    want = jeig._resid_and_vectors(*args_j, jnp.asarray(mask))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-14)
