"""The port's PSD repair (``ops.covariance_tools``) against the JAX package
on the CPU.

Same numpy matrix on both sides (the damaged kernel matrix of
``tests/test_torch_eigsh.py``: a decaying spectrum plus a small indefinite
perturbation) and, for the partial-spectrum clips, the same random start
blocks (the port's ``draw`` replays the reference's key sequence). A
repaired matrix is held to the reference's to 1e-8 of max |C| in f64 and
1e-4 in f32; a factored result is compared densified, since Ritz vectors
are defined up to sign.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eigsh import (  # noqa: F401  (the fixture is autouse)
    JDTYPE,
    damaged_kernel_cov,
    reference_draws,
    reference_locks_too,
)

from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu.utils import arrays as jarrays
from glomargridding_tpu_torch.ops import covariance_tools as tct
from glomargridding_tpu_torch.ops.eigsh import PartialSpectrumError
from glomargridding_tpu_torch.utils import arrays as tarrays

torch.set_num_threads(2)

TOL = {torch.float64: 1e-8, torch.float32: 1e-4}
DTYPES = [torch.float64, torch.float32]
N = 384
KEY = jax.random.key(11)

# the two clips: (the port's, the reference's, arguments)
CLIPS = {
    "explained_variance": (
        "explained_variance_clip", dict(target_variance_fraction=0.9)),
    "laloux": ("laloux_clip", dict(num_time_pts=40)),
}


def _cov(rng, dtype, n=N):
    return damaged_kernel_cov(n, rng).astype(JDTYPE[dtype])


def _close(ours, theirs, dtype, scale=None):
    theirs = np.asarray(theirs)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    scale = np.max(np.abs(theirs)) if scale is None else scale
    assert ours.shape == theirs.shape
    assert np.max(np.abs(ours - theirs)) <= TOL[dtype] * scale


def _partial_kw(dtype, **kw):
    """Solver arguments of a partial clip for both packages: the f32
    residual tolerance is the tightest an f32 solve reaches."""
    kw = dict(k0=48, tol=1e-6 if dtype == torch.float64 else 1e-3, **kw)
    return ({**kw, "draw": reference_draws(KEY)},
            {**kw, "key": KEY, "dtype": JDTYPE[dtype]})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spectrum", ["full", "partial", "auto"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_dense_clip_matches_reference(rng, monkeypatch, clip, spectrum,
                                      dtype):
    """Each clip of a dense matrix, by the full spectrum, the partial
    one, and "auto" on both sides of its size threshold."""
    name, kw = CLIPS[clip]
    cov = _cov(rng, dtype)
    kw_t, kw_j = (dict(kw), dict(kw))
    if spectrum != "full":
        pt, pj = _partial_kw(dtype)
        kw_t.update(pt)
        kw_j.update(pj)
    if spectrum == "auto":  # above the threshold "auto" is "partial"
        monkeypatch.setattr(tct, "_AUTO_PARTIAL_THRESHOLD", N - 1)
        monkeypatch.setattr(jct, "_AUTO_PARTIAL_THRESHOLD", N - 1)
    ours = getattr(tct, name)(cov, spectrum=spectrum, device="cpu", **kw_t)
    theirs = getattr(jct, name)(cov, spectrum=spectrum, **kw_j)
    assert isinstance(ours, torch.Tensor) and ours.dtype == dtype
    _close(ours, theirs, dtype)
    assert float(torch.linalg.eigvalsh(ours.double()).min()) > -TOL[dtype]
    if spectrum == "auto":  # and below it, "full"
        monkeypatch.setattr(tct, "_AUTO_PARTIAL_THRESHOLD", N)
        full = getattr(tct, name)(cov, spectrum="auto", device="cpu", **kw)
        _close(full, getattr(jct, name)(cov, spectrum="full", **kw), dtype)
    if clip == "explained_variance":
        assert abs(float(torch.trace(ours)) - np.trace(cov)) <= (
            TOL[dtype] * np.trace(cov) * 10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_lowrank_clip_matches_reference(rng, clip, dtype):
    """The factored clips, padded to a rank multiple: gains, floor, rank
    and the densified covariance; a callable operator gives the same."""
    cov = _cov(rng, dtype)
    pt, pj = _partial_kw(dtype, rank_multiple=16)
    if clip == "explained_variance":
        ours = tct.explained_variance_clip_lowrank(
            cov, target_variance_fraction=0.9, device="cpu", **pt)
        theirs = jct.explained_variance_clip_lowrank(
            jnp.asarray(cov), target_variance_fraction=0.9, **pj)
    else:
        ours = tct.laloux_clip_lowrank(cov, num_time_pts=40, device="cpu",
                                       **pt)
        theirs = jct.laloux_clip_lowrank(jnp.asarray(cov), num_time_pts=40,
                                         **pj)
    assert isinstance(ours, tct.LowRankPSD)
    assert ours.vectors.dtype == dtype and ours.rank % 16 == 0
    assert (ours.n, ours.rank, ours.effective_rank, ours.shape) == (
        theirs.n, theirs.rank, theirs.effective_rank, theirs.shape)
    _close(ours.gains, theirs.gains, dtype)
    _close(ours.floor, theirs.floor, dtype, scale=1.0)
    _close(ours.to_dense(), theirs.to_dense(), dtype)
    _close(ours.diagonal(), theirs.diagonal(), dtype)
    assert abs(ours.trace() - theirs.trace()) <= TOL[dtype] * theirs.trace()
    assert float(ours.gains.min()) >= 0 and float(ours.floor.min()) > 0

    # the same clip through a matvec closure
    At = torch.from_numpy(cov)
    pt, _ = _partial_kw(dtype, rank_multiple=16)
    if clip == "explained_variance":
        again = tct.explained_variance_clip(
            lambda X: At @ X, 0.9, n=N, trace=float(np.trace(cov)),
            dtype=dtype, device="cpu", **pt)
    else:
        again = tct.laloux_clip(
            lambda X: At @ X, diag=np.diag(cov).copy(), n=N, dtype=dtype,
            device="cpu", **pt)
    assert isinstance(again, tct.LowRankPSD)
    _close(again.to_dense(), theirs.to_dense(), dtype)


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_densify_guard_returns_the_factors(rng, monkeypatch, clip):
    """Past the guard a dense input comes back factored, with a warning."""
    name, kw = CLIPS[clip]
    cov = _cov(rng, torch.float64)
    monkeypatch.setattr(tct, "_DENSIFY_GUARD", 64)
    pt, pj = _partial_kw(torch.float64)
    with pytest.warns(UserWarning, match="returns the factored LowRankPSD"):
        ours = getattr(tct, name)(cov, spectrum="partial", device="cpu",
                                  **kw, **pt)
    assert isinstance(ours, tct.LowRankPSD)
    theirs = getattr(jct, name)(cov, spectrum="partial", **kw, **pj)
    _close(ours.to_dense(), theirs, torch.float64)


@pytest.mark.parametrize("itemsize,n,fits", [
    (4, 64_800, True), (8, 64_800, False), (8, 40_000, True),
    (4, 65_537, False)])
def test_densify_guard_counts_bytes_on_the_card(monkeypatch, itemsize, n,
                                                fits):
    """On a card the dense result is held to a share of its memory: the
    1-degree grid densifies in f32 on 80 GB and not in f64."""
    from types import SimpleNamespace

    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: SimpleNamespace(total_memory=85_000_000_000))
    vectors = SimpleNamespace(device=torch.device("cuda"),
                              element_size=lambda: itemsize)
    assert tct._densify_fits(SimpleNamespace(n=n, vectors=vectors)) is fits


def test_flat_spectrum_falls_back_under_auto(rng, monkeypatch):
    """A spectrum too flat for max_rank: "auto" falls back to the full
    clip, "partial" and a callable raise."""
    n = 96
    cov = np.eye(n) + 1e-3 * damaged_kernel_cov(n, rng)
    monkeypatch.setattr(tct, "_AUTO_PARTIAL_THRESHOLD", 8)
    kw = dict(k0=8, max_rank=16, device="cpu")
    out = tct.explained_variance_clip(cov, 0.9, spectrum="auto", **kw)
    _close(out, jct.explained_variance_clip(cov, 0.9, spectrum="full"),
           torch.float64)
    with pytest.raises(PartialSpectrumError):
        tct.explained_variance_clip(cov, 0.9, spectrum="partial", **kw)
    At = torch.from_numpy(cov)
    with pytest.raises(PartialSpectrumError):
        tct.explained_variance_clip(lambda X: At @ X, 0.9, n=n,
                                    trace=float(n), dtype=torch.float64,
                                    **kw)
    assert tct.__all_errors__ == (PartialSpectrumError,)


def test_clip_argument_errors(rng):
    cov = _cov(rng, torch.float64, 64)
    with pytest.raises(ValueError, match="must be"):
        tct.explained_variance_clip(cov, 1.5, device="cpu")
    with pytest.raises(ValueError, match="must be"):
        tct.explained_variance_clip_lowrank(cov, None, None, 0.0,
                                            device="cpu")
    with pytest.raises(ValueError, match="n and trace are required"):
        tct.explained_variance_clip_lowrank(lambda X: X, device="cpu")
    with pytest.raises(ValueError, match="n and diag are required"):
        tct.laloux_clip_lowrank(lambda X: X, device="cpu")
    with pytest.raises(ValueError, match="unknown spectrum"):
        tct.explained_variance_clip(cov, 0.9, spectrum="some", device="cpu")
    with pytest.raises(ValueError, match="Unknown clipping method"):
        tct.eigenvalue_clip(cov, method="nope", device="cpu")
    # top EOFs hold more than the total: the corrected-threshold message
    n = 40
    w = np.concatenate([np.full(n - 1, -0.01), [10.0]])
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    with pytest.raises(ValueError, match="A value below"):
        tct.explained_variance_clip((q * w) @ q.T, 1.0, device="cpu")


@pytest.mark.parametrize("method", ["explained_variance", "Laloux_2000"])
def test_eigenvalue_clip_dispatch(rng, method):
    cov = _cov(rng, torch.float64, 128)
    kw = dict(num_time_pts=20) if method == "Laloux_2000" else {}
    ours = tct.eigenvalue_clip(cov, method=method, device="cpu", **kw)
    _close(ours, jct.eigenvalue_clip(cov, method=method, **kw), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", ["auto", "statsmodels_default", 1e-3])
def test_simple_clipping_matches_reference(rng, threshold, dtype):
    cov = _cov(rng, dtype, 96)
    ours, meta_t = tct.simple_clipping(cov, threshold=threshold, device="cpu")
    theirs, meta_j = jct.simple_clipping(cov, threshold=threshold)
    _close(ours, theirs, dtype)
    assert sorted(meta_t) == sorted(meta_j) == [
        "determinant", "smallest_eigv", "threshold", "total_variance"]
    assert meta_t["threshold"] == pytest.approx(meta_j["threshold"],
                                                rel=10 * TOL[dtype])
    assert meta_t["total_variance"] == pytest.approx(
        meta_j["total_variance"], rel=TOL[dtype])
    assert abs(meta_t["smallest_eigv"] - meta_j["smallest_eigv"]) <= (
        TOL[dtype] * np.max(np.abs(cov)))
    with pytest.raises(TypeError, match="threshold must"):
        tct.simple_clipping(cov, threshold="other", device="cpu")


def test_perturb_cov_to_positive_definite(rng):
    cov = _cov(rng, torch.float64, 96)
    with pytest.warns(DeprecationWarning):
        ours = tct.perturb_cov_to_positive_definite(cov, "auto", device="cpu")
    with pytest.warns(DeprecationWarning):
        theirs = jct.perturb_cov_to_positive_definite(cov, "auto")
    _close(ours, theirs, torch.float64)
    spd = cov @ cov.T + np.eye(96)
    with pytest.warns(DeprecationWarning):
        same = tct.perturb_cov_to_positive_definite(spd, device="cpu")
    np.testing.assert_array_equal(same.numpy(), spd)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        tct.perturb_cov_to_positive_definite(np.triu(cov), device="cpu")


def _random_psd(rng, dtype, n=120, r=24, uniform=False):
    npd = np.float64 if dtype == torch.float64 else np.float32
    V = np.linalg.qr(rng.normal(size=(n, r)))[0].astype(npd)
    if not uniform:
        V = V * rng.uniform(0.5, 1.5, size=(n, 1)).astype(npd)
    g = np.sort(rng.uniform(0.5, 5.0, r))[::-1].astype(npd)
    f = (np.full(n, 0.3) if uniform else rng.uniform(0.1, 0.4, n)).astype(npd)
    return V, g, f


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_psd_methods_match_reference(rng, dtype):
    V, g, f = _random_psd(rng, dtype)
    ours = tct.LowRankPSD(*(torch.from_numpy(a) for a in (V, g, f)))
    theirs = jct.LowRankPSD(*(jnp.asarray(a) for a in (V, g, f)))
    assert (ours.n, ours.rank, ours.shape) == (120, 24, (120, 120))
    x1 = rng.normal(size=120).astype(V.dtype)
    x2 = rng.normal(size=(120, 5)).astype(V.dtype)
    for x in (x1, x2):
        _close(ours.matvec(x), theirs.matvec(jnp.asarray(x)), dtype)
    _close(ours.diagonal(), theirs.diagonal(), dtype)
    _close(ours.to_dense(), theirs.to_dense(), dtype)
    assert ours.trace() == pytest.approx(theirs.trace(), rel=TOL[dtype])
    assert ours.trace() == pytest.approx(
        float(np.trace(theirs.to_dense())), rel=10 * TOL[dtype])

    # draws: the reference splits its key in two and draws (n, members)
    # then (rank, members)
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    z1 = np.array(jax.random.normal(k1, (120, 7), JDTYPE[dtype]))
    z2 = np.array(jax.random.normal(k2, (24, 7), JDTYPE[dtype]))
    _close(ours.draw(7, noise=(z1, z2)), theirs.draw(key, 7), dtype)
    gen = torch.Generator().manual_seed(3)
    a = ours.draw(7, generator=gen)
    assert a.shape == (7, 120) and a.dtype == dtype
    gen.manual_seed(3)
    torch.testing.assert_close(a, ours.draw(7, generator=gen))
    with pytest.raises(ValueError, match="noise has shape"):
        ours.draw(7, noise=(z1, z2[:-1]))
    with pytest.raises(ValueError, match="noise must hold"):
        ours.draw(7, noise=(z1,))

    # padding is inert and reported
    pad_t, pad_j = ours.pad_rank(32), theirs.pad_rank(32)
    assert (pad_t.rank, pad_t.effective_rank) == (32, 24) == (
        pad_j.rank, pad_j.effective_rank)
    _close(pad_t.to_dense(), pad_j.to_dense(), dtype)
    assert ours.pad_rank(8) is ours
    with pytest.raises(ValueError, match="multiple"):
        ours.pad_rank(0)


def test_draw_covariance_is_the_factored_one(rng):
    """Many draws: their sample covariance approaches to_dense()."""
    V, g, f = _random_psd(rng, torch.float64, n=30, r=6)
    psd = tct.LowRankPSD(*(torch.from_numpy(a) for a in (V, g, f)))
    x = psd.draw(40000, generator=torch.Generator().manual_seed(0))
    sample = (x.T @ x / x.shape[0]).numpy()
    dense = psd.to_dense().numpy()
    assert np.max(np.abs(sample - dense)) <= 0.05 * np.max(np.abs(dense))


def test_host_helpers_match_reference(rng):
    vals = rng.uniform(0, 1, 30)
    for target, reverse in [(3.0, True), (3.0, False), (1e9, True)]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert tct.csum_up_to_val(vals, target, reverse) == (
                jct.csum_up_to_val(vals, target, reverse))
    with pytest.warns(UserWarning, match="empty"):
        assert tct.csum_up_to_val(np.array([]), 1.0) == (0.0, 0)
    with pytest.raises(ValueError, match="vector"):
        tct.csum_up_to_val(np.ones((2, 2)), 1.0)
    w = np.sort(rng.uniform(0, 30, 50))
    assert tct._find_index_explained_variance(w, 0.9) == (
        jct._find_index_explained_variance(w, 0.9))
    assert tct._find_index_aspect_ratio(w, 50, 10) == (
        jct._find_index_aspect_ratio(w, 50, 10))
    assert tct._find_index_aspect_ratio(w, 10, 50) == (
        jct._find_index_aspect_ratio(w, 10, 50))

    a = rng.normal(size=(6, 6))
    sym = a + a.T
    for make in (np.asarray, torch.from_numpy):
        assert tct.check_symmetric(make(sym))
        assert not tct.check_symmetric(make(a))
        small = make(np.array([[1.0, 1e-7], [-1e-6, 2.0]]))
        cleaned = tct.clean_small(small)
        np.testing.assert_array_equal(np.asarray(cleaned),
                                      np.diag([1.0, 2.0]))

    cor = np.asarray(jarrays.cov_2_cor(sym @ sym.T))
    var = rng.uniform(0.5, 2.0, 6)
    want = np.asarray(jarrays.cor_2_cov(cor.copy(), var))
    np.testing.assert_allclose(tarrays.cor_2_cov(cor.copy(), var), want,
                               rtol=1e-12)
    np.testing.assert_allclose(
        tarrays.cor_2_cov(torch.from_numpy(cor), var).numpy(), want,
        rtol=1e-12)
    np.testing.assert_allclose(
        tarrays.cor_2_cov(torch.from_numpy(cor), var, rounding=3).numpy(),
        np.asarray(jarrays.cor_2_cov(cor.copy(), var, rounding=3)),
        atol=1e-12)
