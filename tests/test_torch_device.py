"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU.

With numpy inputs and no ``device`` an entry point goes to ``cuda``. On a
machine without a card (here made so by ``torch.cuda.is_available``
returning False) it raises ``RuntimeError`` instead of running on the
CPU. With ``device="cpu"`` it still matches the JAX package on the same
numpy inputs, f64, to the parity tests' bounds: rtol 1e-8, atol 1e-10,
and for the stream operator (whose diagonal term is f32) its own tests'
2e-4 against the dense product.
The card side runs the same ``CASES`` with no device named and asserts
CUDA outputs (``tests/test_torch_cuda.py``). The deprecated function
forms of the kriging classes are held to their DeprecationWarning here.
"""

import dataclasses
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.models import kriging as jkrig
from glomargridding_tpu.models import lowrank as jlr
from glomargridding_tpu.models import stochastic as jst
from glomargridding_tpu.models.ellipse import covariance as jcov
from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu.ops import distances as jdist
from glomargridding_tpu.ops import eigsh as jeig
from glomargridding_tpu.ops.variogram import MaternVariogram
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.models import kriging as tkrig
from glomargridding_tpu_torch.models import lowrank as tlr
from glomargridding_tpu_torch.models import stochastic as tst
from glomargridding_tpu_torch.models.ellipse import covariance as tcov
from glomargridding_tpu_torch.ops import covariance_tools as tct
from glomargridding_tpu_torch.ops import distances as tdist
from glomargridding_tpu_torch.ops import eigsh as teig
from glomargridding_tpu_torch.ops.cuda import ellipse as tell
from glomargridding_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

TOL = dict(rtol=1e-8, atol=1e-10)
OPERATOR_TOL = dict(rtol=2e-4, atol=2e-4)
SOLVER_TOL = dict(rtol=1e-6, atol=1e-8)
VARIO = MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=1.5)


def _grid_problem(rng, n_obs=20):
    lat = np.arange(-82.5, 90, 15.0)
    lon = np.arange(-172.5, 180, 15.0)
    glat, glon = np.repeat(lat, lon.size), np.tile(lon, lat.size)
    idx = np.sort(rng.choice(glat.size, n_obs, replace=False))
    obs = rng.normal(size=n_obs)
    err = np.diag(0.1 + 0.05 * rng.random(n_obs))
    return glat, glon, idx, obs, err


def _kernels():
    jkern = jkk.variogram_kernel(VARIO)
    tkern = convert.kernel_from_params(dataclasses.asdict(VARIO),
                                       jkern.distance, jkern.var,
                                       jkern.radius)
    return jkern, tkern


def _spd_case(rng, m=80, n=12):
    pts = rng.uniform(0, 10, (m, 2))
    cov = 1.5 * np.exp(-np.linalg.norm(pts[:, None] - pts[None], axis=-1)
                       / 3.0)
    idx = np.sort(rng.choice(m, n, replace=False))
    return cov, idx, rng.normal(size=n), np.diag(0.1 + 0.05 * rng.random(n))


def _ellipse_fields(rng, nlat=7, nlon=9):
    mask = rng.random((nlat, nlon)) < 0.25

    def field(lo, hi):
        return np.ma.masked_where(mask, rng.uniform(lo, hi, (nlat, nlon)))

    return (field(800, 2000), field(400, 900), field(-1.0, 1.0),
            field(0.5, 1.5), np.linspace(-50, 55, nlat),
            np.linspace(-170, 160, nlon))


# Each case: rng -> (port(**kw) -> outputs, the JAX package's outputs).
def _kriging_from_kernel(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels()
    kw = dict(variance=1.2, n_blocks=3)
    return (lambda **d: tkk.kriging_from_kernel(tkern, glat, glon, idx, obs,
                                                err, **kw, **d),
            jkk.kriging_from_kernel(jkern, glat, glon, idx, obs, err, **kw))


def _ensemble_from_kernel(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels()
    key = jax.random.key(0)
    noise = np.array(jax.random.normal(key, (4, idx.size), jnp.float64))
    return (lambda **d: tkk.ensemble_from_kernel(
                tkern, glat, glon, idx, obs, err, n_members=4, n_blocks=3,
                noise=noise, **d),
            jkk.ensemble_from_kernel(jkern, glat, glon, idx, obs, err, key,
                                     n_members=4, n_blocks=3))


def _months_scan_kriging(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels()
    args = (glat, glon, np.stack([idx] * 2),
            np.stack([obs, rng.normal(size=idx.size)]),
            np.stack([err, 1.1 * err]))
    return (lambda **d: tkk.months_scan_kriging(tkern, *args, variance=1.2,
                                                **d),
            jkk.months_scan_kriging(jkern, *args, variance=1.2))


def _kriging_crossval(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels()
    return (lambda **d: tkk.kriging_crossval(tkern, glat, glon, idx, obs,
                                             err, **d),
            jkk.kriging_crossval(jkern, glat, glon, idx, obs, err))


def _crossval_from_covariance(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    d = np.asarray(jdist.haversine_matrix(glat, glon))
    cov = 1.2 - np.asarray(VARIO.fit(jnp.asarray(d)))
    return (lambda **k: tkk.crossval_from_covariance(cov, idx, obs, err, **k),
            jkk.crossval_from_covariance(cov, idx, obs, err))


def _kriging_class(name):
    def case(rng):
        args = _spd_case(rng)

        def outputs(k):
            return k.solve(), k.get_uncertainty(), k.constraint_mask()

        return (lambda **d: outputs(getattr(tkrig, name)(*args, **d)),
                outputs(getattr(jkrig, name)(*args)))

    return case


def _builder(make):
    def case(rng):
        fields = _ellipse_fields(rng)
        kw = dict(v=1.5, max_dist=3000.0, precision=np.float64)
        return (lambda **d: (make(*fields, **kw, **d).cov_ns,),
                (jcov.EllipseCovarianceBuilder(*fields, **kw).cov_ns,))

    return case


def _deprecated_form(name, blocks):
    """A deprecated function form of the kriging classes, on pre-gathered
    blocks: (K, C_cross[, y], C)."""
    def case(rng):
        cov, idx, obs, err = _spd_case(rng)
        K = cov[np.ix_(idx, idx)] + err
        args = (K, cov[idx], obs, cov) if blocks == 4 else (K, cov[idx], cov)

        def port(**d):
            with pytest.warns(DeprecationWarning) if blocks == 4 else (
                    nullcontext()):
                out = getattr(tkrig, name)(*args, **d)
            return out if blocks == 4 else (out,)

        ref = getattr(jkrig, name)(*args)
        return port, ref if blocks == 4 else (ref,)

    return case


def _ellipse_points(rng, n=60, max_dist=2500.0):
    """Packed-point inputs (lats_rad, lons_rad, sig_flat, sqrt_dets,
    stdevs) as numpy, and the JAX package's dense f64 covariance on them
    with diag(stdev^2)."""
    lats = np.sort(rng.uniform(-60, 60, n))
    lons = rng.uniform(-180, 180, n)
    Lx, Ly = rng.uniform(800, 2000, n), rng.uniform(400, 800, n)
    theta, stdev = rng.uniform(-np.pi, np.pi, n), rng.uniform(0.5, 1.5, n)
    s00, s01, _, s11 = (np.asarray(a) for a in jdist.sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)))
    args = (np.radians(lats), np.radians(lons),
            np.stack([s00, s01, s11], -1), np.sqrt(s00 * s11 - s01 * s01),
            stdev)
    dense = np.asarray(jcov.build_ellipse_covariance(
        *map(jnp.asarray, args), v=1.5, max_dist=max_dist, use_pallas=False))
    return args, dense


def _ellipse_covariance_operator(rng):
    args, dense = _ellipse_points(rng)
    X = rng.normal(size=(dense.shape[0], 3))
    return (lambda **d: (tcov.ellipse_covariance_operator(
                *args, v=1.5, max_dist=2500.0, store="stream", n_blocks=3,
                **d)[0](torch.as_tensor(X, device=d.get("device"))),),
            (dense @ X,))


def _dense_ellipse(build):
    def case(rng):
        args, dense = _ellipse_points(rng)
        return (lambda **d: (build(*args, v=1.5, max_dist=2500.0, **d),),
                (dense,))

    return case


def _haversine_matrix(rng):
    a = rng.uniform(-80, 80, (2, 7))
    b = rng.uniform(-180, 180, (2, 7))
    return (lambda **d: (tdist.haversine_matrix(a[0], b[0], a[1], b[1], **d),),
            (jdist.haversine_matrix(a[0], b[0], a[1], b[1]),))


def _decaying_cov(rng, n=160):
    """A kernel matrix with a decaying spectrum, slightly indefinite."""
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    A = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1) / 0.05)
    P = rng.normal(size=(n, 8)) / np.sqrt(n)
    A = A - 0.05 * (P @ P.T)
    return 0.5 * (A + A.T)


def _key_draws(key):
    """The partial eigensolver's ``draw`` from the reference's key: one
    split per stage."""
    state = {"key": key}

    def draw(shape, dtype):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.normal(
            sub, shape, jnp.float64)))

    return draw


def _topk_eigh(rng):
    A = _decaying_cov(rng)
    key = jax.random.key(1)
    z = np.array(jax.random.normal(key, (160, 20), jnp.float64))

    def projector(pairs):
        V = pairs[1][:, :6]
        return (V @ V.T,)

    return (lambda **d: projector(teig.topk_eigh(
                A, 12, draw=lambda shape, dtype: z, **d)),
            projector(jeig.topk_eigh(jnp.asarray(A), 12, key=key)))


def _adaptive_topk_eigh(rng):
    A = _decaying_cov(rng)
    target = 0.8 * np.trace(A)
    key = jax.random.key(2)

    def accept(w):
        hit = np.nonzero(np.cumsum(w) > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    def projector(out):
        V = out[1]
        return (V @ V.T,)

    kw = dict(k0=32, tol=1e-6)
    return (lambda **d: projector(teig.adaptive_topk_eigh(
                A, accept, draw=_key_draws(key), **kw, **d)),
            projector(jeig.adaptive_topk_eigh(jnp.asarray(A), accept,
                                              key=key, **kw)))


def _clip(name, lowrank=False, **kw):
    """A clip of a dense numpy matrix by the partial spectrum; a factored
    result is compared densified."""
    def case(rng):
        A = _decaying_cov(rng)
        key = jax.random.key(3)
        solver = dict(k0=32, tol=1e-6)
        if not lowrank:
            solver["spectrum"] = "partial"

        def dense(out):
            return (out.to_dense() if lowrank else out,)

        return (lambda **d: dense(getattr(tct, name)(
                    A, draw=_key_draws(key), **kw, **solver, **d)),
                dense(getattr(jct, name)(A, key=key, **kw, **solver)))

    return case


def _simple_clipping(rng):
    A = _decaying_cov(rng, 60)
    return (lambda **d: (tct.simple_clipping(A, **d)[0],),
            (jct.simple_clipping(A)[0],))


def _factored(rng, n=150, r=12, m=20):
    """numpy factors of a LowRankPSD, the reference's object on them, and
    a month of observations with a diagonal error covariance."""
    V = np.linalg.qr(rng.normal(size=(n, r)))[0]
    g = np.sort(rng.uniform(0.5, 4.0, r))[::-1].copy()
    f = rng.uniform(0.05, 0.2, n)
    jpsd = jct.LowRankPSD(jnp.asarray(V), jnp.asarray(g), jnp.asarray(f))
    idx = np.sort(rng.choice(n, m, replace=False))
    return (V, g, f), jpsd, idx, rng.normal(size=m), 0.1 + 0.05 * rng.random(m)


def _ensemble_noise(key, n, r, m, members):
    k_state, k_obs = jax.random.split(key)
    k1, k2 = jax.random.split(k_state)
    return tuple(np.array(jax.random.normal(k, shape, jnp.float64))
                 for k, shape in ((k1, (n, members)), (k2, (r, members)),
                                  (k_obs, (m, members))))


def _lowrank(name):
    """An entry point of models.lowrank: the factors arrive as numpy
    through ``convert.lowrank_psd_from_arrays``, which places them."""
    def case(rng):
        factors, jpsd, idx, obs, e = _factored(rng)
        key = jax.random.key(5)
        noise = _ensemble_noise(key, 150, 12, 20, 3)

        def flat(out):
            if name in ("lowrank_kriging", "lowrank_crossval"):
                return tuple(out)
            return (*out[0], out[1])

        if name == "lowrank_ensemble_step":
            kw_t, args_j = dict(n_members=3, noise=noise), (key, 3)
        elif name == "lowrank_months_scan":
            # one month; the reference splits its key once per month
            idx, obs, e = idx[None], obs[None], e[None]
            noise = _ensemble_noise(jax.random.split(key, 1)[0], 150, 12,
                                    20, 3)
            kw_t, args_j = dict(n_members=3, noise=[noise]), (key, 3)
        else:
            kw_t, args_j = {}, ()
        return (lambda **d: flat(getattr(tlr, name)(
                    convert.lowrank_psd_from_arrays(*factors, **d), idx, obs,
                    e, **kw_t)),
                flat(getattr(jlr, name)(jpsd, idx, obs, e, *args_j)))

    return case


def _stochastic_kriging(rng):
    cov, idx, obs, err = _spd_case(rng)
    key = jax.random.key(6)
    ks, ko = jax.random.split(key)
    noise = (np.array(jax.random.normal(ks, (80,), jnp.float64)),
             np.array(jax.random.normal(ko, (12,), jnp.float64)))

    def outputs(k, **kw):
        return k.solve(**kw), k.get_uncertainty(), k.constraint_mask()

    return (lambda **d: outputs(tst.StochasticKriging(cov, idx, obs, err,
                                                      **d), noise=noise),
            outputs(jst.StochasticKriging(cov, idx, obs, err), key=key))


def _batched_ensemble_step(rng):
    cov, idx, obs, err = _spd_case(rng)
    key = jax.random.key(7)
    pairs = [jax.random.split(k) for k in jax.random.split(key, 3)]
    noise = tuple(
        np.stack([np.array(jax.random.normal(p[i], (size,), jnp.float64))
                  for p in pairs]) for i, size in ((0, 80), (1, 12)))
    return (lambda **d: tst.batched_ensemble_step(cov, err, idx, obs, 3,
                                                  noise=noise, **d),
            jst.batched_ensemble_step(key, cov, err, idx, obs, 3))


def _mv_normal_draw(rng):
    cov, *_ = _spd_case(rng)
    key = jax.random.key(8)
    z = np.array(jax.random.normal(key, (4, 80), jnp.float64))
    loc = rng.normal(size=80)
    return (lambda **d: (tst.mv_normal_draw(loc, cov, 4, noise=z, **d),),
            (jst.mv_normal_draw(key, loc, cov, 4),))


def _precompute_states(rng):
    cov, *_ = _spd_case(rng)
    key = jax.random.key(9)
    z = np.array(jax.random.normal(key, (4, 80), jnp.float64))
    return (lambda **d: (tst.precompute_states(4, covariance=cov, noise=z,
                                               **d),),
            (jst.precompute_states(key, 4, covariance=cov),))


CASES = {
    "kriging_from_kernel": _kriging_from_kernel,
    "ensemble_from_kernel": _ensemble_from_kernel,
    "months_scan_kriging": _months_scan_kriging,
    "kriging_crossval": _kriging_crossval,
    "crossval_from_covariance": _crossval_from_covariance,
    "OrdinaryKriging": _kriging_class("OrdinaryKriging"),
    "SimpleKriging": _kriging_class("SimpleKriging"),
    "EllipseCovarianceBuilder": _builder(tcov.EllipseCovarianceBuilder),
    "ellipse_builder_from_inputs": _builder(
        convert.ellipse_builder_from_inputs),
    "ellipse_covariance_operator": _ellipse_covariance_operator,
    "build_ellipse_covariance": _dense_ellipse(tcov.build_ellipse_covariance),
    "ellipse_covariance_cuda": _dense_ellipse(tell.ellipse_covariance_cuda),
    "kriging_simple": _deprecated_form("kriging_simple", 4),
    "kriging_ordinary": _deprecated_form("kriging_ordinary", 4),
    "constraint_mask": _deprecated_form("constraint_mask", 3),
    "haversine_matrix": _haversine_matrix,
    "topk_eigh": _topk_eigh,
    "adaptive_topk_eigh": _adaptive_topk_eigh,
    "explained_variance_clip": _clip("explained_variance_clip",
                                     target_variance_fraction=0.8),
    "laloux_clip": _clip("laloux_clip", num_time_pts=40),
    "eigenvalue_clip": _clip("eigenvalue_clip",
                             target_variance_fraction=0.8),
    "explained_variance_clip_lowrank": _clip(
        "explained_variance_clip_lowrank", lowrank=True,
        target_variance_fraction=0.8),
    "laloux_clip_lowrank": _clip("laloux_clip_lowrank", lowrank=True,
                                 num_time_pts=40),
    "simple_clipping": _simple_clipping,
    "lowrank_kriging": _lowrank("lowrank_kriging"),
    "lowrank_ensemble_step": _lowrank("lowrank_ensemble_step"),
    "lowrank_months_scan": _lowrank("lowrank_months_scan"),
    "lowrank_crossval": _lowrank("lowrank_crossval"),
    "StochasticKriging": _stochastic_kriging,
    "batched_ensemble_step": _batched_ensemble_step,
    "mv_normal_draw": _mv_normal_draw,
    "precompute_states": _precompute_states,
}

SOLVER_CASES = {
    "topk_eigh", "adaptive_topk_eigh", "explained_variance_clip",
    "laloux_clip", "eigenvalue_clip", "explained_variance_clip_lowrank",
    "laloux_clip_lowrank",
}


def tolerance(name):
    """The parity bound of a case: the stream operator's diagonal term is
    f32, everything else f64; what passes through the iterative partial
    eigensolver is held to its convergence, not to roundoff."""
    if name in SOLVER_CASES:
        return SOLVER_TOL
    return OPERATOR_TOL if name == "ellipse_covariance_operator" else TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_point_refuses_cpu_by_default(rng, monkeypatch, name):
    """No device and no card: a RuntimeError, not a CPU run; with
    device="cpu" the same call matches the JAX package."""
    port, ref = CASES[name](rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port()
    ours = port(device="cpu")
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.device.type == "cpu"
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tolerance(name))


def test_resolve_device(monkeypatch):
    """An explicit device wins; else a tensor input keeps its device; else
    the card, which must exist."""
    cpu = torch.zeros(2)
    assert resolve_device("cpu", np.zeros(2)) == torch.device("cpu")
    assert resolve_device(None, np.zeros(2), cpu) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, np.zeros(2), None) == torch.device("cuda")
    assert resolve_device(None, cpu) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None, np.zeros(2), [1.0])
