"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU.

With numpy inputs and no ``device`` an entry point goes to ``cuda``. On a
machine without a card (here made so by ``torch.cuda.is_available``
returning False) it raises ``RuntimeError`` instead of running on the
CPU. With ``device="cpu"`` it still matches the JAX package on the same
numpy inputs, f64, to the parity tests' bounds: rtol 1e-8, atol 1e-10,
and for the stream operators (whose diagonal term is f32) its own tests'
2e-4 against the dense product. The sharded entry points of ``parallel``
run on a mesh from ``make_mesh()``: every card, or without one a
``RuntimeError``; ``device="cpu"`` stands for a mesh of two CPU slots.
The card side runs the same ``CASES`` with no device named and asserts
CUDA outputs (``tests/test_torch_cuda.py``). The deprecated function
forms of the kriging classes are held to their DeprecationWarning here.
"""

import dataclasses
import os
import sys
from contextlib import contextmanager, nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.models import kriging as jkrig
from glomargridding_tpu.models import lowrank as jlr
from glomargridding_tpu.models import stochastic as jst
from glomargridding_tpu.core.labeled import Coordinates as JCoordinates
from glomargridding_tpu.grid import grid as jgrid
from glomargridding_tpu.models.ellipse import covariance as jcov
from glomargridding_tpu.models.ellipse import estimate as jest
from glomargridding_tpu.models.ellipse import model as jmodel
from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu.ops import distances as jdist
from glomargridding_tpu.ops import eigsh as jeig
from glomargridding_tpu.ops import error_covariance as jerr
from glomargridding_tpu.ops import optim as joptim
from glomargridding_tpu.ops import sampling as jsamp
from glomargridding_tpu.ops import sphere as jsphere
from glomargridding_tpu.ops import variogram_fit as jfit
from glomargridding_tpu.native import gridbin as jgb
from glomargridding_tpu import parallel as jpar
from glomargridding_tpu.ops.variogram import MaternVariogram
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch import io as tio
from glomargridding_tpu_torch import parallel as tpar
from glomargridding_tpu_torch.grid import grid as tgrid
from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.models import kriging as tkrig
from glomargridding_tpu_torch.models import lowrank as tlr
from glomargridding_tpu_torch.models import stochastic as tst
from glomargridding_tpu_torch.models.ellipse import covariance as tcov
from glomargridding_tpu_torch.models.ellipse import estimate as test
from glomargridding_tpu_torch.ops import covariance_tools as tct
from glomargridding_tpu_torch.ops import distances as tdist
from glomargridding_tpu_torch.native import gridbin as tgb
from glomargridding_tpu_torch.ops import eigsh as teig
from glomargridding_tpu_torch.ops import error_covariance as terr
from glomargridding_tpu_torch.ops import optim as toptim
from glomargridding_tpu_torch.ops import sampling as tsamp
from glomargridding_tpu_torch.ops import sphere as tsphere
from glomargridding_tpu_torch.ops import variogram_fit as tfit
from glomargridding_tpu_torch.ops.cuda import ellipse as tell
from glomargridding_tpu_torch.parallel import mesh as tmesh
from glomargridding_tpu_torch.utils.device import resolve_device

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import ellipse_1deg_covariance as jex_ellipse  # noqa: E402
import large_ensemble_65k as jex_ensemble  # noqa: E402
import torch_ellipse_1deg_covariance as twin_ellipse  # noqa: E402
import torch_large_ensemble_65k as twin_ensemble  # noqa: E402
import torch_nonstationary_65k_lowrank as twin_lowrank  # noqa: E402
import torch_nonstationary_quarter_degree as twin_quarter  # noqa: E402
import torch_nonstationary_1deg_pipeline as twin_pipeline  # noqa: E402
import torch_nonstationary_tenth_degree as twin_tenth  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-8, atol=1e-10)
# the spectral route of precompute_states runs in f32 (the reference's
# sampler default); its draws are O(1)
F32_TOL = dict(rtol=0, atol=1e-4)
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


def _sphere_grid():
    return (np.arange(-75.0, 76.0, 30.0), np.arange(0.0, 360.0, 45.0),
            jsphere.matern_correlation(1.5, 3000.0))


def _sphere_normals(key, n, L, batch, nugget, M, dtype):
    """The reference sampler's normals for ``draw(key, n)``
    (tests/test_torch_sphere.py)."""
    k = key
    if nugget > 0:
        k, kn = jax.random.split(key)
    n_eff = batch * (-(-n // batch))
    noise = [np.array(jax.random.normal(kk, (n_eff, L + 1, L + 1), dtype))[:n]
             for kk in jax.random.split(k)]
    if nugget > 0:
        noise.append(np.array(jax.random.normal(kn, (n, M), dtype)))
    return noise


def _spherical_harmonic_sampler(rng):
    lats, lons, corr = _sphere_grid()
    key = jax.random.key(10)
    kw = dict(l_max=16, nugget=0.1)
    noise = _sphere_normals(key, 3, 16, 64, 0.1, lats.size * lons.size,
                            jnp.float64)
    return (lambda **d: (tsphere.SphericalHarmonicSampler(
                corr, 1.2, lats, lons, dtype=torch.float64, **kw,
                **d).draw(3, noise=noise),),
            (jsphere.SphericalHarmonicSampler(
                corr, 1.2, lats, lons, dtype=jnp.float64, **kw).draw(key, 3),))


def _precompute_states_spectral(rng):
    lats, lons, corr = _sphere_grid()
    key = jax.random.key(11)
    noise = _sphere_normals(key, 2, 3 * lats.size, 64, 0.05,
                            lats.size * lons.size, jnp.float32)
    kw = dict(corr_fn=corr, variance=1.1, lats_deg=lats, lons_deg=lons,
              nugget=0.05)
    return (lambda **d: (tst.precompute_states(2, noise=noise, **kw, **d),),
            (jst.precompute_states(key, 2, **kw),))


def _points(rng, n=40):
    return (np.radians(rng.uniform(-70, 70, n)),
            np.radians(rng.uniform(-180, 180, n)))


def _kernel_matvec(rng):
    la, lo = _points(rng)
    v = rng.normal(size=(la.size, 3))
    jkern, tkern = _kernels()
    return (lambda **d: (tsamp.kernel_matvec(tkern, la, lo, n_blocks=3,
                                             **d)(v),),
            (jsamp.kernel_matvec(jkern, jnp.asarray(la), jnp.asarray(lo),
                                 n_blocks=3)(jnp.asarray(v)),))


def _estimate_spectral_range(rng):
    """A float pair, put back on the call's device so that the card test
    can tell where it ran."""
    la, lo = _points(rng)
    jkern, tkern = _kernels()
    key = jax.random.key(12)
    start = np.array(jax.random.normal(key, (la.size, 1), jnp.float64))

    def port(**d):
        lams = tsamp.estimate_spectral_range(
            tsamp.kernel_matvec(tkern, la, lo, **d), la.size,
            dtype=torch.float64, noise=start, **d)
        return (torch.as_tensor(lams, dtype=torch.float64,
                                device=d.get("device", "cuda")),)

    return port, (jsamp.estimate_spectral_range(
        jsamp.kernel_matvec(jkern, jnp.asarray(la), jnp.asarray(lo)),
        la.size, key, dtype=jnp.float64),)


def _sample_mvn_chebyshev(rng):
    la, lo = _points(rng)
    jkern, tkern = _kernels()
    key = jax.random.key(13)
    z = np.array(jax.random.normal(key, (la.size, 3), jnp.float64))
    kw = dict(lam_min=0.05, lam_max=40.0, degree=30)
    return (lambda **d: (tsamp.sample_mvn_chebyshev(
                tsamp.kernel_matvec(tkern, la, lo, **d), la.size, 3,
                dtype=torch.float64, noise=z, **kw, **d),),
            (jsamp.sample_mvn_chebyshev(
                key, jsamp.kernel_matvec(jkern, jnp.asarray(la),
                                         jnp.asarray(lo)),
                la.size, 3, dtype=jnp.float64, **kw),))


def _fit_variogram_mle(rng):
    """The fitted (psill, range, nugget), put back on the call's device."""
    glat, glon, *_ = _grid_problem(rng)
    idx = np.sort(rng.choice(glat.size, 60, replace=False))
    d = np.array(jdist.haversine_matrix(glat[idx], glon[idx]))
    cov = 1.2 - np.asarray(VARIO.fit(jnp.asarray(d))) + 0.1 * np.eye(60)
    y = rng.multivariate_normal(np.zeros(60), cov)
    kw = dict(nu=1.5, guesses=(0.8, 1500.0, 0.2), optimizer="Nelder-Mead")

    def port(**k):
        fit = tfit.fit_variogram_mle(d, y, **kw, **k)
        return (torch.as_tensor(fit[:3], dtype=torch.float64,
                                device=k.get("device", "cuda")),)

    return port, (np.asarray(jfit.fit_variogram_mle(d, y, **kw)[:3]),)


def _snap_to_grid(rng):
    lats, lons = rng.uniform(-95, 95, 300), rng.uniform(-185, 185, 300)
    grid = (-87.5, 5.0, 36, -177.5, 5.0, 72)
    return (lambda **d: (tgb.snap_to_grid(lats, lons, *grid, **d),),
            (jgb.snap_to_grid(lats, lons, *grid),))


def _bin_mean(rng):
    idx, vals = rng.integers(0, 50, 400), rng.normal(size=400)
    return (lambda **d: tgb.bin_mean(idx, vals, 50, **d),
            jgb.bin_mean(idx, vals, 50))


def _aggregate_observations(rng):
    lats, lons = rng.uniform(-90, 90, 400), rng.uniform(-180, 180, 400)
    vals = rng.normal(size=400)
    kw = (10, [(-85.0, 90), (-175.0, 180)], ["lat", "lon"])
    return (lambda **d: tgrid.aggregate_observations(
                lats, lons, vals, tgrid.grid_from_resolution(*kw), **d),
            jgrid.aggregate_observations(lats, lons, vals,
                                         jgrid.grid_from_resolution(*kw)))


def _grid_to_distance_matrix(rng):
    """The grid's distance matrix, left on the call's device (the
    DataArray's values)."""
    pytest.importorskip("pandas")
    kw = (30, [(-75, 90), (-165, 180)], ["lat", "lon"])
    return (lambda **d: (tgrid.grid_to_distance_matrix(
                tgrid.grid_from_resolution(*kw), **d).values,),
            (jgrid.grid_to_distance_matrix(
                jgrid.grid_from_resolution(*kw)).values,))


def _gridbox_error_covariance(rng):
    codes = np.sort(rng.integers(0, 6, 30))
    W = (codes[None, :] == np.arange(6)[:, None]).astype(float)
    W /= W.sum(axis=1, keepdims=True)
    A = rng.normal(size=(30, 30))
    E = A @ A.T / 30 + np.eye(30)
    return (lambda **d: (terr.gridbox_error_covariance(W, E, **d),),
            (jerr.gridbox_error_covariance(W, E),))


def _load_lowrank(rng):
    """A factored covariance the JAX package wrote, loaded onto the
    call's device."""
    pytest.importorskip("h5py")
    import atexit

    # the JAX package's io imports h5py at its top, which the card's
    # machine lacks: imported here, this file collects there too
    from glomargridding_tpu import io as jio
    import os
    import tempfile

    Q, _ = np.linalg.qr(rng.normal(size=(40, 4)))
    ref = jct.LowRankPSD(jnp.asarray(Q), jnp.linspace(3.0, 1.0, 4),
                         jnp.asarray(rng.uniform(0.1, 0.2, 40)))
    fd, path = tempfile.mkstemp(suffix=".nc")
    os.close(fd)
    atexit.register(os.remove, path)
    jio.save_lowrank(ref, path)

    def port(**d):
        psd = tio.load_lowrank(path, **d)
        return psd.vectors, psd.gains, psd.floor

    return port, (ref.vectors, ref.gains, ref.floor)


def _distance_matrix(name):
    def case(rng):
        a = rng.uniform(-80, 80, (2, 7))
        b = rng.uniform(-180, 180, (2, 7))
        return (lambda **d: (getattr(tdist, name)(a[0], b[0], a[1], b[1],
                                                  **d),),
                (getattr(jdist, name)(a[0], b[0], a[1], b[1]),))

    return case


def _tau_dist_matrix(rng):
    lats, lons = rng.uniform(-70, 70, 9), rng.uniform(-180, 180, 9)
    return (lambda **d: (tdist.tau_dist_matrix(lats, lons, 1500.0, 800.0,
                                               0.3, **d),),
            (jdist.tau_dist_matrix(lats, lons, 1500.0, 800.0, 0.3),))


def _frame_form(name):
    """A frame form of a distance matrix: numpy out, computed on the
    call's device (wrapped back onto it so that the card test can tell)."""
    def case(rng):
        pd = pytest.importorskip("pandas")
        df = pd.DataFrame({
            "lat": 52.0 + rng.uniform(-2, 2, 7),
            "lon": -3.0 + rng.uniform(-2, 2, 7), "grid_lat": 52.5,
            "grid_lon": -2.5, "grid_lx": 300.0, "grid_ly": 150.0,
            "grid_theta": 0.4})
        if name not in ("tau_dist_from_frame", "haversine_gaussian"):
            df = df[["lat", "lon"]]  # these take the two columns alone
        return (lambda **d: (torch.as_tensor(
                    getattr(tdist, name)(df, **d),
                    device=d.get("device", "cuda")),),
                (getattr(jdist, name)(df),))

    return case


def _quadratics(rng, lanes=6):
    centres = rng.uniform(-3, 3, size=(lanes, 3))
    return centres, (np.full(3, -10.0), np.full(3, 10.0))


def _nelder_mead(rng):
    centres, bounds = _quadratics(rng, 1)
    kw = dict(bounds=bounds, xatol=1e-10, fatol=1e-14, maxiter=900)
    return (lambda **d: (toptim.nelder_mead(
                lambda x: torch.sum((x - torch.as_tensor(
                    centres[0], device=x.device)) ** 2),
                np.zeros(3), **kw, **d).x,),
            (joptim.nelder_mead(lambda x: jnp.sum((x - centres[0]) ** 2),
                                jnp.zeros(3), **kw).x,))


def _batched_optimiser(name, **kw):
    """An optimiser over lanes of shifted quadratics (Nelder-Mead,
    L-BFGS) or of straight-line fits (Levenberg-Marquardt), compared at
    the optimum (SOLVER_TOL: a card may sum in another order and take
    another walk to it; tests/test_torch_optim.py holds the walks)."""
    def case(rng):
        centres, bounds = _quadratics(rng)
        if name == "batched_levenberg_marquardt":
            t = np.linspace(0.0, 1.0, 16)
            data = centres[:, :1] * t[None, :] + centres[:, 1:2]
            x0, args, bounds = np.zeros((6, 2)), (data,), (bounds[0][:2],
                                                           bounds[1][:2])

            def tfun(x, y):
                return x[0] * torch.as_tensor(t, device=y.device) + x[1] - y

            def jfun(x, y):
                return x[0] * t + x[1] - y
        else:
            x0, args = np.zeros((6, 3)), (centres,)

            def tfun(x, c):
                return torch.sum((x - c) ** 2)

            def jfun(x, c):
                return jnp.sum((x - c) ** 2)

        return (lambda **d: (getattr(toptim, name)(tfun, x0, args, bounds,
                                                   **kw, **d).x,),
                (getattr(joptim, name)(
                    jfun, jnp.asarray(x0), tuple(map(jnp.asarray, args)),
                    tuple(map(jnp.asarray, bounds)), **kw).x,))

    return case


_ELLIPSE_MODEL = dict(anisotropic=True, rotated=True, physical_distance=True,
                      v=0.5, unit_sigma=True)
_ELLIPSE_FIT = dict(guesses=[1000.0, 1000.0, 0.0], bounds=[
    (300.0, 10000.0), (300.0, 10000.0), (-2 * np.pi, 2 * np.pi)])


def _ellipse_model_fit(rng):
    """``EllipseModel.fit`` by L-BFGS with Hessian standard errors: the
    optimum and its SEs (SOLVER_TOL: each side stops at |grad| <= 1e-9)."""
    jm = jmodel.EllipseModel(**_ELLIPSE_MODEL)
    X = rng.uniform(-4000, 4000, (200, 2))
    y = np.asarray(jm._model_correlation(
        jnp.asarray(X), jnp.asarray([1800.0, 700.0, 0.5])))
    y = np.clip(y + rng.normal(0, 0.03, 200), -0.999, 0.999)
    kw = dict(opt_method="L-BFGS-B", tol=1e-9, estimate_SE="hessian",
              **_ELLIPSE_FIT)

    def outputs(fit, to_tensor):
        res, se, _ = fit
        return res.x, to_tensor(se)

    tm = convert.ellipse_model_from_params(vars(jm))
    return (lambda **d: outputs(tm.fit(X, y, **kw, **d),
                                lambda se: torch.as_tensor(
                                    se, device=d.get("device", "cuda"))),
            outputs(jm.fit(X, y, **kw), np.asarray))


def _training_cube(rng, size=(4, 5), n_t=60):
    lats = np.linspace(-20.0, 20.0, size[0])
    lons = np.linspace(0.0, 30.0, size[1])
    data = rng.normal(size=(n_t, *size)).cumsum(axis=2).cumsum(axis=1)
    return data, {"time": np.arange(n_t), "latitude": lats,
                  "longitude": lons}


def _ellipse_builder(rng):
    """``EllipseBuilder`` on a numpy cube: the correlation, and the
    whole-grid Levenberg-Marquardt fit's (Lx, Ly, theta, qc) fields."""
    data, coords = _training_cube(rng)
    kw = dict(default_value=[-999.0] * 6, max_distance=8000.0, tol=1e-8,
              opt_method="lm", **_ELLIPSE_FIT)
    jm = jmodel.EllipseModel(**_ELLIPSE_MODEL)

    def outputs(builder, to_tensor, model):
        p = builder.compute_params(matern_ellipse=model, **kw)
        return (builder.cor, to_tensor(np.stack(
            [p[k].values for k in ("Lx", "Ly", "theta", "qc_code")])))

    def port(**d):
        b = test.EllipseBuilder(data, coords, **d)
        return outputs(b, lambda a: torch.as_tensor(a, device=b.device),
                       convert.ellipse_model_from_params(vars(jm)))

    return port, outputs(jest.EllipseBuilder(data, JCoordinates(coords)),
                         np.asarray, jm)


def _ellipse_builder_from_dataset(rng):
    Lx, Ly, theta, stdev, lats, lons = _ellipse_fields(rng)
    qc = np.where(rng.random(Lx.shape) < 0.2, 9.0, 0.0)
    fields = {"Lx": Lx.filled(-999.0), "Ly": Ly.filled(-999.0),
              "theta": theta.filled(-999.0),
              "standard_deviation": stdev.filled(-999.0), "qc_code": qc}
    dataset = convert.dataset_from_arrays(
        fields, {"latitude": lats, "longitude": lons})
    drop = Lx.mask | (qc == 9)
    kw = dict(v=1.5, max_dist=3000.0, precision=np.float64)
    return (lambda **d: (convert.ellipse_builder_from_dataset(
                dataset, lats, lons, **kw, **d).cov_ns,),
            (jcov.EllipseCovarianceBuilder(
                *(np.ma.masked_where(drop, fields[k]) for k in (
                    "Lx", "Ly", "theta", "standard_deviation")),
                lats, lons, **kw).cov_ns,))


def _slot_mesh(d):
    """The port's mesh in a device-rule case: every card by default (with
    none, ``make_mesh`` raises), or two slots of the named device."""
    if "device" in d:
        return tpar.make_mesh(devices=[d["device"]] * 2)
    return tpar.make_mesh()


def _whole(*outs):
    return tuple(o.gather() if isinstance(o, tmesh.Sharded) else o
                 for o in outs)


def _make_mesh(rng):
    """A psum over the default mesh's slots: the column sums of a matrix
    whose rows are sharded over them."""
    A = rng.normal(size=(8, 5))

    def port(**d):
        devices = _slot_mesh(d).axis_devices("grid")
        parts = tmesh.shard_rows(A, devices)
        return (tmesh.psum([p.sum(0) for p in parts], devices)[0],)

    return port, (jnp.sum(jnp.asarray(A), axis=0),)


def _sharded_linalg(name):
    """The blocked Cholesky and what applies its factor, on the default
    mesh against the reference's 8-device mesh."""
    def case(rng):
        n = 64
        M = rng.normal(size=(n, n))
        spd = M @ M.T / n + np.eye(n)
        B, mean = rng.normal(size=(n, 3)), rng.normal(size=n)
        jmesh = jpar.make_mesh()
        jL = jpar.sharded_cholesky(jmesh, spd)
        refs = {
            "sharded_cholesky": (jL,),
            "sharded_triangular_solve": (
                jpar.sharded_triangular_solve(jmesh, jL, B),),
            "sharded_whiten": (jpar.sharded_whiten(jmesh, jL, B),),
            "sharded_mvn_logpdf": (
                jpar.sharded_mvn_logpdf(jmesh, jL, B, mean=mean),),
        }

        def port(**d):
            mesh = _slot_mesh(d)
            L = tpar.sharded_cholesky(mesh, spd)
            if name == "sharded_cholesky":
                return _whole(L)
            if name == "sharded_mvn_logpdf":
                return (tpar.sharded_mvn_logpdf(mesh, L, B, mean=mean),)
            return (getattr(tpar, name)(mesh, L, B),)

        return port, refs[name]

    return case


def _sharded_ordinary_kriging(rng):
    cov, idx, obs, err = _spd_case(rng)
    return (lambda **d: _whole(*tpar.sharded_ordinary_kriging(
                _slot_mesh(d), cov, idx, obs, err)),
            jpar.sharded_ordinary_kriging(jpar.make_mesh(), cov, idx, obs,
                                          err))


def _ensemble_kriging_step(rng):
    """The reference's keyed draws replayed (80 cells: no padding on its
    eight devices)."""
    cov, idx, obs, err = _spd_case(rng)
    key = jax.random.key(4)
    k_state, k_obs = jax.random.split(key)
    z = np.array(jax.random.normal(k_state, (80, 4), jnp.float64))
    zo = np.array(jax.random.normal(k_obs, (4, idx.size), jnp.float64))
    return (lambda **d: _whole(*tpar.ensemble_kriging_step(
                _slot_mesh(d), cov, err, idx, obs, 4, noise=(z.T, zo))),
            jpar.ensemble_kriging_step(jpar.make_mesh(), key, cov, err, idx,
                                       obs, 4))


def _sharded_kriging_from_kernel(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    jkern, tkern = _kernels()
    return (lambda **d: _whole(*tpar.sharded_kriging_from_kernel(
                _slot_mesh(d), tkern, glat, glon, idx, obs, err,
                variance=1.2)),
            jpar.sharded_kriging_from_kernel(jpar.make_mesh(), jkern, glat,
                                             glon, idx, obs, err,
                                             variance=1.2))


def _flat_ellipse_fields(rng, n=64, dtype=np.float64):
    return tuple(a.astype(dtype) for a in (
        rng.uniform(800, 2000, n), rng.uniform(400, 900, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(0.5, 1.5, n),
        np.sort(rng.uniform(-60, 60, n)), rng.uniform(-180, 180, n)))


def _sharded_ellipse_covariance(rng):
    fields = _flat_ellipse_fields(rng)
    kw = dict(v=1.5, max_dist=3000.0)
    return (lambda **d: _whole(tpar.sharded_ellipse_covariance(
                _slot_mesh(d), *fields, **kw)),
            (jpar.sharded_ellipse_covariance(jpar.make_mesh(), *fields,
                                             **kw),))


def _sharded_state_draws(rng):
    n = 64
    M = rng.normal(size=(n, n))
    L = np.linalg.cholesky(M @ M.T / n + np.eye(n))
    key = jax.random.key(6)
    z = np.array(jax.random.normal(key, (n, 5), jnp.float64))
    return (lambda **d: _whole(tpar.sharded_state_draws(
                _slot_mesh(d), L, 5, noise=z.T)),
            (jpar.sharded_state_draws(jpar.make_mesh(), key, jnp.asarray(L),
                                      5),))


def _sharded_ellipse_stream_operator(rng):
    fields = _flat_ellipse_fields(rng, dtype=np.float32)
    X = rng.normal(size=(64, 5)).astype(np.float32)
    jmv, _, _ = jpar.sharded_ellipse_stream_operator(
        jpar.make_mesh(), *fields, v=1.5, max_dist=3000.0)

    def port(**d):
        mv, _, _ = tpar.sharded_ellipse_stream_operator(
            _slot_mesh(d), *fields, v=1.5, max_dist=3000.0)
        return (mv(X), mv(X[:, :2].copy()))

    return port, (jmv(X), jmv(X[:, :2]))


def _sharded_lowrank(name):
    """The sharded factored path: numpy factors placed by
    ``convert.lowrank_psd_from_arrays`` on the case's device, sharded over
    its mesh."""
    def case(rng):
        factors, jpsd, idx, obs, e = _factored(rng, n=160)
        key = jax.random.key(5)
        noise = _ensemble_noise(key, 160, 12, 20, 4)
        jmesh = jpar.make_mesh()
        if name == "sharded_lowrank_kriging":
            ref = tuple(jpar.sharded_lowrank_kriging(jmesh, jpsd, idx, obs,
                                                     e))
        else:
            res, mem = jpar.sharded_lowrank_ensemble_step(
                jmesh, jpsd, idx, obs, e, key, n_members=4)
            ref = (*res, mem)

        def port(**d):
            psd = convert.lowrank_psd_from_arrays(*factors, **d)
            mesh = _slot_mesh(d)
            if name == "sharded_lowrank_kriging":
                return _whole(*tpar.sharded_lowrank_kriging(mesh, psd, idx,
                                                            obs, e))
            res, mem = tpar.sharded_lowrank_ensemble_step(
                mesh, psd, idx, obs, e, n_members=4, noise=noise)
            return _whole(*res, mem)

        return port, ref

    return case


def _sharded_ellipse_builder(rng):
    """``compute_params(mesh=...)``: the lanes of each chunk split over
    the default mesh's slots, against the reference's unsharded fit."""
    data, coords = _training_cube(rng)
    kw = dict(default_value=[-999.0] * 6, max_distance=8000.0, tol=1e-8,
              opt_method="lm", **_ELLIPSE_FIT)
    jm = jmodel.EllipseModel(**_ELLIPSE_MODEL)
    ref = jest.EllipseBuilder(data, JCoordinates(coords)).compute_params(
        matern_ellipse=jm, **kw)

    def port(**d):
        b = test.EllipseBuilder(data, coords, **d)
        p = b.compute_params(matern_ellipse=convert.ellipse_model_from_params(
            vars(jm)), mesh=_slot_mesh(d), **kw)
        return (torch.as_tensor(np.stack(
            [p[k].values for k in ("Lx", "Ly", "theta", "qc_code")]),
            device=b.device),)

    return port, (np.stack([ref[k].values
                            for k in ("Lx", "Ly", "theta", "qc_code")]),)


@contextmanager
def _constants(module, **values):
    """`module`'s constants set to `values` inside the block."""
    keep = {name: getattr(module, name) for name in values}
    for name, value in values.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in keep.items():
            setattr(module, name, value)


def _start_blocks(key):
    """The eigensolver's f32 start blocks from a JAX key (one split per
    stage)."""
    state = {"key": key}

    def draw(shape, dtype):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.normal(
            sub, shape, jnp.float32)))

    return draw


# the examples' twins at a few dozen cells: the clip at a width that
# holds the 0.90 target in one stage
_TWIN_CLIP = dict(target_variance_fraction=0.9, k0=32, max_rank=64,
                  n_iter=3, rank_multiple=8)
_TWIN = dict(M_LAT=6, M_LON=12, N_OBS=10, N_MEMBERS=3, CLIP_KW=_TWIN_CLIP,
             PAD_RANK=8)


def _jax_factored_uncertainty(jmv, n, trace, idx):
    """The JAX script's clip (key 1) padded to 8, densified, and its
    kriging uncertainty at `idx` (error 0.09): both independent of the
    Ritz vectors' signs."""
    lock = jeig._LOCK_MIN_N
    jeig._LOCK_MIN_N = 0  # the scripts' size takes the locked widening
    try:
        jpsd = jct.explained_variance_clip_lowrank(
            jmv, n=n, trace=float(trace), key=jax.random.key(1),
            dtype=jnp.float32, **_TWIN_CLIP).pad_rank(8)
    finally:
        jeig._LOCK_MIN_N = lock
    m = idx.size
    unc = jlr.lowrank_kriging(jpsd, idx, np.zeros(m, np.float32),
                              np.full(m, 0.09, np.float32)).uncertainty
    return jpsd.to_dense(), unc


def _twin_outputs(out):
    return out["psd"].to_dense(), out["result"].uncertainty


def _twin_quarter_degree(rng):
    """``run`` from given ellipse fields: the stream operator, the clip
    and the factored kriging against the JAX script's stages."""
    with _constants(twin_quarter, **_TWIN):
        _, _, glat, glon = twin_quarter.axes()
    shape = (_TWIN["M_LAT"], _TWIN["M_LON"])
    params = {"Lx": rng.uniform(2500, 3500, shape),
              "Ly": rng.uniform(1500, 2500, shape),
              "theta": rng.uniform(-0.5, 0.5, shape),
              "standard_deviation": rng.uniform(0.8, 1.2, shape),
              "qc_code": np.zeros(shape)}
    fields, _ = twin_quarter.fitted_fields(params)
    s00, s01, _, s11 = jdist.sigma_rot_flat(
        *(jnp.asarray(fields[k]) for k in ("Lx", "Ly", "theta")))
    jmv, n, trace = jcov.ellipse_covariance_operator(
        jnp.radians(jnp.asarray(glat)), jnp.radians(jnp.asarray(glon)),
        jnp.stack([s00, s01, s11], axis=-1), jnp.sqrt(s00 * s11 - s01 * s01),
        jnp.asarray(fields["standard_deviation"]), v=1.5, store="stream",
        max_dist=3000.0)
    idx = np.sort(np.random.default_rng(7).choice(n, _TWIN["N_OBS"],
                                                  replace=False))

    def port(**d):
        with _constants(twin_quarter, **_TWIN):
            out = twin_quarter.run(ellipse_params=params, verbose=False,
                                   draw=_start_blocks(jax.random.key(1)),
                                   **d)
        return _twin_outputs(out)

    return port, _jax_factored_uncertainty(jmv, n, trace, idx)


def _twin_lowrank_65k(rng):
    """``run``: the bf16 store, the clip and the factored kriging against
    the JAX script's stages."""
    with _constants(twin_lowrank, **_TWIN):
        glat, glon = twin_lowrank.grid()
    fields = twin_lowrank.ellipse_fields(glat)
    s00, s01, _, s11 = jdist.sigma_rot_flat(
        *(jnp.asarray(fields[k]) for k in ("Lx", "Ly", "theta")))
    jmv, n, trace = jcov.ellipse_covariance_operator(
        jnp.radians(jnp.asarray(glat)), jnp.radians(jnp.asarray(glon)),
        jnp.stack([s00, s01, s11], axis=-1), jnp.sqrt(s00 * s11 - s01 * s01),
        jnp.asarray(fields["stdev"]), v=1.5, store="bf16")
    idx = np.sort(np.random.default_rng(7).choice(n, _TWIN["N_OBS"],
                                                  replace=False))

    def port(**d):
        with _constants(twin_lowrank, **_TWIN):
            out = twin_lowrank.run(draw=_start_blocks(jax.random.key(1)),
                                   verbose=False, **d)
        return _twin_outputs(out)

    return port, _jax_factored_uncertainty(jmv, n, trace, idx)


_ENSEMBLE = dict(M_LAT=8, M_LON=16, N_OBS=20, N_MEMBERS=3)


def _twin_large_ensemble(rng):
    """``run`` on the JAX key's normals: the script's field and members,
    composed from its ``kernel_block`` and Cholesky solves."""
    with _constants(twin_ensemble, **_ENSEMBLE):
        lat, lon = twin_ensemble.grid()
        m = lat.size * lon.size
        idx, y, err = twin_ensemble.observations(m)
        l_max = 3 * lat.size
    jsampler = jsphere.SphericalHarmonicSampler(
        jsphere.matern_correlation(0.5, twin_ensemble.RANGE_KM),
        twin_ensemble.PSILL, lat, lon, nugget=twin_ensemble.NUGGET)
    k_state, k_obs = jax.random.split(jax.random.key(0))
    members = _ENSEMBLE["N_MEMBERS"]
    states = np.asarray(jsampler.draw(k_state, members)).T
    obs_z = np.array(jax.random.normal(k_obs, (idx.size, members),
                                       jnp.float32))
    k, kn = jax.random.split(k_state)
    kc, ks = jax.random.split(k)
    noise = {"states": [np.array(jax.random.normal(
        kk, (64, l_max + 1, l_max + 1), jnp.float32))[:members]
        for kk in (kc, ks)] + [np.array(jax.random.normal(
            kn, (members, m), jnp.float32))], "obs": obs_z}
    la = np.radians(np.repeat(lat, lon.size))
    lo = np.radians(np.tile(lon, lat.size))
    with _constants(jex_ensemble, **_ENSEMBLE):
        K = np.asarray(jex_ensemble.kernel_block(
            la[idx], lo[idx], la[idx], lo[idx]), np.float64) + np.diag(err)
        C = np.asarray(jex_ensemble.kernel_block(la[idx], lo[idx], la, lo),
                       np.float64)
    V = np.linalg.solve(K, C)
    u = np.linalg.solve(K, np.ones(idx.size))
    lam = (V.sum(axis=0) - 1.0) / u.sum()
    field = V.T @ y - lam * (u @ y)
    sim = V.T @ (states[idx] + obs_z * np.sqrt(err)[:, None])
    ref_members = (field[:, None] + sim - states).T

    def port(**d):
        with _constants(twin_ensemble, **_ENSEMBLE):
            out = twin_ensemble.run(noise=noise, verbose=False, **d)
        return out["field"], out["members"]

    return port, (field, ref_members)


def _twin_ellipse_covariance(rng):
    """``run``: K4's matrix against the JAX script's Pallas build."""
    with _constants(twin_ellipse, N_POINTS=100):
        lats, lons, fields = twin_ellipse.points()
    s00, s01, _, s11 = jdist.sigma_rot_flat(
        *(jnp.asarray(fields[k]) for k in ("Lx", "Ly", "theta")))
    ref = jex_ellipse.ellipse_covariance_pallas(
        jnp.radians(jnp.asarray(lats)), jnp.radians(jnp.asarray(lons)),
        jnp.stack([s00, s01, s11], axis=-1), jnp.sqrt(s00 * s11 - s01 * s01),
        jnp.asarray(fields["stdev"]), v=0.5)

    def port(**d):
        with _constants(twin_ellipse, N_POINTS=100):
            return (twin_ellipse.run(verbose=False, **d)["cov"],)

    return port, (ref,)


def _twin_tenth_degree(rng):
    """``run`` at 288 cells and rank cap 16: the clip's factors and the
    kriging uncertainty at the observed cells against the JAX clip of the
    JAX operator with the script's arguments."""
    tiny = dict(M_LAT=12, M_LON=24, N_OBS=10, N_MEMBERS=3)
    with _constants(twin_tenth, **tiny):
        glat, glon = twin_tenth.grid()
    Lx, Ly, theta, stdev = twin_tenth.heterogeneous_ellipse_fields(glat,
                                                                   glon)
    s00, s01, _, s11 = jdist.sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta))
    jmv, n, trace = jcov.ellipse_covariance_operator(
        jnp.radians(jnp.asarray(glat)), jnp.radians(jnp.asarray(glon)),
        jnp.stack([s00, s01, s11], axis=-1), jnp.sqrt(s00 * s11 - s01 * s01),
        jnp.asarray(stdev), v=1.5, store="stream", max_dist=3000.0)
    jpsd = jct.explained_variance_clip_lowrank(
        jmv, n=n, trace=float(trace), target_variance_fraction=0.15,
        key=jax.random.key(1), k0=16, max_rank=16, oversample=8, n_iter=2,
        rank_multiple=8, dtype=jnp.float32)
    rng11 = np.random.default_rng(11)
    rng11.normal(size=(n, twin_tenth.DEMO_COLS))
    idx = np.sort(rng11.choice(n, tiny["N_OBS"], replace=False))
    unc = jlr.lowrank_kriging(jpsd, idx, np.zeros(idx.size, np.float32),
                              np.full(idx.size, 0.09, np.float32)).uncertainty

    def port(**d):
        with _constants(twin_tenth, **tiny), _env("GLOMAR_TENTH_RANK", "16"):
            out = twin_tenth.run(draw=_start_blocks(jax.random.key(1)),
                                 verbose=False, **d)
        return out["psd"].to_dense(), out["result"].uncertainty

    return port, (jpsd.to_dense(), unc)


def _twin_1deg_pipeline(rng):
    """``run`` on a 30-degree grid from given ellipse fields: K2's
    covariance, the clip and the factored kriging against the JAX
    script's builder and clip."""
    tiny = dict(SMALL_DEG=30.0, N_MEMBERS=3)
    with _constants(twin_pipeline, **tiny):
        lats, lons = twin_pipeline.axes(small=True)
    shape = (lats.size, lons.size)
    fields = {"Lx": rng.uniform(2500, 3500, shape),
              "Ly": rng.uniform(1500, 2500, shape),
              "theta": rng.uniform(-0.5, 0.5, shape),
              "standard_deviation": rng.uniform(0.8, 1.2, shape),
              "qc_code": np.zeros(shape)}
    params = {k: _Values(v) for k, v in fields.items()}
    mask = twin_pipeline.ocean_mask(lats, lons)
    cov = jcov.EllipseCovarianceBuilder(
        *(np.ma.masked_where(mask, fields[k]) for k in (
            "Lx", "Ly", "theta", "standard_deviation")),
        lats, lons, v=1.5).cov_ns
    jpsd = jct.explained_variance_clip_lowrank(
        cov, target_variance_fraction=0.9, key=jax.random.key(1), k0=512,
        max_rank=1536, rank_multiple=128).pad_rank(256)
    n = jpsd.vectors.shape[0]
    idx = np.sort(np.random.default_rng(7).choice(n, n // 2, replace=False))
    unc = jlr.lowrank_kriging(jpsd, idx, np.zeros(idx.size, np.float32),
                              np.full(idx.size, 0.09, np.float32)).uncertainty

    def port(**d):
        with _constants(twin_pipeline, **tiny):
            out = twin_pipeline.run(small=True, params=params,
                                    draw=_start_blocks(jax.random.key(1)),
                                    verbose=False, **d)
        return out["psd"].to_dense(), out["result"].uncertainty

    return port, (jpsd.to_dense(), unc)


class _Values:
    """A field as a Dataset holds it (``.values``)."""

    def __init__(self, values):
        self.values = values


@contextmanager
def _env(name, value):
    keep = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if keep is None:
            del os.environ[name]
        else:
            os.environ[name] = keep


def _sharded_stream_clip(rng):
    """The explained-variance clip on the sharded stream operator, its
    blocks row-sharded over the mesh's slots, in f64, against the JAX
    clip on its 8-device mesh."""
    fields = _flat_ellipse_fields(rng, dtype=np.float32)
    jmv, n, trace = jpar.sharded_ellipse_stream_operator(
        jpar.make_mesh(), *fields, v=1.5, max_dist=3000.0)
    kw = dict(n=n, trace=trace, target_variance_fraction=0.9, k0=16,
              max_rank=64, n_iter=6)
    key = jax.random.key(3)
    ref = jct.explained_variance_clip_lowrank(jmv, key=key, **kw)

    def port(**d):
        mv, _, _ = tpar.sharded_ellipse_stream_operator(
            _slot_mesh(d), *fields, v=1.5, max_dist=3000.0)
        return (tct.explained_variance_clip_lowrank(
            mv, draw=_key_draws(key), dtype=torch.float64, **kw,
            **d).to_dense(),)

    return port, (ref.to_dense(),)


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
    "euclidean_matrix": _distance_matrix("euclidean_matrix"),
    "cartesian_euclidean_matrix": _distance_matrix(
        "cartesian_euclidean_matrix"),
    "tau_dist_matrix": _tau_dist_matrix,
    "tau_dist_from_frame": _frame_form("tau_dist_from_frame"),
    "haversine_distance_from_frame": _frame_form(
        "haversine_distance_from_frame"),
    "euclidean_distance": _frame_form("euclidean_distance"),
    "cartesian_euclidean_from_frame": _frame_form(
        "cartesian_euclidean_from_frame"),
    "haversine_gaussian": _frame_form("haversine_gaussian"),
    "nelder_mead": _nelder_mead,
    "batched_nelder_mead": _batched_optimiser(
        "batched_nelder_mead", xatol=1e-10, fatol=1e-14, maxiter=900),
    "batched_lbfgs": _batched_optimiser("batched_lbfgs", tol=1e-10),
    "batched_levenberg_marquardt": _batched_optimiser(
        "batched_levenberg_marquardt"),
    "EllipseModel.fit": _ellipse_model_fit,
    "EllipseBuilder": _ellipse_builder,
    "ellipse_builder_from_dataset": _ellipse_builder_from_dataset,
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
    "precompute_states_spectral": _precompute_states_spectral,
    "SphericalHarmonicSampler": _spherical_harmonic_sampler,
    "kernel_matvec": _kernel_matvec,
    "estimate_spectral_range": _estimate_spectral_range,
    "sample_mvn_chebyshev": _sample_mvn_chebyshev,
    "fit_variogram_mle": _fit_variogram_mle,
    "snap_to_grid": _snap_to_grid,
    "bin_mean": _bin_mean,
    "aggregate_observations": _aggregate_observations,
    "grid_to_distance_matrix": _grid_to_distance_matrix,
    "gridbox_error_covariance": _gridbox_error_covariance,
    "load_lowrank": _load_lowrank,
    "make_mesh": _make_mesh,
    "sharded_cholesky": _sharded_linalg("sharded_cholesky"),
    "sharded_triangular_solve": _sharded_linalg("sharded_triangular_solve"),
    "sharded_whiten": _sharded_linalg("sharded_whiten"),
    "sharded_mvn_logpdf": _sharded_linalg("sharded_mvn_logpdf"),
    "sharded_ordinary_kriging": _sharded_ordinary_kriging,
    "ensemble_kriging_step": _ensemble_kriging_step,
    "sharded_kriging_from_kernel": _sharded_kriging_from_kernel,
    "sharded_ellipse_covariance": _sharded_ellipse_covariance,
    "sharded_state_draws": _sharded_state_draws,
    "sharded_ellipse_stream_operator": _sharded_ellipse_stream_operator,
    "sharded_lowrank_kriging": _sharded_lowrank("sharded_lowrank_kriging"),
    "sharded_lowrank_ensemble_step": _sharded_lowrank(
        "sharded_lowrank_ensemble_step"),
    "EllipseBuilder(mesh)": _sharded_ellipse_builder,
    "torch_nonstationary_quarter_degree.run": _twin_quarter_degree,
    "torch_nonstationary_65k_lowrank.run": _twin_lowrank_65k,
    "torch_large_ensemble_65k.run": _twin_large_ensemble,
    "torch_ellipse_1deg_covariance.run": _twin_ellipse_covariance,
    "torch_nonstationary_tenth_degree.run": _twin_tenth_degree,
    "torch_nonstationary_1deg_pipeline.run": _twin_1deg_pipeline,
    "explained_variance_clip_lowrank(row-sharded)": _sharded_stream_clip,
}
# the examples' twins run their stages in f32, as the scripts do
TWIN_CASES = {name for name in CASES if name.startswith("torch_")}

SOLVER_CASES = {
    "topk_eigh", "adaptive_topk_eigh", "explained_variance_clip",
    "laloux_clip", "eigenvalue_clip", "explained_variance_clip_lowrank",
    "laloux_clip_lowrank", "nelder_mead", "batched_nelder_mead",
    "explained_variance_clip_lowrank(row-sharded)",
    "batched_lbfgs", "batched_levenberg_marquardt", "EllipseModel.fit",
    "fit_variogram_mle",
}


# the 65k twin's clip of its bf16 store: the store's rounding against
# the reference's moves the clip's cut by ~8e-4 at 72 cells
BF16_CLIP_TOL = dict(rtol=0, atol=2e-3)


def tolerance(name):
    """The parity bound of a case: the stream operator's diagonal term and
    the spectral draws are f32, everything else f64; what passes through
    the iterative partial
    eigensolver or an optimiser is held to its convergence, not to
    roundoff."""
    if name in SOLVER_CASES:
        return SOLVER_TOL
    if name == "torch_nonstationary_65k_lowrank.run":
        return BF16_CLIP_TOL
    if name == "precompute_states_spectral" or name in TWIN_CASES:
        return F32_TOL
    return OPERATOR_TOL if name in (
        "ellipse_covariance_operator", "sharded_ellipse_stream_operator"
    ) else TOL


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
