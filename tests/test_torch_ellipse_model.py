"""The port's ``EllipseModel`` against the JAX package's, on the CPU in
f64 on the same numpy inputs.

Values and gradients of the likelihood: rtol 1e-10 (the same formula in
the same order; the sums over the training columns run in another order).
Fits: Nelder-Mead is a sequence of comparisons on an objective whose last
bits differ, so the optimum is held to 1e-4 relative and `nit` to within a
few; L-BFGS has its own line search and is held at the optimum. The
likelihood is a float64 value whatever the data's dtype
(``model._weighted_nll``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models.ellipse import model as jmodel
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.models.ellipse import model as tmodel

torch.set_num_threads(2)

RTOL = 1e-10
FAMILIES = [
    # anisotropic, rotated, physical_distance
    (False, False, False),
    (True, False, False),
    (True, True, False),
    (False, False, True),
    (True, False, True),
    (True, True, True),
]
PARAMS = {1: [9.0], 2: [9.0, 6.0], 3: [9.0, 6.0, 0.3]}


def _models(anisotropic, rotated, pd, v, unit_sigma=True):
    jm = jmodel.EllipseModel(anisotropic, rotated, pd, v,
                             unit_sigma=unit_sigma)
    tm = convert.ellipse_model_from_params(vars(jm))
    return jm, tm


def _training(rng, jm, n=60):
    """Displacements, noisy correlations, a mask that hides the origin,
    and a parameter vector, at the family's scale."""
    scale = 111.0 if jm.physical_distance else 1.0
    p = np.asarray(PARAMS[jm.n_params])
    p[: min(2, jm.n_params)] *= scale
    if not jm.unit_sigma:
        p = np.append(p, 0.2)
    X = rng.uniform(-25, 25, size=(n, 2)) * scale
    if not jm.anisotropic:
        X = np.abs(X[:, 0]) + 0.1 * scale
    y = np.clip(rng.uniform(-0.2, 0.95, n), -0.99, 0.99)
    w = (rng.random(n) > 0.3).astype(float)
    # a masked zero displacement: K_nu is +inf there
    X[5] = 0.0
    w[5] = 0.0
    return X, y, w, p


def test_tables_are_the_reference_tables():
    for name in ("ARCTANH_THRESHOLD", "MODEL_TYPE_TO_SUPERCATEGORY",
                 "FFORM_TO_MODELTYPE", "SUPERCATEGORY_PARAMS",
                 "FFORM_PARAMETERS"):
        assert getattr(tmodel, name) == getattr(jmodel, name), name


def test_taxonomy_and_refusals():
    _, m = _models(True, True, True, 0.5, unit_sigma=False)
    assert m.fform == "anisotropic_rotated_pd"
    assert m.model_type == "ps2006_kks2011_ani_r_pd"
    assert m.supercategory == "3_param_matern_pd"
    assert m.n_params == 3 and m.supercategory_n_params == 6
    with pytest.raises(ValueError, match="isotropic rotated"):
        tmodel.EllipseModel(False, True, False, 0.5)
    with pytest.raises(ValueError, match="'v' must be > 0"):
        tmodel.EllipseModel(True, True, True, 0.0)
    with pytest.raises(ValueError, match="lack"):
        convert.ellipse_model_from_params({"anisotropic": True})


def test_general_order_is_refused_not_replaced(rng):
    """A general order is computed by the general-order K_nu, not replaced
    by a half-integer one: the reference's likelihood at v = 1.2, and
    not the v = 1.5 one."""
    jm, tm = _models(True, True, True, 1.2)
    X, y, _, p = _training(rng, jm)
    ours = tm.negative_log_likelihood(X[6:], y[6:], p, device="cpu")
    ref = jm.negative_log_likelihood(X[6:], y[6:], p)
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)
    other = _models(True, True, True, 1.5)[1].negative_log_likelihood(
        X[6:], y[6:], p, device="cpu")
    assert abs(float(other) - float(ours)) > 1e-3 * abs(float(ours))


@pytest.mark.parametrize("v", [0.5, 1.5])
def test_kernels_match(rng, v):
    dx, dy = rng.uniform(-3000, 3000, (2, 40))
    ours = tmodel.cov_ij_anisotropic(
        v, 1.3, torch.as_tensor(dx), torch.as_tensor(dy), 1500.0, 800.0,
        stdev_j=0.7, theta=torch.tensor(0.4, dtype=torch.float64))
    ref = jmodel.cov_ij_anisotropic(v, 1.3, jnp.asarray(dx), jnp.asarray(dy),
                                    1500.0, 800.0, stdev_j=0.7, theta=0.4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL)
    ours = tmodel.cov_ij_anisotropic(v, 1.0, torch.as_tensor(dx),
                                     torch.as_tensor(dy), 1500.0, 800.0)
    ref = jmodel.cov_ij_anisotropic(v, 1.0, jnp.asarray(dx), jnp.asarray(dy),
                                    1500.0, 800.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL)
    ours = tmodel.cov_ij_isotropic(v, 1.1, torch.as_tensor(dx), 900.0)
    ref = jmodel.cov_ij_isotropic(v, 1.1, jnp.asarray(dx), 900.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("v", [0.5, 1.5])
@pytest.mark.parametrize("family", FAMILIES,
                         ids=lambda f: "".join("ynYN"[not x] for x in f))
def test_likelihood_values_and_gradients(rng, family, v, masked):
    """nll, _nll_fit_z and _residuals_fit_z, and their derivatives
    (autograd against jax.grad / jax.jacfwd), with the likelihood scale
    fitted: f64, rtol 1e-10. Masked rows include a zero displacement,
    whose K_nu is +inf: the gradients must stay finite."""
    jm, tm = _models(*family, v, unit_sigma=False)
    X, y, w, p = _training(rng, jm)
    if not masked:
        X, y, w = X[6:], y[6:], np.ones(len(y) - 6)
    z = np.arctanh(np.clip(np.where(w > 0, y, 0.0), -0.999999, 0.999999))
    Xt, yt, wt, zt = map(torch.as_tensor, (X, y, w, z))
    Xj, yj, wj, zj = map(jnp.asarray, (X, y, w, z))

    def torch_value_grad(f):
        pt = torch.as_tensor(p).requires_grad_(True)
        out = f(pt)
        (g,) = torch.autograd.grad(out, pt)
        return out.item(), g.numpy()

    weights_t, weights_j = (wt, wj) if masked else (None, None)
    cases = [
        (lambda q: tm.nll(q, Xt, yt, weights=weights_t),
         lambda q: jm.nll(q, Xj, yj, weights=weights_j)),
        (lambda q: tm._nll_fit(q, Xt, yt, wt),
         lambda q: jm._nll_fit(q, Xj, yj, wj)),
        (lambda q: tm._nll_fit_z(q, Xt, zt, wt),
         lambda q: jm._nll_fit_z(q, Xj, zj, wj)),
    ]
    for ours, ref in cases:
        value, grad = torch_value_grad(ours)
        ref_value, ref_grad = jax.value_and_grad(ref)(jnp.asarray(p))
        np.testing.assert_allclose(value, float(ref_value), rtol=RTOL)
        assert np.isfinite(grad).all()
        np.testing.assert_allclose(grad, np.asarray(ref_grad), rtol=1e-9,
                                   atol=1e-12 * np.abs(ref_grad).max())
    # the two ways to the same likelihood agree
    np.testing.assert_allclose(
        tm._nll_fit_z(torch.as_tensor(p), Xt, zt, wt).item(),
        tm._nll_fit(torch.as_tensor(p), Xt, yt, wt).item(), rtol=1e-12)
    for ours, ref in (
        (lambda q: tm._residuals_fit_z(q, Xt, zt, wt),
         lambda q: jm._residuals_fit_z(q, Xj, zj, wj)),
        (lambda q: tm._residuals_fit(q, Xt, yt, wt),
         lambda q: jm._residuals_fit(q, Xj, yj, wj)),
    ):
        r = ours(torch.as_tensor(p)).numpy()
        J = torch.func.jacfwd(ours)(torch.as_tensor(p)).numpy()
        np.testing.assert_allclose(r, np.asarray(ref(jnp.asarray(p))),
                                   rtol=RTOL, atol=1e-14)
        ref_J = np.asarray(jax.jacfwd(ref)(jnp.asarray(p)))
        assert np.isfinite(J).all()
        np.testing.assert_allclose(J, ref_J, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref_J).max())


def test_nll_without_the_fisher_transform(rng):
    jm, tm = _models(True, True, True, 1.5)
    X, y, _, p = _training(rng, jm)
    for transform in (True, False):
        np.testing.assert_allclose(
            tm.negative_log_likelihood(X[6:], y[6:], p,
                                       arctanh_transform=transform,
                                       device="cpu"),
            jm.negative_log_likelihood(X[6:], y[6:], p,
                                       arctanh_transform=transform),
            rtol=RTOL)
    f = tm.negative_log_likelihood_function(X[6:], y[6:], device="cpu")
    np.testing.assert_allclose(
        f(p).item(), float(jm.negative_log_likelihood_function(
            X[6:], y[6:])(p)), rtol=RTOL)


def test_float32_likelihood_is_summed_in_float64(rng):
    """Float32 training data give a float64 likelihood whose error is that
    of its terms, not of a float32 sum of ~0.92 a column: at 4,096 columns
    (value ~3,800, one float32 ulp 2.4e-4) within 5e-5 of the float64
    value, where the reference in float32 can do no better than its ulp;
    and a 1e-3 step in the angle moves the float32 value as it moves the
    float64 one, to 1e-4 (the difference a simplex has to see)."""
    jm, tm = _models(True, True, True, 1.5)
    n = 4096
    X = rng.uniform(-3500, 3500, size=(n, 2))
    truth = np.asarray([1500.0, 900.0, 0.3])
    y = np.asarray(jm._model_correlation(jnp.asarray(X), jnp.asarray(truth)))
    z = np.arctanh(np.clip(y, -0.999999, 0.999999)) + rng.normal(0, 0.13, n)
    w = np.ones(n)

    def value(p, dtype):
        return tm._nll_fit_z(*(torch.as_tensor(np.asarray(a), dtype=dtype)
                               for a in (p, X, z, w)))

    moved = truth + np.asarray([0.0, 0.0, 1e-3])
    f32 = value(truth, torch.float32), value(moved, torch.float32)
    f64 = value(truth, torch.float64), value(moved, torch.float64)
    assert f32[0].dtype == torch.float64
    assert abs(float(f64[0])) > 3000.0
    assert abs(float(f32[0] - f64[0])) < 5e-5
    assert abs(float((f32[1] - f32[0]) - (f64[1] - f64[0]))) < 1e-4


def test_float32_simplex_needs_the_float64_sum():
    """Why the port sums the likelihood in float64: 8 lanes of 4,096
    columns, the 1-degree grid's configuration (guesses 2,000 km and 0
    rad, tol 1e-3), through batched Nelder-Mead.

    In float64 the two packages walk the same simplex (`nit` equal,
    optimum to 1e-8). In float32 the reference's float32 sum (~3,800, one
    ulp 2.4e-4) cannot show the simplex differences of 1e-3: it stops
    after about a third of the iterations with the angle where it started
    (under 0.01 rad on most lanes, where the optimum's is up to 0.43) and
    Lx percents off. The port's float32 fit, summed in float64, meets the
    float64 optimum: Lx and Ly to 1e-3 relative, the angle to 5e-3 rad."""
    from glomargridding_tpu.ops.optim import batched_nelder_mead as ref_nm
    from glomargridding_tpu_torch.ops.optim import batched_nelder_mead

    rng = np.random.default_rng(3)
    jm, tm = _models(True, True, True, 1.5)
    B, n = 8, 4096
    X = rng.uniform(-3500, 3500, size=(B, n, 2))
    truth = np.column_stack([rng.uniform(1200, 2200, B),
                             rng.uniform(600, 1100, B),
                             rng.uniform(-0.5, 0.5, B)])
    z = np.stack([
        np.arctanh(np.clip(np.asarray(jm._model_correlation(
            jnp.asarray(X[b]), jnp.asarray(truth[b]))), -0.999999, 0.999999))
        for b in range(B)]) + rng.normal(0, 0.13, (B, n))
    w = np.ones((B, n))
    x0 = np.tile([2000.0, 2000.0, 0.0], (B, 1))
    lo = np.array([300.0, 300.0, -2 * np.pi])
    hi = np.array([30000.0, 30000.0, 2 * np.pi])

    def ours(dt):
        res = batched_nelder_mead(
            tm._nll_fit_z, x0.astype(dt),
            (X.astype(dt), z.astype(dt), w.astype(dt)),
            (lo.astype(dt), hi.astype(dt)), xatol=1e-3, fatol=1e-3,
            device="cpu")
        return res.x.double().numpy(), res.nit.numpy()

    def theirs(dt):
        res = ref_nm(
            jm._nll_fit_z, jnp.asarray(x0, dt),
            tuple(jnp.asarray(a, dt) for a in (X, z, w)),
            (jnp.asarray(lo, dt), jnp.asarray(hi, dt)), xatol=1e-3,
            fatol=1e-3)
        return np.asarray(res.x, float), np.asarray(res.nit)

    x64, nit64 = ours(np.float64)
    ref64, ref_nit64 = theirs(np.float64)
    np.testing.assert_array_equal(nit64, ref_nit64)
    np.testing.assert_allclose(x64, ref64, rtol=1e-8, atol=1e-8)
    assert np.abs(x64[:, 2]).max() > 0.3

    ref32, ref_nit32 = theirs(np.float32)
    assert np.median(ref_nit32) < 0.5 * np.median(nit64)
    assert np.median(np.abs(ref32[:, 2])) < 0.01
    assert np.median(np.abs(ref32[:, 0] - x64[:, 0]) / x64[:, 0]) > 5e-3

    x32, nit32 = ours(np.float32)
    assert np.median(nit32) > 0.75 * np.median(nit64)
    np.testing.assert_allclose(x32[:, :2], x64[:, :2], rtol=1e-3)
    np.testing.assert_allclose(x32[:, 2], x64[:, 2], atol=5e-3)


def _isotropic_fit_data(rng, n=300):
    d = rng.uniform(0.5, 25.0, n)
    y = np.exp(-np.sqrt(2.0) * d / 9.0 * np.sqrt(0.5) * np.sqrt(2.0))
    return d, np.clip(y + rng.normal(0, 0.02, n), -0.999, 0.999)


def _anisotropic_fit_data(rng, n=400):
    X = rng.uniform(-4000, 4000, (n, 2))
    truth = jmodel.EllipseModel(True, True, True, 0.5, unit_sigma=True)
    y = np.asarray(truth._model_correlation(
        jnp.asarray(X), jnp.asarray([1800.0, 700.0, 0.5])))
    return X, np.clip(y + rng.normal(0, 0.03, n), -0.999, 0.999)


def test_fit_nelder_mead_on_the_ellipse_nll(rng):
    """The optimum to 1e-4 relative, `nit` within a few (the walk is the
    same until a comparison falls on the objective's last bits)."""
    jm, tm = _models(True, True, True, 0.5)
    X, y = _anisotropic_fit_data(rng)
    kw = dict(guesses=[1000.0, 1000.0, 0.0],
              bounds=[(300.0, 10000.0), (300.0, 10000.0),
                      (-2 * np.pi, 2 * np.pi)], tol=1e-6, estimate_SE=None)
    ours, se, bounds = tm.fit(X, y, device="cpu", **kw)
    ref, ref_se, ref_bounds = jm.fit(X, y, **kw)
    assert se is None and ref_se is None and bounds == ref_bounds
    assert bool(ours.success)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-4)
    np.testing.assert_allclose(ours.fun.item(), float(ref.fun), rtol=1e-8)
    assert abs(int(ours.nit) - int(ref.nit)) <= 5
    np.testing.assert_allclose(ours.x.numpy()[:2], [1800.0, 700.0],
                               rtol=0.05)


def test_fit_lbfgs_and_hessian_se(rng):
    """L-BFGS at the optimum (|grad| <= 1e-8 on both sides), and the
    Fisher-information standard errors there against the reference's at
    its own optimum. The likelihood scale is fitted."""
    jm, tm = _models(False, False, False, 0.5, unit_sigma=False)
    d, y = _isotropic_fit_data(rng)
    kw = dict(opt_method="L-BFGS-B", estimate_SE="hessian", tol=1e-8)
    ours, se, _ = tm.fit(d, y, device="cpu", **kw)
    ref, ref_se, _ = jm.fit(d, y, **kw)
    assert bool(ours.success) and bool(ref.success)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-6)
    assert np.isfinite(se).all() and se.shape == (2,)
    np.testing.assert_allclose(se, ref_se, rtol=1e-5)
    # the same Hessian at the same point: roundoff only
    np.testing.assert_allclose(
        tm._hessian_se(torch.as_tensor(d), torch.as_tensor(y),
                       torch.as_tensor(np.asarray(ref.x))),
        ref_se, rtol=1e-8)
    with pytest.raises(ValueError, match="opt_method"):
        tm.fit(d, y, opt_method="Powell", estimate_SE=None, device="cpu")
    with pytest.raises(ValueError, match="estimate_SE"):
        tm.fit(d, y, estimate_SE="jackknife", device="cpu")


def test_bootstrap_se_with_replayed_counts(rng):
    """The reference draws its resamples from ``jax.random``: the same
    counts, handed over as numpy, give the same refits (tol 1e-6, so the
    spread of 16 optima agrees to 1e-3)."""
    jm, tm = _models(False, False, False, 0.5, unit_sigma=False)
    d, y = _isotropic_fit_data(rng, n=120)
    n, n_sim, seed = len(y), 16, 77
    keys = jax.random.split(jax.random.key(seed), n_sim)
    counts = np.stack([
        np.bincount(np.asarray(jax.random.randint(k, (n,), 0, n)),
                    minlength=n) for k in keys]).astype(float)
    kw = dict(estimate_SE="bootstrap_parallel", n_sim=n_sim, tol=1e-6,
              random_seed=seed)
    ours, se, _ = tm.fit(d, y, counts=counts, device="cpu", **kw)
    ref, ref_se, _ = jm.fit(d, y, **kw)
    assert se.shape == (2,)
    np.testing.assert_allclose(se, ref_se, rtol=1e-3)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-4)
    with pytest.raises(ValueError, match="counts must be"):
        tm.fit(d, y, counts=counts[:3], device="cpu", **kw)


def test_bootstrap_se_from_a_generator(rng):
    """Without counts the resamples come from a torch generator: the
    same seed gives the same standard errors, of the bootstrap's order."""
    _, tm = _models(False, False, False, 0.5, unit_sigma=False)
    d, y = _isotropic_fit_data(rng, n=120)
    kw = dict(estimate_SE="bootstrap_serial", n_sim=12, device="cpu")
    _, se_a, _ = tm.fit(d, y, random_seed=5, **kw)
    _, se_b, _ = tm.fit(d, y, generator=torch.Generator().manual_seed(5),
                        **kw)
    np.testing.assert_array_equal(se_a, se_b)
    _, se_h, _ = tm.fit(d, y, estimate_SE="hessian", device="cpu")
    assert 0.2 < se_h[0] / se_a[0] < 5.0


def test_bootstrap_once_matches(rng):
    jm, tm = _models(True, True, True, 0.5)
    X, y = _anisotropic_fit_data(rng, n=150)
    args = ([1000.0, 1000.0, 0.0],
            [(300.0, 10000.0), (300.0, 10000.0), (-2 * np.pi, 2 * np.pi)],
            "Nelder-Mead")
    ours = tm._bootstrap_once(X, y, *args, tol=1e-6, seed=3, device="cpu")
    ref = jm._bootstrap_once(X, y, *args, tol=1e-6, seed=3)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_fit_setup_appends_the_likelihood_scale():
    jm, tm = _models(True, False, True, 1.5, unit_sigma=False)
    x0, (lo, hi), bounds = tm._fit_setup(None, None, torch.float64, "cpu")
    rx0, (rlo, rhi), rbounds = jm._fit_setup(None, None)
    assert bounds == rbounds
    for ours, ref in ((x0, rx0), (lo, rlo), (hi, rhi)):
        assert ours.dtype == torch.float64
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
