"""The port's ``EllipseBuilder`` against the JAX package's, on the CPU in
f64 on the same numpy cubes, and the slice as a whole: cube ->
``EllipseBuilder`` -> ``compute_params`` -> ``EllipseCovarianceBuilder``.

Bounds, each beside its assert: the correlation and the training data are
the same formula (1e-12); Levenberg-Marquardt is a statement-for-statement
port (fields 1e-8, `nit` equal); Nelder-Mead walks the same path until a
comparison falls on the objective's last bits (fields 1e-4 relative, QC
codes equal, `nit` within 10 of ~180); L-BFGS has its own line search (the
optimum, theta modulo pi).
"""

import json

import numpy as np
import pytest
import torch

from glomargridding_tpu.core.labeled import Coordinates as JCoordinates
from glomargridding_tpu.models.ellipse import (
    EllipseBuilder as JBuilder,
    EllipseCovarianceBuilder as JCovBuilder,
    EllipseModel as JModel,
)
from glomargridding_tpu.models.ellipse import estimate as jest
from glomargridding_tpu_torch import convert
from glomargridding_tpu_torch.models.ellipse import estimate as test_mod
from glomargridding_tpu_torch.models.ellipse.estimate import (
    EllipseBuilder,
    _LazyCorrelation,
)
from glomargridding_tpu_torch.utils.arrays import uncompress_masked

torch.set_num_threads(2)

SIZE = (6, 8)
MODEL_KW = dict(anisotropic=True, rotated=True, physical_distance=True,
                v=0.5, unit_sigma=True)
FIT_KW = dict(
    default_value=[-999.0] * 6,
    max_distance=8000.0,
    guesses=[500.0, 500.0, 0.0],
    bounds=[(100.0, 20000.0), (100.0, 20000.0), (-2 * np.pi, 2 * np.pi)],
    delta_x_method="Modified_Met_Office",
)
PARAMETER_FIELDS = ("Lx", "Ly", "theta")


def _axes(size=SIZE, dtype=np.float64):
    """f64 axes: the geometry is computed in the coordinates' dtype, and
    in f32 the two packages' sin and cos differ in the last bit."""
    return (np.linspace(-21.0, 21.0, size[0]).astype(dtype),
            np.linspace(0.0, 27.0, size[1]).astype(dtype))


def _cube(seed=31900, size=SIZE, n_t=400, masked=True):
    """A training cube drawn from an anisotropic exponential covariance
    on the grid, with two cells masked (NaN)."""
    rng = np.random.default_rng(seed)
    lats, lons = _axes(size)
    cov = np.asarray(JCovBuilder(
        np.full(size, 1500.0), np.full(size, 900.0), np.full(size, 0.3),
        np.ones(size), lats, lons, v=0.5).cov_ns)
    cov = cov + 1e-6 * np.eye(cov.shape[0])
    data = (np.linalg.cholesky(cov) @ rng.normal(size=(cov.shape[0], n_t))
            ).T.reshape((n_t, *size))
    if masked:
        data[:, 2, 3] = np.nan
        data[:, 5, 0] = np.nan
    return data, {"time": np.arange(n_t), "latitude": lats,
                  "longitude": lons}


def _models():
    jm = JModel(**MODEL_KW)
    return jm, convert.ellipse_model_from_params(vars(jm))


@pytest.fixture(scope="module")
def builders():
    data, coords = _cube()
    return (JBuilder(data, JCoordinates(coords)),
            EllipseBuilder(data, coords, device="cpu"))


_REFERENCE_FITS = {}


def _reference_fit(jb, **kw):
    """The JAX package's compute_params, once per configuration."""
    key = json.dumps({k: v for k, v in kw.items()}, sort_keys=True,
                     default=str)
    if key not in _REFERENCE_FITS:
        _REFERENCE_FITS[key] = jb.compute_params(
            matern_ellipse=JModel(**MODEL_KW), **{**FIT_KW, **kw})
    return _REFERENCE_FITS[key]


def _port_fit(tb, **kw):
    return tb.compute_params(matern_ellipse=_models()[1], **{**FIT_KW, **kw})


def _assert_fields(ours, ref, names, **tol):
    for name in names:
        np.testing.assert_allclose(ours[name].values, ref[name].values,
                                   err_msg=name, **tol)


@pytest.mark.parametrize("cube_kind", ["masked_array", "nan_tensor"])
def test_mask_bookkeeping_and_correlation(builders, cube_kind):
    """A masked numpy cube and a NaN tensor cube give the reference's
    bookkeeping, correlation (1e-12), covariance and its diagonal."""
    jb, _ = builders
    data, coords = _cube()
    if cube_kind == "masked_array":
        tb = EllipseBuilder(np.ma.masked_invalid(data), coords, device="cpu")
    else:
        tb = EllipseBuilder(torch.as_tensor(data), coords)
        assert isinstance(tb.data, torch.Tensor)
    assert tb.small_covar_size == jb.small_covar_size == 46
    assert tb.big_covar_size == 48 and tb.data_has_mask
    for name in ("mask", "mask_1D", "xi_masked", "yi_masked", "xy_masked"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    np.testing.assert_array_equal(tb.xy_full.mask, jb.xy_full.mask)
    assert tb.cor.dtype == torch.float64 and tb.cor.device.type == "cpu"
    np.testing.assert_allclose(tb.cor.numpy(), np.asarray(jb.cor),
                               rtol=1e-12, atol=1e-14)
    assert bool((torch.diagonal(tb.cor) == 1.0).all())
    np.testing.assert_allclose(tb.cov.numpy(), np.asarray(jb.cov),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tb.cov_diagonal, jb.cov_diagonal, rtol=1e-12)
    assert tb.find_nearest_xy_index_in_cov_matrix((10.0, 3.0))[0] == (
        jb.find_nearest_xy_index_in_cov_matrix((10.0, 3.0))[0])
    assert tb._xy_2_xy_full_index(20) == jb._xy_2_xy_full_index(20)


def test_rounded_covariance_and_refusals():
    data, coords = _cube(masked=False, n_t=80)
    jb = JBuilder(data, JCoordinates(coords))
    tb = EllipseBuilder(data, coords, device="cpu")
    jb.calc_cov(rounding=3)
    tb.calc_cov(rounding=3)
    np.testing.assert_allclose(tb.cor.numpy(), np.asarray(jb.cor),
                               atol=1e-12)
    lazy = EllipseBuilder(data, coords, cor_mode="lazy", device="cpu")
    with pytest.raises(ValueError, match="rounding requires"):
        lazy.calc_cov(rounding=3)
    with pytest.raises(ValueError, match="cor_mode"):
        EllipseBuilder(data, coords, cor_mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="time dimension not at 0"):
        EllipseBuilder(data, {"latitude": coords["latitude"],
                              "time": coords["time"],
                              "longitude": coords["longitude"]},
                       device="cpu")
    with pytest.raises(ValueError, match="2D"):
        EllipseBuilder(data[..., None], coords, device="cpu")


def test_auto_mode_goes_lazy_by_size(monkeypatch):
    data, coords = _cube(masked=False, n_t=40)
    assert not isinstance(EllipseBuilder(data, coords, device="cpu").cor,
                          _LazyCorrelation)
    monkeypatch.setattr(test_mod, "_CPU_DENSE_COR_POINTS", 47)
    assert isinstance(EllipseBuilder(data, coords, device="cpu").cor,
                      _LazyCorrelation)


@pytest.mark.parametrize("regime", ["physical", "degrees", "degree_window"])
def test_train_data_selection_regimes(builders, regime):
    """(X, y) of one centre for the three selection regimes, anisotropic
    and isotropic: the same rows, 1e-12."""
    jb, tb = builders
    kw = {
        "physical": dict(min_distance=0.3, max_distance=3000.0,
                         delta_x_method="Modified_Met_Office",
                         physical_distance=True,
                         physical_distance_selection=True),
        "degrees": dict(min_distance=0.1, max_distance=20.0,
                        delta_x_method=None, physical_distance=False,
                        physical_distance_selection=False),
        "degree_window": dict(min_distance=0.1, max_distance=20.0,
                              delta_x_method="Met_Office",
                              physical_distance=True,
                              physical_distance_selection=False),
    }[regime]
    for anisotropic in (True, False):
        X, y = tb._get_train_data(xy_point=12, anisotropic=anisotropic, **kw)
        rX, ry = jb._get_train_data(xy_point=12, anisotropic=anisotropic,
                                    **kw)
        assert 0 < len(y) < 45
        np.testing.assert_allclose(X, rX, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(y, ry, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="unset delta_x_method"):
        tb._get_train_data(12, 0.1, 20.0, True, None, physical_distance=True)


def test_fit_ellipse_model_single_point(builders):
    jb, tb = builders
    kw = {k: v for k, v in FIT_KW.items() if k != "default_value"}
    jm, tm = _models()
    ours = tb.fit_ellipse_model(xy_point=12, matern_ellipse=tm, tol=1e-5,
                                **kw)
    ref = jb.fit_ellipse_model(xy_point=12, matern_ellipse=jm, tol=1e-5,
                               **kw)
    assert ours["Success"] == ref["Success"] == 0
    np.testing.assert_allclose(ours["ModelParams"][:3],
                               ref["ModelParams"][:3], rtol=1e-4)
    assert ours["ModelParams"][3] == pytest.approx(ref["ModelParams"][3],
                                                   rel=1e-12)
    assert abs(ours["ModelParams"][5] - ref["ModelParams"][5]) <= 5
    np.testing.assert_allclose(ours["Correlation"], ref["Correlation"],
                               rtol=1e-12, equal_nan=True)
    with pytest.warns(UserWarning, match="No training data"):
        assert tb.fit_ellipse_model(12, tm, max_distance=1.0, **{
            k: v for k, v in kw.items() if k != "max_distance"}) is None


def test_compute_params_nelder_mead(builders):
    jb, tb = builders
    ours = _port_fit(tb, tol=1e-5)
    ref = _reference_fit(jb, tol=1e-5)
    assert list(ours.keys()) == list(ref.keys())
    np.testing.assert_array_equal(ours["qc_code"].values,
                                  ref["qc_code"].values)
    _assert_fields(ours, ref, PARAMETER_FIELDS, rtol=1e-4)
    _assert_fields(ours, ref, ["standard_deviation"], rtol=1e-12)
    # ~180 steps a lane; once a comparison falls the other way the two
    # walks need a few more or fewer to the same tolerance
    assert np.max(np.abs(ours["number_of_iterations"].values
                         - ref["number_of_iterations"].values)) <= 10
    # the masked cells keep the default; fitted cells are canonical
    assert ours["Lx"].values[2, 3] == -999.0
    fitted = ours["Lx"].values > 0
    assert fitted.sum() == 46
    assert (ours["Lx"].values[fitted] >= ours["Ly"].values[fitted]).all()
    assert ours["Lx"].attrs == {"units": "km"}


def test_compute_params_levenberg_marquardt(builders):
    jb, tb = builders
    ours = _port_fit(tb, tol=1e-8, opt_method="lm")
    ref = _reference_fit(jb, tol=1e-8, opt_method="lm")
    np.testing.assert_array_equal(ours["qc_code"].values,
                                  ref["qc_code"].values)
    np.testing.assert_array_equal(ours["number_of_iterations"].values,
                                  ref["number_of_iterations"].values)
    _assert_fields(ours, ref, PARAMETER_FIELDS, rtol=1e-8)
    # the same optimum as Nelder-Mead, to the reference test's bound,
    # wherever the reference's own two lanes found one optimum
    nm, ref_nm = _port_fit(tb, tol=1e-5), _reference_fit(jb, tol=1e-5)
    for name in ("Lx", "Ly"):
        one = np.isclose(ref[name].values, ref_nm[name].values, rtol=0.05)
        assert one.mean() > 0.8
        np.testing.assert_allclose(ours[name].values[one],
                                   nm[name].values[one], rtol=0.05)


def test_compute_params_lbfgs(builders):
    jb, tb = builders
    ours = _port_fit(tb, tol=1e-5, opt_method="L-BFGS-B")
    ref = _reference_fit(jb, tol=1e-5, opt_method="L-BFGS-B")
    sel = ref["qc_code"].values == 0
    assert (ours["qc_code"].values[sel] == 0).all() and sel.sum() > 40
    for name in ("Lx", "Ly"):
        np.testing.assert_allclose(ours[name].values[sel],
                                   ref[name].values[sel], rtol=1e-3)
    # an ellipse is its own image under a half turn
    dth = ours["theta"].values[sel] - ref["theta"].values[sel]
    assert np.max(np.abs((dth + np.pi / 2) % np.pi - np.pi / 2)) <= 1e-3


def test_compute_params_refuses_what_it_does_not_run(builders):
    _, tb = builders
    with pytest.raises(ValueError, match="opt_method"):
        _port_fit(tb, opt_method="Powell")
    # the sharded fit (mesh=) runs: it refuses an axis its mesh lacks
    from glomargridding_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="no axis"):
        _port_fit(tb, mesh=make_mesh(devices=["cpu"] * 2), mesh_axis="space")


def test_chunking_and_dispatch_chunks_change_nothing(builders, monkeypatch):
    """Chunks of 16 (the last one padded), `dispatch_chunks`, and a chunk
    size cut by the memory cap (with its warning) give the one-chunk
    fields: lanes do not see each other. To 1e-10, not bitwise: the sum
    over a lane's columns is vectorised by the batch's shape."""
    _, tb = builders
    whole = _port_fit(tb, tol=1e-8, opt_method="lm")
    chunked = _port_fit(tb, tol=1e-8, opt_method="lm", chunk_size=16,
                        dispatch_chunks=4)
    monkeypatch.setattr(test_mod, "_CPU_CHUNK_BUDGET_BYTES", 1.0)
    with pytest.warns(UserWarning, match=r"chunk_size 1024 -> 256.*host"):
        capped = _port_fit(tb, tol=1e-8, opt_method="lm")
    for name in whole.keys():
        np.testing.assert_allclose(whole[name].values, chunked[name].values,
                                   rtol=1e-10)
        np.testing.assert_array_equal(whole[name].values,
                                      capped[name].values)


def test_lazy_correlation_matches_dense(builders):
    jb, dense = builders
    data, coords = _cube()
    lazy = EllipseBuilder(data, coords, cor_mode="lazy", device="cpu")
    assert isinstance(lazy.cor, _LazyCorrelation)
    np.testing.assert_allclose(lazy.cor[3, :].numpy(), dense.cor[3].numpy(),
                               rtol=1e-12, atol=1e-14)
    assert float(lazy.cor[3, 3]) == 1.0
    np.testing.assert_allclose(lazy.cor[3, :].numpy(),
                               np.asarray(jb.cor[3, :]), rtol=1e-12,
                               atol=1e-14)
    kw = dict(tol=1e-8, opt_method="lm", max_train_cols=45)
    ours, want = _port_fit(lazy, **kw), _port_fit(dense, **kw)
    np.testing.assert_array_equal(ours["qc_code"].values,
                                  want["qc_code"].values)
    _assert_fields(ours, want, PARAMETER_FIELDS, rtol=1e-8)
    with pytest.raises((MemoryError, TypeError)):
        np.asarray(lazy.cor)
    with pytest.raises(TypeError):
        lazy.cor[:, 0]


def test_max_train_cols_exact_when_the_window_is_covered(builders):
    """K = n - 1 covers every window (all but the centre), so the top-k
    gather only reorders the columns: the unrestricted fit up to the
    order of the sums, here and against the reference's capped fit. A
    tie at the k-th distance cannot matter: no in-window column is left
    out."""
    jb, tb = builders
    kw = dict(tol=1e-8, opt_method="lm")
    full = _port_fit(tb, **kw)
    capped = _port_fit(tb, max_train_cols=45, **kw)
    np.testing.assert_array_equal(full["qc_code"].values,
                                  capped["qc_code"].values)
    _assert_fields(capped, full, PARAMETER_FIELDS, rtol=1e-8)
    _assert_fields(capped, _reference_fit(jb, max_train_cols=45, **kw),
                   PARAMETER_FIELDS, rtol=1e-8)
    # a restrictive K: the selected distances are the reference's as a
    # multiset (which tied column is taken is not defined), rows 12, 30
    sel = torch.tensor([12, 30])
    geo = dict(min_distance=0.3, max_distance=8000.0, anisotropic=True,
               delta_x_method="Modified_Met_Office", physical_distance=True,
               physical_distance_selection=True)
    lats, lons = tb._point_coords()
    X, y, w = test_mod._chunk_train_data(lats, lons, tb.cor, sel,
                                         max_train_cols=10, **geo)
    import jax.numpy as jnp
    rX, ry, rw = jest._chunk_train_data(
        jnp.asarray(tb.xy_masked[:, 1]), jnp.asarray(tb.xy_masked[:, 0]),
        jnp.asarray(jb.cor), jnp.asarray(sel.numpy()), max_train_cols=10,
        **geo)
    assert X.shape == (2, 10, 2) and X.dtype == torch.float64
    np.testing.assert_allclose(np.sort((X.numpy() ** 2).sum(-1), axis=1),
                               np.sort((np.asarray(rX) ** 2).sum(-1), axis=1),
                               rtol=1e-6)
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    small = _port_fit(tb, max_train_cols=10, **kw)
    assert set(np.unique(small["qc_code"].values)) <= {-999.0, 0.0, 1.0, 2.0,
                                                       3.0, 9.0}


def test_hessian_standard_error_fields(builders):
    """The second pass at the raw optima. The Hessian's entries span
    eight orders of magnitude (km against radians), so its inverse moves
    by ~1e-6 with the order of the sums: 1e-4."""
    jb, tb = builders
    kw = dict(tol=1e-8, opt_method="lm", estimate_SE="hessian")
    ours, ref = _port_fit(tb, **kw), _reference_fit(jb, **kw)
    names = [f"{n}_se" for n in PARAMETER_FIELDS]
    assert list(ours.keys()) == list(ref.keys())
    for name in names:
        a, b = ours[name].values, ref[name].values
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(a).sum() > 40
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=name)
    assert ours["Lx_se"].attrs == {"units": "km"}
    assert np.isnan(ours["Lx_se"].values[2, 3])


def test_lane_without_a_likelihood_gets_qc_9():
    """A cell whose correlations are NaN never converges: QC 9 from the
    simplex (it runs to maxiter) and from Levenberg-Marquardt (damping
    saturates), and no standard error; its neighbours still fit."""
    data, coords = _cube(size=(3, 4), n_t=60, masked=False)
    tb = EllipseBuilder(data, coords, device="cpu")
    jb = JBuilder(data, JCoordinates(coords))
    tb.cor[5, :] = torch.nan
    jb.cor = jb.cor.at[5, :].set(np.nan)
    jm, tm = _models()
    for opt, tol in (("Nelder-Mead", 1e-4), ("lm", 1e-8)):
        kw = {**FIT_KW, "tol": tol, "opt_method": opt,
              "estimate_SE": "hessian"}
        ours = tb.compute_params(matern_ellipse=tm, **kw)
        ref = jb.compute_params(matern_ellipse=jm, **kw)
        qc = ours["qc_code"].values
        assert qc[1, 1] == 9 and (np.delete(qc.ravel(), 5) != 9).sum() >= 9
        np.testing.assert_array_equal(qc, ref["qc_code"].values)
        assert np.isnan(ours["Lx_se"].values[1, 1])
        if opt == "Nelder-Mead":
            assert ours["number_of_iterations"].values[1, 1] == 600


def test_isotropic_and_degree_models(builders):
    """The one-parameter physical model and the rotated degrees model
    (selection by degree distance) through the batched fit."""
    jb, tb = builders
    for model_kw, fit_kw, names in (
        (dict(anisotropic=False, rotated=False, physical_distance=True,
              v=1.5, unit_sigma=True),
         dict(bounds=[(100.0, 20000.0)], guesses=[500.0]), ("R",)),
        (dict(anisotropic=True, rotated=True, physical_distance=False,
              v=0.5, unit_sigma=False),
         dict(bounds=[(0.5, 50.0), (0.5, 30.0), (-2 * np.pi, 2 * np.pi)],
              guesses=[5.0, 5.0, 0.0], max_distance=60.0, min_distance=0.1,
              delta_x_method=None, physical_distance_selection=False),
         PARAMETER_FIELDS),
    ):
        jm = JModel(**model_kw)
        kw = {**FIT_KW, **fit_kw, "tol": 1e-8, "opt_method": "lm",
              "default_value": [-999.0] * jm.supercategory_n_params}
        ours = tb.compute_params(
            matern_ellipse=convert.ellipse_model_from_params(vars(jm)), **kw)
        ref = jb.compute_params(matern_ellipse=jm, **kw)
        np.testing.assert_array_equal(ours["qc_code"].values,
                                      ref["qc_code"].values)
        _assert_fields(ours, ref, names, rtol=1e-7)


def test_checkpoint_resume_refuse_refit(tmp_path):
    """A stopped fit resumes to the same fields; another cube or another
    configuration is refused; an older fingerprint format is refitted
    with a warning; a corrupt one is refused."""
    data, coords = _cube(size=(4, 5), n_t=80, masked=False)
    tb = EllipseBuilder(data, coords, device="cpu")
    kw = dict(tol=1e-8, opt_method="lm", chunk_size=8, checkpoint_every=1)
    want = _port_fit(tb, **kw)
    path = str(tmp_path / "fit.npz")

    # stop after two chunks: the third chunk's build raises
    calls = {"n": 0}
    real = test_mod._chunk_train_data

    def stopping(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return real(*a, **k)

    test_mod._chunk_train_data = stopping
    try:
        with pytest.raises(KeyboardInterrupt):
            _port_fit(tb, checkpoint=path, **kw)
    finally:
        test_mod._chunk_train_data = real
    with np.load(path) as saved:
        assert int(saved["n_done"]) == 16
        assert sorted(saved.files) == ["fingerprint", "has_data", "n_done",
                                       "nit", "success", "x"]
        fingerprint = json.loads(str(saved["fingerprint"]))
    assert sorted(fingerprint) == sorted(
        ["n_points", "data", "model", "opt", "chunk", "d", "tol", "win",
         "cols", "dx", "phys_sel", "x0", "lo", "hi"])
    calls["n"] = 0
    test_mod._chunk_train_data = lambda *a, **k: (
        calls.__setitem__("n", calls["n"] + 1), real(*a, **k))[1]
    try:
        resumed = _port_fit(tb, checkpoint=path, **kw)
        assert calls["n"] == 1  # 20 points: only the last chunk was left
        again = _port_fit(tb, checkpoint=path, **kw)
        assert calls["n"] == 1  # fully saved: nothing is fitted
    finally:
        test_mod._chunk_train_data = real
    for name in want.keys():
        np.testing.assert_array_equal(resumed[name].values,
                                      want[name].values)
        np.testing.assert_array_equal(again[name].values, want[name].values)

    with pytest.raises(ValueError, match="different configuration"):
        _port_fit(tb, checkpoint=path, **{**kw, "tol": 1e-7})
    other = EllipseBuilder(data * 1.01, coords, device="cpu")
    with pytest.raises(ValueError, match="different configuration"):
        _port_fit(other, checkpoint=path, **kw)

    with np.load(path) as saved:
        parts = {k: saved[k] for k in saved.files}
    old = {k: v for k, v in fingerprint.items() if k != "data"}
    np.savez(path, **{**parts, "fingerprint": np.asarray(json.dumps(old))})
    with pytest.warns(UserWarning, match="older fingerprint format"):
        refit = _port_fit(tb, checkpoint=path, **kw)
    np.testing.assert_array_equal(refit["Lx"].values, want["Lx"].values)
    with np.load(path) as saved:
        assert json.loads(str(saved["fingerprint"])) == fingerprint

    np.savez(path, **{**parts, "fingerprint": np.asarray("not json")})
    with pytest.raises(ValueError, match="different configuration"):
        _port_fit(tb, checkpoint=path, **kw)


def test_postprocessing_and_scores():
    """The vectorised canonicalisation and QC against the scalar
    pipeline, on optima that swap axes, wrap theta and sit on bounds."""
    _, tm = _models()
    bounds = FIT_KW["bounds"]
    fitted = np.array([[900.0, 1500.0, 3.0], [1500.0, 900.0, -3.5],
                       [100.0, 100.5, 0.2], [20000.0, 300.0, 2 * np.pi],
                       [800.0, 700.0, 0.1]])
    success = np.array([True, True, True, True, False])
    pm, score, swap = test_mod._postprocess_fits(fitted, success, tm, bounds,
                                                 3)
    tb = EllipseBuilder.__new__(EllipseBuilder)
    for row, ok, got, code in zip(fitted, success, pm, score):
        scalar = list(row)
        tb._check_params(tm, scalar)
        np.testing.assert_allclose(got, scalar, rtol=1e-15)
        assert code == (test_mod._get_fit_score(scalar, bounds, 0)
                        if ok else 9)
    assert swap.tolist() == [True, False, True, False, False]
    assert score.tolist() == [0, 0, 3, 2, 9]
    for args in (([100.0, 500.0, 0.0], bounds, 3),
                 ([20000.0, 100.0, 0.0], bounds, 3)):
        assert test_mod._get_fit_score(*args) == jest._get_fit_score(*args)


def test_init_parameter_set():
    lats, lons = _axes()
    names = _models()[1].supercategory_params
    ours = test_mod.init_parameter_set(
        {"latitude": lats, "longitude": lons}, names, default_value=-1.0)
    assert list(ours.keys()) == list(names)
    assert ours["theta"].values.shape == SIZE
    assert (ours["theta"].values == -1.0).all()
    assert ours["theta"].attrs == {"units": "radians"}
    per_field = test_mod.init_parameter_set(
        {"latitude": lats, "longitude": lons}, names,
        default_value=[1, 2, 3, 4, 5, 6])
    assert per_field["qc_code"].values[0, 0] == 5.0
    with pytest.raises(ValueError, match="default values"):
        test_mod.init_parameter_set({"latitude": lats, "longitude": lons},
                                    names, default_value=[1, 2])


def _global_cube(step=15.0, n_t=60, seed=7):
    """T states of a smooth random field on a coarse global grid: an
    exponential covariance of the great-circle distance (range 2,500 km),
    drawn through its Cholesky factor."""
    rng = np.random.default_rng(seed)
    lats = np.arange(-90 + step / 2, 90, step).astype(np.float32)
    lons = np.arange(-180 + step / 2, 180, step).astype(np.float32)
    la = np.radians(np.repeat(lats, lons.size).astype(float))
    lo = np.radians(np.tile(lons, lats.size).astype(float))
    cosang = (np.sin(la)[:, None] * np.sin(la)[None]
              + np.cos(la)[:, None] * np.cos(la)[None]
              * np.cos(lo[:, None] - lo[None]))
    dist = 6371.0 * np.arccos(np.clip(cosang, -1.0, 1.0))
    L = np.linalg.cholesky(np.exp(-dist / 2500.0) + 1e-8 * np.eye(la.size))
    field = (L @ rng.normal(size=(la.size, n_t))).T
    return (field.reshape((n_t, lats.size, lons.size)),
            {"time": np.arange(n_t), "latitude": lats, "longitude": lons})


def test_slice_end_to_end_cube_to_covariance():
    """The slice as a whole on a 15-degree global grid, T = 60: cube ->
    EllipseBuilder -> compute_params -> convert.ellipse_builder_from_dataset
    -> EllipseCovarianceBuilder.cov_ns (the plain twin of the symmetric
    ellipse kernel on the CPU), against the JAX pipeline on the same cube.
    Levenberg-Marquardt, so both sides take the same steps: the fields to
    1e-7 and max |dC| / max |C| <= 1e-6."""
    data, coords = _global_cube()
    lats, lons = coords["latitude"], coords["longitude"]
    model_kw = dict(anisotropic=True, rotated=True, physical_distance=True,
                    v=1.5, unit_sigma=True)
    fit_kw = dict(
        default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
        max_distance=6000.0, guesses=[2000.0, 2000.0, 0.0],
        bounds=[(300.0, 30000.0), (300.0, 30000.0),
                (-2.0 * np.pi, 2.0 * np.pi)],
        tol=1e-8, opt_method="lm", chunk_size=128,
        # covers every window, so that the top-k gather runs and no tie
        # at the k-th distance can choose the columns
        max_train_cols=287)
    jm = JModel(**model_kw)
    ref = JBuilder(data, JCoordinates(coords)).compute_params(
        matern_ellipse=jm, **fit_kw)
    tb = EllipseBuilder(data, coords, device="cpu")
    ours = tb.compute_params(
        matern_ellipse=convert.ellipse_model_from_params(vars(jm)), **fit_kw)
    np.testing.assert_array_equal(ours["qc_code"].values,
                                  ref["qc_code"].values)
    good = ref["qc_code"].values != 9
    assert good.mean() > 0.9
    for name in PARAMETER_FIELDS:
        np.testing.assert_allclose(ours[name].values[good],
                                   ref[name].values[good], rtol=1e-7,
                                   err_msg=name)

    bad = ~((ref["Lx"].values > 0) & good)
    ref_cov = np.asarray(JCovBuilder(
        *(np.ma.masked_where(bad, ref[n].values)
          for n in ("Lx", "Ly", "theta", "standard_deviation")),
        lats, lons, v=1.5, precision=np.float64).cov_ns)
    as_dataset = convert.dataset_from_arrays(
        {k: (v.values, v.attrs) for k, v in ours.items()},
        dict(ours.coords.items()))
    builder = convert.ellipse_builder_from_dataset(
        as_dataset, lats, lons, v=1.5, precision=np.float64, device="cpu")
    cov = builder.cov_ns
    assert cov.shape == ref_cov.shape == (int((~bad).sum()),) * 2
    rel = np.max(np.abs(cov.numpy() - ref_cov)) / np.max(np.abs(ref_cov))
    assert rel <= 1e-6, rel
    # the fitted standard deviation is the cube's own
    np.testing.assert_allclose(
        np.sqrt(np.diag(cov.numpy())),
        uncompress_masked(np.sqrt(tb.cov_diagonal), tb.mask_1D)[~bad.ravel()],
        rtol=1e-12)


def test_chunk_cap_counts_the_allocators_unused_blocks(monkeypatch):
    """On the card a chunk's build may take the blocks the caching
    allocator holds and no tensor uses: after a larger earlier build the
    CUDA runtime reports little free memory, and the cap must not fall to
    that (it cut a 259,200-lane fit from 2,048 to 256 lanes a chunk)."""
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (2e9, 80e9))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 70e9)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 6e9)
    card = SimpleNamespace(device=torch.device("cuda"))
    cap, assumed = test_mod.EllipseBuilder._chunk_cap(card, 259_200, 4)
    per_row = test_mod._CHUNK_VALUES_PER_PAIR * 4 * 259_200
    assert cap == int(test_mod._CHUNK_MEMORY_SHARE * 66e9 / per_row)
    assert cap >= 2048 and "66.0 GB" in assumed
    cpu = SimpleNamespace(device=torch.device("cpu"))
    cap_cpu, _ = test_mod.EllipseBuilder._chunk_cap(cpu, 259_200, 4)
    assert cap_cpu == int(test_mod._CPU_CHUNK_BUDGET_BYTES / per_row)
