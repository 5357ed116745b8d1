"""The port's workflow examples against the JAX package's on the
vendored HadSST4 / HadCRUT5 / ESA-CCI inputs (``examples/data``).

- The reduced ESA band (-40..0 degrees) through both examples: the
  stationary fields in f64 to 1e-8 of their scale; the fitted ellipse
  lengths by share of lanes (>= 95% within 1%), since about 2% of lanes
  have two optima.
- The full-grid non-stationary stages fed the stored run's ellipse fields
  (``examples/outputs/hadsst_workflow_fields.npz``) to both packages, so
  that the 36 s fit runs in neither: to 1e-8 where both build the
  covariance in f64, to 1e-4 where both build it in f32 as the example
  does; the stochastic member replays the JAX draws.
- The ESA months scan on its first months against the JAX functions,
  f64, 1e-8.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import torch_esa_months_scan as tscan  # noqa: E402
import torch_hadsst_workflow as twf  # noqa: E402
import torch_workflow_data as tdata  # noqa: E402

from glomargridding_tpu.io import load_array as jload  # noqa: E402
from glomargridding_tpu.models import kernel_kriging as jkk  # noqa: E402
from glomargridding_tpu.models import kriging as jkrig  # noqa: E402
from glomargridding_tpu.models import stochastic as jst  # noqa: E402
from glomargridding_tpu.models.ellipse import covariance as jcov  # noqa
from glomargridding_tpu.ops import covariance_tools as jct  # noqa: E402
from glomargridding_tpu.ops.variogram import MaternVariogram  # noqa: E402

torch.set_num_threads(4)
STORED = os.path.join(EXAMPLES, "outputs", "hadsst_workflow_fields.npz")
F64_TOL = 1e-8
F32_TOL = 1e-4
FIELDS = ("Lx", "Ly", "theta", "standard_deviation")


def _rel(ours, ref, scale=None):
    ours = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.max(np.abs(ref)) if scale is None else scale
    return float(np.max(np.abs(ours - ref)) / scale)


def _within_one_percent(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    fitted = ref > 0
    assert np.array_equal(ours > 0, fitted)
    return float(np.mean(np.abs(ours[fitted] / ref[fitted] - 1) <= 0.01))


@pytest.fixture(scope="module")
def stored():
    with np.load(STORED) as z:
        return {k: z[k] for k in z.files}


def test_reduced_band_workflow_through_both_packages():
    from hadsst_workflow import run as jrun

    kw = dict(esa_lat_band=(-40.0, 0.0), nm_tol=1e-3, chunk_size=512)
    ref = jrun(**kw)
    ours = twf.run(**kw, device="cpu", dtype=torch.float64, verbose=False)
    np.testing.assert_array_equal(ours["grid_idx"], ref["grid_idx"])
    np.testing.assert_array_equal(ours["grid_obs"], ref["grid_obs"])
    assert _rel(ours["anom_stat"], ref["anom_stat"]) <= F64_TOL
    assert _rel(ours["uncert_stat"], ref["uncert_stat"], 1.2**0.5) <= \
        F64_TOL
    assert "anom_non_stat" not in ours and "anom_non_stat" not in ref
    for name in ("Lx", "Ly"):
        share = _within_one_percent(ours["ellipse_params"][name].values,
                                    ref["ellipse_params"][name].values)
        assert share >= 0.95, (name, share)
    assert set(ours["times"]) >= {"stationary covariance",
                                  "ellipse MLE fit", "obs mapping"}


def _jax_nonstationary(stored, precision, year=2014, member=71):
    """Stages 3-7 of ``examples/hadsst_workflow.py`` on the stored
    ellipse fields, the covariance built at `precision`."""
    lat = np.arange(-87.5, 90, 5.0)
    lon = np.arange(-177.5, 180, 5.0)
    Lx = stored["ellipse_Lx"]
    mask = Lx < 0
    spatial = jcov.EllipseCovarianceBuilder(
        *(np.ma.masked_where(mask, stored[f"ellipse_{n}"]) for n in FIELDS),
        lat, lon, v=1.5, covariance_method="batched", batch_size=100_000,
        precision=precision)
    spatial.cov_ns = jct.eigenvalue_clip(
        np.asarray(spatial.cov_ns, dtype=np.float64))
    spatial.uncompress_cov(diag_fill_value=1.2, fill_value=0.0)
    cov = np.asarray(spatial.cov_ns)
    error_cov = twf.error_covariance(tdata.bundle_loader(), year)
    idx, obs = twf.member_observations(tdata.bundle_loader(),
                                       twf.global_grid(), year, member)
    ok = jkrig.OrdinaryKriging(cov, idx=idx, obs=obs, error_cov=error_cov)
    out = {"anom_non_stat": ok.solve(), "uncert_non_stat":
           ok.get_uncertainty(), "mask_non_stat": ok.constraint_mask(),
           "cv_non_stat": jkk.crossval_from_covariance(
               cov, idx, obs, error_cov=error_cov), "cov": cov,
           "error_cov": error_cov, "idx": idx, "obs": obs}
    return out


def _jax_member(ref):
    """The JAX member of key(0), and the normals it drew."""
    stok = jst.StochasticKriging(ref["cov"], idx=ref["idx"], obs=ref["obs"],
                                 error_cov=ref["error_cov"])
    key = jax.random.key(0)
    member = np.asarray(stok.solve(key=key))
    key_state, key_obs = jax.random.split(key)
    m = np.asarray(stok.error_cov).shape[0]
    noise = (np.array(jax.random.normal(key_state, (ref["cov"].shape[0],),
                                        jnp.float64)),
             np.array(jax.random.normal(key_obs, (m,), jnp.float64)))
    return member, noise


def test_full_grid_nonstationary_stages_f64(stored):
    """The whole example in f64 (the stored ellipses in place of the fit)
    against the JAX stages with the covariance built in f64."""
    ref = _jax_nonstationary(stored, np.float64)
    member, noise = _jax_member(ref)
    params = {n: stored[f"ellipse_{n}"] for n in FIELDS}
    ours = twf.run(device="cpu", dtype=torch.float64, ellipse_params=params,
                   noise=noise, verbose=False, load=tdata.bundle_loader())
    assert "ellipse MLE fit" not in ours["times"]
    assert _rel(ours["anom_non_stat"], ref["anom_non_stat"]) <= F64_TOL
    assert _rel(ours["uncert_non_stat"], ref["uncert_non_stat"],
                1.2**0.5) <= F64_TOL
    assert _rel(ours["mask_non_stat"], ref["mask_non_stat"], 1.0) <= F64_TOL
    for score in ("rmse", "mssr"):
        np.testing.assert_allclose(
            float(getattr(ours["cv_non_stat"], score)),
            float(getattr(ref["cv_non_stat"], score)), rtol=F64_TOL)
    assert _rel(ours["perturbed_anom"], member) <= F64_TOL
    # the stationary fields of the stored (TPU, f32) run hold to 1e-3
    assert _rel(ours["anom_stat"], stored["anom_stat"]) <= 1e-3
    assert _rel(ours["uncert_stat"], stored["uncert_stat"], 1.2**0.5) <= \
        1e-3


def test_full_grid_nonstationary_stages_f32_build(stored):
    """The covariance built in f32 by both packages, as the example
    builds it (the clip and the kriging in f64)."""
    ref = _jax_nonstationary(stored, np.float32)
    params = {n: stored[f"ellipse_{n}"] for n in FIELDS}
    cov = twf.nonstationary_covariance(
        params, np.arange(-87.5, 90, 5.0), np.arange(-177.5, 180, 5.0),
        torch.float32, "cpu")
    assert cov.dtype == torch.float64 and cov.shape == (2592, 2592)
    assert _rel(cov, ref["cov"]) <= F32_TOL
    field, unc, cmask = twf.krige(cov, ref["idx"], ref["obs"],
                                  ref["error_cov"])
    assert _rel(field, ref["anom_non_stat"]) <= F32_TOL
    assert _rel(unc, ref["uncert_non_stat"], 1.2**0.5) <= F32_TOL
    assert _rel(cmask, ref["mask_non_stat"], 1.0) <= F32_TOL


def test_1876_member_reads_alike():
    """The sparse-era month: the same observations and error covariance
    through the port's netCDF reader, the bundle and the JAX reader."""
    grid = twf.global_grid()
    ref_err = np.asarray(jload(
        f"{twf.DATA}/HadCRUT.5.0.2.0.error_covariance.1876_03.nc",
        "tas_cov").values)[0].astype(np.float64)
    ref_err[ref_err > 1e6] = 0.0
    unc = np.asarray(jload(
        f"{twf.DATA}/HadCRUT.5.0.2.0.uncorrelated_1876_03.nc",
        "tas_unc").values).reshape(-1).astype(np.float64)
    unc[unc > 1e6] = 0.0
    ref_err += np.diag(unc**2)
    tos = jload(f"{twf.DATA}/HadSST.4.0.1.0_ensemble_member_94_1876_03.nc",
                "tos").values.reshape(-1)
    ref_idx = np.nonzero(np.isfinite(tos) & (tos < 1e4))[0]
    for load in (twf.load_array, tdata.bundle_loader()):
        idx, obs = twf.member_observations(load, grid, 1876, 94)
        np.testing.assert_array_equal(twf.error_covariance(load, 1876),
                                      ref_err)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(obs, tos[ref_idx])
    assert 0 < idx.size < 1341


def _first_months(load, n=3):
    """A loader serving the first `n` months of the ESA cube (the scan's
    41 take ~30 s on the CPU in f64)."""
    def first(path, var):
        arr = load(path, var)
        if var != "sst_anomaly":
            return arr
        coords = dict(arr.coords.items())
        coords["time"] = coords["time"][:n]
        return type(arr)(np.asarray(arr.values)[:n], coords, name=arr.name,
                         dims=arr.dims)

    return first


@pytest.mark.parametrize("load", ["netcdf", "bundle"])
def test_months_scan_against_the_reference(load):
    loader = _first_months(twf.load_array if load == "netcdf"
                           else tdata.bundle_loader())
    out = tscan.run(device="cpu", dtype=torch.float64, load=loader,
                    verbose=False)
    glat, glon, idx_m, obs_m, err_m, _ = tscan.month_observations(
        loader, torch.float64)
    assert idx_m.shape[0] == 3
    kernel = jkk.variogram_kernel(MaternVariogram(
        psill=1.2, nugget=0.0, range=1300.0, nu=1.5, method="sklearn"))
    ref = jkk.months_scan_kriging(kernel, glat, glon, idx_m, obs_m, err_m,
                                  variance=1.2, n_blocks=4)
    assert _rel(out["fields"], ref[0]) <= F64_TOL
    assert _rel(out["fields_only"], ref[0]) <= F64_TOL
    assert _rel(out["uncertainty"], ref[1], 1.2**0.5) <= F64_TOL
    assert _rel(out["constraint_mask"], ref[2], 1.0) <= F64_TOL
    assert set(out["times"]) == {"fields cold", "fields warm",
                                 "fields+uncertainty+mask cold",
                                 "fields+uncertainty+mask warm"}


def test_bundle_matches_the_files():
    load = tdata.bundle_loader()
    for fname, var in tdata.INPUTS:
        ours = load(fname, var)
        ref = jload(os.path.join(tdata.DATA, fname), var)
        assert ours.dims == ref.dims and list(ours.coords) == list(ref.coords)
        np.testing.assert_array_equal(ours.values, ref.values)
        for c in ref.coords:
            np.testing.assert_array_equal(ours.coords[c], ref.coords[c])
    with pytest.raises(FileNotFoundError, match="not in the bundle"):
        load("missing.nc", "tos")


def test_f32_build_step_at_antimeridian_pairs_is_the_references(stored):
    """f32 against f64 builds of the stored ellipses: both packages agree
    to f32 rounding everywhere but at fitted points exactly 180 degrees
    of longitude apart, where the formula's +-pi step puts the two
    precisions on opposite sides, in the JAX package as in the port
    (``chip_smoke.py`` phase 25 builds its f64 oracle with those pairs
    from the f32 build)."""
    lat, lon = np.arange(-87.5, 90, 5.0), np.arange(-177.5, 180, 5.0)
    params = {n: stored[f"ellipse_{n}"] for n in FIELDS}
    fitted = params["Lx"].reshape(-1) > 0
    lons = np.tile(lon, lat.size)[fitted]
    step = np.abs(lons[:, None] - lons[None, :]) == 180.0
    mask = params["Lx"] < 0
    gaps = {}
    for name, build in (
            ("port", lambda p: twf.ellipse_covariance(
                params, lat, lon, p, "cpu").cov_ns.double().numpy()),
            ("jax", lambda p: np.asarray(jcov.EllipseCovarianceBuilder(
                *(np.ma.masked_where(mask, params[n]) for n in FIELDS),
                lat, lon, v=1.5, covariance_method="batched",
                batch_size=100_000, precision=twf.NP_DTYPES[p]).cov_ns,
                np.float64))):
        c32, c64 = build(torch.float32), build(torch.float64)
        gap = np.abs(c32 - c64) / np.abs(c64).max()
        gaps[name] = (gap[~step].max(), gap[step].max())
        assert gaps[name][0] <= 1e-6, (name, gaps[name])
        assert gaps[name][1] >= 1e-3, (name, gaps[name])
    np.testing.assert_allclose(gaps["port"][1], gaps["jax"][1], rtol=1e-2)
