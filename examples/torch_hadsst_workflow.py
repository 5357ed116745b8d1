"""End-to-end HadSST4 / HadCRUT5 workflow on the PyTorch port, on the
card: the twin of ``examples/hadsst_workflow.py``.

Pipeline:
  1. 5-degree global grid; stationary Matern(1.5) covariance from the
     grid distance matrix (on the device).
  2. Ellipse parameter MLE over the ESA-CCI SST anomaly training cube
     (one batched Nelder-Mead over every ocean point).
  3. Non-stationary covariance assembly (the ellipse kernel K2), the
     trace-preserving eigenvalue clip in float64 and re-inflation to the
     full grid.
  4. HadCRUT5 observation error covariance (correlated + uncorrelated).
  5. HadSST4 ensemble-member observations mapped to the grid.
  6. Leave-one-out scores of both covariances, ordinary kriging under
     both, and a stochastic (perturbed) member via StochasticKriging.

Every input is read from ``examples/data`` through the port's
``io.load_array`` (or any function with its signature: ``load=``).

Run: python examples/torch_hadsst_workflow.py  (on the card; prints
stage timings).
"""

import os
import sys

import numpy as np
import torch

try:  # prefer the installed package; fall back to a repo checkout
    import glomargridding_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from glomargridding_tpu_torch.core.labeled import Coordinates
from glomargridding_tpu_torch.grid import (
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)
from glomargridding_tpu_torch.io import load_array
from glomargridding_tpu_torch.models.ellipse import (
    EllipseBuilder,
    EllipseCovarianceBuilder,
    EllipseModel,
)
from glomargridding_tpu_torch.models.kernel_kriging import (
    crossval_from_covariance,
)
from glomargridding_tpu_torch.models.kriging import OrdinaryKriging
from glomargridding_tpu_torch.models.stochastic import StochasticKriging
from glomargridding_tpu_torch.ops.covariance_tools import eigenvalue_clip
from glomargridding_tpu_torch.ops.variogram import (
    MaternVariogram,
    variogram_to_covariance,
)
from glomargridding_tpu_torch.utils.device import resolve_device
from glomargridding_tpu_torch.utils.profiling import stage_timer

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MONTH, YEAR, MEMBER = 3, 2014, 71
N_CELLS = 36 * 72
ELLIPSE = dict(anisotropic=True, rotated=True, physical_distance=True,
               v=1.5, unit_sigma=True)
NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def global_grid():
    return grid_from_resolution(
        resolution=5,
        bounds=[(-87.5, 90), (-177.5, 180)],
        coord_names=["latitude", "longitude"],
    )


def stationary_covariance(grid, dtype, device):
    """Matern(1.5) covariance of the grid's distance matrix, on the
    device."""
    dist = grid_to_distance_matrix(
        grid, lat_coord="latitude", lon_coord="longitude", device=device
    )
    return variogram_to_covariance(
        MaternVariogram(
            range=1300, psill=1.2, nu=1.5, nugget=0.0, method="sklearn"
        ).fit(dist.values.to(dtype)),
        1.2,
    )


def training_cube(load, dtype, esa_lat_band=None):
    """(masked cube, lat, lon, coords) of the ESA-CCI March anomalies."""
    esa = load(
        f"{DATA}/esa_cci_sst_5deg_monthly_1982-2022_{MONTH:02d}.nc",
        "sst_anomaly",
    )
    esa_vals = np.ma.masked_greater(
        np.asarray(esa.values).astype(NP_DTYPES[dtype]), 1e5)
    lat = np.asarray(esa.coords["lat"])
    lon = np.asarray(esa.coords["lon"])
    if esa_lat_band is not None:
        keep = (lat >= esa_lat_band[0]) & (lat <= esa_lat_band[1])
        esa_vals = esa_vals[:, keep, :]
        lat = lat[keep]
    coords = Coordinates(
        {"time": np.asarray(esa.coords["time"]), "latitude": lat,
         "longitude": lon}
    )
    return esa_vals, lat, lon, coords


def fit_ellipses(esa_vals, coords, device, nm_tol=1e-3, chunk_size=2048,
                 v=ELLIPSE["v"]):
    """The ellipse parameter fields of every ocean point of the cube, of
    a Matern ellipse of order `v`."""
    builder = EllipseBuilder(esa_vals, coords, device=device)
    return builder.compute_params(
        default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
        matern_ellipse=EllipseModel(**{**ELLIPSE, "v": v}),
        max_distance=10_000.0,
        guesses=[2000.0, 2000.0, 0.0],
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        tol=nm_tol,
        chunk_size=chunk_size,
    )


def ellipse_covariance(fields, lat, lon, dtype, device):
    """The builder of K2's covariance of the fitted fields (``fields``:
    Lx, Ly, theta, standard_deviation on the (lat, lon) grid, Lx < 0 where
    unfitted), built in `dtype` over the fitted points (``cov_ns``)."""
    Lx = np.asarray(fields["Lx"])
    mask = Lx < 0
    return EllipseCovarianceBuilder(
        *(np.ma.masked_where(mask, np.asarray(fields[name]))
          for name in ("Lx", "Ly", "theta", "standard_deviation")),
        lat,
        lon,
        v=ELLIPSE["v"],
        precision=NP_DTYPES[dtype],
        covariance_method="batched",
        batch_size=100_000,
        device=device,
    )


def repaired_covariance(spatial_cov):
    """The builder's covariance repaired by the eigenvalue clip in float64
    and re-inflated to the full grid (float64 out)."""
    spatial_cov.cov_ns = eigenvalue_clip(
        spatial_cov.cov_ns.to(torch.float64)
    )
    spatial_cov.uncompress_cov(diag_fill_value=1.2, fill_value=0.0)
    return spatial_cov.cov_ns


def nonstationary_covariance(fields, lat, lon, dtype, device):
    """K2's covariance of the fitted fields built in `dtype`, repaired in
    float64 and re-inflated to the full grid (float64 out)."""
    return repaired_covariance(
        ellipse_covariance(fields, lat, lon, dtype, device))


def error_covariance(load, year=YEAR):
    """HadCRUT5's error covariance of the month plus its uncorrelated
    part, float64 on the host."""
    error_cov = np.asarray(
        load(
            f"{DATA}/HadCRUT.5.0.2.0.error_covariance."
            f"{year}_{MONTH:02d}.nc",
            "tas_cov",
        ).values
    )[0, ...].astype(np.float64)
    error_cov[error_cov > 1e6] = 0.0
    uncorr = np.asarray(
        load(
            f"{DATA}/HadCRUT.5.0.2.0.uncorrelated_{year}_{MONTH:02d}.nc",
            "tas_unc",
        ).values
    ).reshape((N_CELLS,)).astype(np.float64)
    uncorr[uncorr > 1e6] = 0.0
    return error_cov + np.diag(uncorr**2)


def member_observations(load, grid, year=YEAR, member=MEMBER):
    """(grid_idx, grid_obs) of a HadSST4 member, sorted by grid index."""
    tos = load(
        f"{DATA}/HadSST.4.0.1.0_ensemble_member_{member}_{year}_"
        f"{MONTH:02d}.nc",
        "tos",
    )
    frame = tos.to_dataframe(name="tos").dropna()
    frame = frame[frame["tos"] < 1e4]
    obs = map_to_grid(
        frame.reset_index(), grid, obs_coords=["latitude", "longitude"]
    )
    return obs["grid_idx"].to_numpy(), obs["tos"].to_numpy()


def krige(cov, grid_idx, grid_obs, error_cov):
    """(field, uncertainty, constraint mask) of ordinary kriging in the
    covariance's dtype."""
    ok = OrdinaryKriging(cov, idx=grid_idx, obs=grid_obs.astype(
        NP_DTYPES[cov.dtype]), error_cov=error_cov)
    return ok.solve(), ok.get_uncertainty(), ok.constraint_mask()


def perturbed_member(cov, grid_idx, grid_obs, error_cov, generator,
                     noise=None):
    """A stochastic member in the covariance's dtype; its normals are
    drawn in float64 from `generator` (so an f32 and an f64 run see the
    same draws) unless given as ``noise=(z_state, z_obs)``."""
    dtype = cov.dtype
    stok = StochasticKriging(cov, idx=grid_idx, obs=grid_obs.astype(
        NP_DTYPES[dtype]), error_cov=error_cov)
    n, m = cov.shape[0], stok.error_cov.shape[0]
    if noise is None:
        z = torch.randn(n + m, generator=generator, dtype=torch.float64,
                        device=cov.device)
        noise = (z[:n], z[n:])
    noise = tuple(torch.as_tensor(z, device=cov.device).to(dtype)
                  for z in noise)
    return stok.solve(noise=noise)


def run(esa_lat_band=None, nm_tol=1e-3, chunk_size=2048, device=None,
        generator=None, dtype=torch.float32, load=load_array, year=YEAR,
        member=MEMBER, ellipse_params=None, noise=None, verbose=True):
    """The workflow; returns its fields (tensors on the device), scores,
    ellipse parameters and per-stage seconds (``times``).

    `dtype` is that of the stationary covariance and its kriging, the
    training cube and the ellipse covariance's build; as in the JAX
    example, the clip runs in float64 and hands its float64 covariance to
    the non-stationary kriging, scores and member.

    `esa_lat_band` restricts the ellipse training to a latitude band
    (then no non-stationary stage runs). The stochastic member draws from
    `generator` (a generator on the device, seeded 0 when omitted) or
    replays ``noise``. ``ellipse_params`` (fields of Lx, Ly, theta and
    standard_deviation) skips the fit and uses those ellipses.
    """
    device = resolve_device(device)
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)
    times: dict = {}

    def done(name):
        if verbose:
            print(f"[{name}] {times[name]:.2f}s", flush=True)

    grid = global_grid()
    with stage_timer("stationary covariance", times) as h:
        cov_stat = h["out"] = stationary_covariance(grid, dtype, device)
    done("stationary covariance")

    esa_vals, lat, lon, coords = training_cube(load, dtype, esa_lat_band)
    if ellipse_params is None:
        with stage_timer("ellipse MLE fit", times) as h:
            ellipse_params = fit_ellipses(esa_vals, coords, device, nm_tol,
                                          chunk_size)
        done("ellipse MLE fit")
    fields = {name: np.asarray(ellipse_params[name])
              for name in ("Lx", "Ly", "theta", "standard_deviation")}

    cov_non_stat = None
    if esa_lat_band is None:
        with stage_timer("non-stationary covariance + clip", times) as h:
            cov_non_stat = h["out"] = nonstationary_covariance(
                fields, lat, lon, dtype, device)
        done("non-stationary covariance + clip")

    with stage_timer("error covariance", times):
        error_cov = error_covariance(load, year)
    done("error covariance")

    with stage_timer("obs mapping", times):
        grid_idx, grid_obs = member_observations(load, grid, year, member)
    done("obs mapping")

    covs = {"stat": cov_stat}
    if cov_non_stat is not None:
        covs["non_stat"] = cov_non_stat
    results = {"grid_idx": grid_idx, "grid_obs": grid_obs,
               "ellipse_params": ellipse_params, "times": times}
    with stage_timer("leave-one-out model scores", times) as h:
        for name, cov in covs.items():
            cv = crossval_from_covariance(cov, grid_idx, grid_obs.astype(
                NP_DTYPES[cov.dtype]), error_cov=error_cov)
            results[f"cv_{name}"] = h["out"] = cv
    done("leave-one-out model scores")
    if verbose:
        print("    model scores (LOO CV): " + " | ".join(
            f"{name} rmse {float(results[f'cv_{name}'].rmse):.3f} mssr "
            f"{float(results[f'cv_{name}'].mssr):.2f}" for name in covs))

    for name, cov in covs.items():
        label = ("stationary" if name == "stat" else "non-stationary")
        with stage_timer(f"ordinary kriging ({label})", times) as h:
            out = h["out"] = krige(cov, grid_idx, grid_obs, error_cov)
        results[f"anom_{name}"], results[f"uncert_{name}"], \
            results[f"mask_{name}"] = out
        done(f"ordinary kriging ({label})")

    if cov_non_stat is not None:
        with stage_timer("stochastic kriging (perturbed member)",
                         times) as h:
            results["perturbed_anom"] = h["out"] = perturbed_member(
                cov_non_stat, grid_idx, grid_obs, error_cov, generator,
                noise)
        done("stochastic kriging (perturbed member)")
    return results


if __name__ == "__main__":
    out = run()
    field = out["anom_stat"].cpu().numpy()
    print(
        "stationary field: "
        f"min {field.min():.2f} max {field.max():.2f} "
        f"rms {np.sqrt((field**2).mean()):.3f}"
    )
    if "perturbed_anom" in out:
        p = out["perturbed_anom"].cpu().numpy()
        print(f"perturbed member rms {np.sqrt((p**2).mean()):.3f}")
