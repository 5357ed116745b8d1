"""The full non-stationary 1-degree pipeline on the PyTorch port, on the
card: the twin of ``examples/nonstationary_1deg_pipeline.py``.

  1. synthetic training cube   -- exact stationary draws (spherical-
                                  harmonic sampler, exponential
                                  correlation, e-folding 1,000 km,
                                  nugget 0.05, l_max 256) on the grid,
                                  land cells NaN
  2. empirical correlation     -- ``EllipseBuilder`` (one product)
  3. ellipse MLE               -- every ocean cell's anisotropic Matern
                                  (nu = 1.5) fit, batched Nelder-Mead
  4. covariance assembly       -- Paciorek-Schervish through the ellipse
                                  kernel K2, over the ocean cells whose
                                  fit converged
  5. PSD repair                -- the randomized explained-variance clip
                                  (target 0.90), factored (``LowRankPSD``)
  6. kriging + 100 members     -- field, uncertainty, constraint mask and
                                  a two-stage ensemble off the factors

Where the JAX script takes a ``jax.random.key``, ``run`` takes one
``generator`` for every draw, or the normals themselves (``noise=``,
``draw=``); the numpy draws (seed 7: the observed cells and their noise)
are the script's.

Run: python examples/torch_nonstationary_1deg_pipeline.py [--small]
(on the card; ``--small`` is the 4-degree grid).
"""

import os
import sys
import time

import numpy as np
import torch

try:  # prefer the installed package; fall back to a repo checkout
    import glomargridding_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from glomargridding_tpu_torch.core.labeled import Coordinates
from glomargridding_tpu_torch.models.ellipse import (
    EllipseBuilder,
    EllipseCovarianceBuilder,
    EllipseModel,
)
from glomargridding_tpu_torch.models.lowrank import lowrank_ensemble_step
from glomargridding_tpu_torch.ops.covariance_tools import (
    explained_variance_clip_lowrank,
)
from glomargridding_tpu_torch.ops.sphere import SphericalHarmonicSampler
from glomargridding_tpu_torch.utils.device import resolve_device

DEG, SMALL_DEG = 1.0, 4.0  # the grid's spacing, and with --small
T_TRAIN = 60
N_OBS = 5000
N_MEMBERS = 100
EFF_RANGE_KM = 3000.0
EARTH_KM = 6371.0
NUGGET = 0.05
L_MAX = 256
OBS_NOISE = 0.3
OBS_ERROR = 0.09
FIT_MODEL = dict(anisotropic=True, rotated=True, physical_distance=True,
                 v=1.5, unit_sigma=True)
FIT_KW = dict(
    default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
    max_distance=6000.0,
    guesses=[2000.0, 2000.0, 0.0],
    bounds=[(300.0, 30000.0), (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi)],
    tol=1e-3,
    chunk_size=2048,
    dispatch_chunks=4,  # accepted and inert: the port has no scan
    # each fit's training correlations cut to its 4,096 nearest
    # in-window points
    max_train_cols=4096,
)
CLIP_TARGET = 0.90
PAD_RANK = 256


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def axes(small=False):
    """(lats, lons): the grid's axes, float32 degrees (SMALL_DEG apart
    with `small`, else DEG)."""
    deg = SMALL_DEG if small else DEG
    return (np.arange(-90 + deg / 2, 90, deg, dtype=np.float32),
            np.arange(-180 + deg / 2, 180, deg, dtype=np.float32))


def ocean_mask(lats, lons):
    """Synthetic continents: a smooth deterministic ~35% land mask, and
    polar ice beyond 78 degrees (True = masked)."""
    LA, LO = np.meshgrid(np.radians(lats), np.radians(lons), indexing="ij")
    f = (np.sin(2.0 * LO + 1.0) * np.cos(LA) + 0.7 * np.sin(3.0 * LA + 0.5)
         + 0.4 * np.cos(5.0 * LO - 2.0 * LA))
    return (f > 0.55) | (np.abs(LA) > np.radians(78.0))


def training_sampler(lats, lons, dtype=torch.float32, device=None):
    """The exact stationary sampler of the training field and the truth."""
    r = EFF_RANGE_KM / 3.0 / EARTH_KM  # e-folding central angle
    return SphericalHarmonicSampler(
        lambda ang: np.exp(-ang / r), 1.0, lats, lons, nugget=NUGGET,
        l_max=L_MAX, dtype=dtype, device=resolve_device(device))


def training_cube(sampler, mask, generator=None, noise=None):
    """The (T_TRAIN, n_lat, n_lon) cube on the sampler's device, land
    cells NaN."""
    cube = sampler.draw(T_TRAIN, generator=generator, noise=noise).reshape(
        T_TRAIN, sampler.n_lat, sampler.n_lon)
    land = torch.as_tensor(mask, device=cube.device)
    return torch.where(land[None], torch.nan, cube)


def correlation(cube, lats, lons):
    """The ``EllipseBuilder`` of the cube (its empirical correlation)."""
    coords = Coordinates({"time": np.arange(T_TRAIN), "latitude": lats,
                          "longitude": lons})
    return EllipseBuilder(cube, coords)


def fit_ellipses(builder):
    """The ellipse parameters of every cell (a ``Dataset``)."""
    return builder.compute_params(matern_ellipse=EllipseModel(**FIT_MODEL),
                                  **FIT_KW)


def fit_mask(params, mask):
    """(cells left out of the covariance, converged fits): land, and the
    ocean cells whose fit failed (Lx <= 0 or QC 9)."""
    Lx = np.asarray(params["Lx"].values)
    good = (Lx > 0) & (np.asarray(params["qc_code"].values) != 9)
    return mask | ~good, good


def assembly(params, left_out, lats, lons, device=None):
    """The (n, n) Paciorek-Schervish covariance of the kept cells, by K2
    on the card."""
    def masked(name):
        return np.ma.masked_where(left_out, np.asarray(params[name].values))

    return EllipseCovarianceBuilder(
        masked("Lx"), masked("Ly"), masked("theta"),
        masked("standard_deviation"), lats, lons, v=1.5,
        device=resolve_device(device)).cov_ns


def psd_repair(cov, small=False, generator=None, draw=None):
    """(factors padded to PAD_RANK, the clip's own rank, the trace's
    relative change)."""
    psd = explained_variance_clip_lowrank(
        cov, target_variance_fraction=CLIP_TARGET, generator=generator,
        draw=draw, k0=512 if small else 1024,
        max_rank=1536 if small else 4096, rank_multiple=128)
    trace = float(torch.trace(cov.double()))
    return psd.pad_rank(PAD_RANK), psd.rank, abs(psd.trace() - trace) / trace


def observations(sampler, left_out, n, generator=None, noise=None,
                 dtype=torch.float32):
    """(idx, truth, y, E): min(N_OBS, n / 2) cells (numpy seed 7), a
    truth drawn by the sampler on the kept cells, its observations with
    OBS_NOISE and the diagonal error variance, on the sampler's
    device."""
    rng = np.random.default_rng(7)
    n_obs = min(N_OBS, n // 2)
    idx = np.sort(rng.choice(n, n_obs, replace=False))
    device = sampler.device
    keep = ~torch.as_tensor(left_out, device=device).flatten()
    truth = sampler.draw(1, generator=generator, noise=noise)[0][keep]
    truth = truth.to(dtype)
    idx_t = torch.as_tensor(idx, device=device)
    y = truth[idx_t] + torch.as_tensor(
        OBS_NOISE * rng.normal(size=n_obs).astype(np.float32),
        device=device).to(dtype)
    E = torch.full((n_obs,), OBS_ERROR, dtype=dtype, device=device)
    return idx_t, truth, y, E


def ensemble(psd, idx, y, E, generator=None, noise=None):
    """(kriging result, (N_MEMBERS, n) members) off the factors."""
    return lowrank_ensemble_step(psd, idx, y, E, generator, N_MEMBERS,
                                 noise=noise)


def consistency(res, members, truth):
    """Field RMSE against the truth, mean member spread and mean kriging
    uncertainty (the script's three numbers)."""
    return {
        "rmse": float(torch.sqrt(torch.mean((res.field - truth) ** 2))),
        "spread": float((members - res.field).std(dim=0, correction=0)
                        .mean()),
        "uncertainty": float(res.uncertainty.mean()),
    }


def run(small=False, device=None, dtype=torch.float32, generator=None,
        noise=None, draw=None, params=None, verbose=True):
    """The pipeline; returns its stage outputs and per-stage seconds
    (``times``).

    `dtype` is the training cube's and the fit's; the covariance, its
    repair and the ensemble are float32, as in the script. Every draw
    comes from `generator` (a generator on the device, seeded 0 when
    omitted), in order: the cube, the clip's start blocks, the truth,
    the ensemble; or from ``noise``, a dict of ``cube`` and ``truth``
    (the sampler's normals) and ``members`` (z1, z2, zo), and ``draw``,
    the clip's start blocks (``ops.eigsh``). ``params`` (the fit's
    ``Dataset``) skips the cube's correlation and the fit.
    """
    device = resolve_device(device)
    noise = {} if noise is None else noise
    if generator is None and (draw is None or len(noise) < 3):
        generator = torch.Generator(device=device).manual_seed(0)
    times: dict = {}
    out: dict = {"times": times}
    t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        _sync(device)
        times[name] = time.perf_counter() - t0
        if verbose:
            print(f"[{name:<34s}] {times[name]:7.2f}s", flush=True)
        t0 = time.perf_counter()

    lats, lons = axes(small)
    mask = ocean_mask(lats, lons)
    out["n_ocean"] = int((~mask).sum())
    if verbose:
        print(f"grid {lats.size}x{lons.size} "
              f"({SMALL_DEG if small else DEG} deg), {out['n_ocean']} ocean "
              f"points, device={device}")
    sampler = training_sampler(lats, lons, dtype, device)
    out["cube"] = training_cube(sampler, mask, generator, noise.get("cube"))
    stage(f"training cube ({T_TRAIN} states, on device)")
    if params is None:
        builder = correlation(out["cube"], lats, lons)
        stage("empirical cov/cor (calc_cov)")
        params = fit_ellipses(builder)
        del builder
    out["params"] = params
    left_out, good = fit_mask(params, mask)
    out["n_fit"] = int(good.sum())
    stage(f"ellipse MLE ({out['n_fit']} converged fits)")

    cov = assembly(params, left_out, lats, lons, device)
    n = cov.shape[0]
    stage(f"PS covariance assembly ({n} pts)")
    psd, out["true_rank"], out["trace_rel"] = psd_repair(cov, small,
                                                         generator, draw)
    del cov
    out["psd"] = psd
    stage(f"low-rank clip (rank {out['true_rank']}->{psd.rank})")
    if verbose:
        print(f"    trace preserved to {out['trace_rel']:.2e}")

    idx, truth, y, E = observations(sampler, left_out, n, generator,
                                    noise.get("truth"))
    out.update(idx=idx, truth=truth, y=y, E=E)
    stage("  (truth draw + obs prep)")
    res, members = ensemble(psd, idx, y, E, generator, noise.get("members"))
    stage(f"kriging + {N_MEMBERS} members")
    out.update(result=res, members=members,
               **consistency(res, members, truth))
    if verbose:
        print(f"    field RMSE vs truth {out['rmse']:.3f}, mean member "
              f"spread {out['spread']:.3f}, mean kriging uncertainty "
              f"{out['uncertainty']:.3f}")
    return out


def main():
    run(small="--small" in sys.argv)


if __name__ == "__main__":
    main()
