"""A 100-member stochastic ensemble at 1 degree (m = 64,800) on the
PyTorch port, on the card: the twin of ``examples/large_ensemble_65k.py``.

- Simulated states are drawn exactly in the spectral domain by the
  spherical-harmonic sampler (Matern nu = 0.5, range 1,200 km, variance
  1.2, nugget 0.012): no covariance matrix, no factorisation.
- The two-stage perturbation krige the observations and each member's
  simulated observations (state + observation noise) back onto the grid
  in 16 column blocks: one Cholesky of the (5,000 x 5,000) observation
  system, solves in true f32.
- Every covariance tile, the observation system's and each block's, is
  built by the stationary kernel K1 (``ops.cuda.pairwise``).

The covariance of the JAX script's ``kernel_block`` is
``1.2 exp(-d / 1200)`` with a full arcsin in the haversine, plus the
nugget where two points coincide. K1 builds ``variance - gamma(d)``; with
the Matern nu = 0.5 variogram of psill 1.2, no nugget and variance 1.2
that is ``1.2 exp(-d / 1200)``, its haversine through the polynomial
arcsin of the kriging path (``ops.distances.asin_poly``: 2e-8 absolute
on the angle, so at most ~2.5e-4 km on a distance). The observations
sit on distinct grid cells, so the pairs that coincide are exactly
(i, idx[i]), and the nugget is added there (``NUGGET_TOL`` states what
the polynomial arcsin costs against the full one).

Where the JAX script takes a ``jax.random.key``, ``run`` takes one
``generator`` or the normals themselves (``noise=``).

Run: python examples/torch_large_ensemble_65k.py  (on the card).
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

from glomargridding_tpu_torch.ops.cuda.pairwise import pairwise_covariance
from glomargridding_tpu_torch.ops.sphere import (
    SphericalHarmonicSampler,
    matern_correlation,
)
from glomargridding_tpu_torch.ops.variogram import MaternVariogram
from glomargridding_tpu_torch.utils.device import resolve_device

M_LAT, M_LON = 180, 360
N_OBS = 5000
N_MEMBERS = 100
N_BLOCKS = 16
PSILL = 1.2
NUGGET = 0.012  # spectral floor for the sqrt expansion
RANGE_KM = 1200.0
# K1's variogram: variance - gamma(d) = PSILL exp(-d / RANGE_KM)
VARIOGRAM = MaternVariogram(psill=PSILL, nugget=0.0, range=RANGE_KM, nu=0.5)
# K1's tile against kernel_block's full-arcsin form, relative to PSILL:
# the polynomial arcsin's 2e-8 on the angle, and f32 rounding
NUGGET_TOL = {torch.float64: 1e-6, torch.float32: 1e-5}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grid():
    """(lat, lon): the axes, float32 degrees."""
    lat = np.arange(-89.5, 90.0, 180.0 / M_LAT, dtype=np.float32)
    lon = np.arange(-179.5, 180.0, 360.0 / M_LON, dtype=np.float32)
    return lat, lon


def cells(lat, lon, dtype=torch.float32, device=None):
    """(la, lo): the flattened cells in radians on the device."""
    device = resolve_device(device)
    la = torch.deg2rad(torch.as_tensor(np.repeat(lat, lon.size),
                                       device=device))
    lo = torch.deg2rad(torch.as_tensor(np.tile(lon, lat.size),
                                       device=device))
    return la.to(dtype), lo.to(dtype)


def observations(m):
    """(idx, y, err_diag) of the script (numpy seed 0)."""
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(m, N_OBS, replace=False)).astype(np.int64)
    y = rng.normal(size=N_OBS).astype(np.float32)
    err_diag = (0.1 + 0.05 * rng.random(N_OBS)).astype(np.float32)
    return idx, y, err_diag


def state_sampler(lat, lon, dtype=torch.float32, device=None):
    """The exact spherical-harmonic sampler of the states."""
    return SphericalHarmonicSampler(
        matern_correlation(nu=0.5, range_km=RANGE_KM), variance=PSILL,
        lats_deg=lat, lons_deg=lon, nugget=NUGGET, dtype=dtype,
        device=device)


def draw_noise(sampler, generator):
    """The normals of one ensemble, drawn in float64 from `generator` so
    that a float32 and a float64 run see the same values: ``states`` (cos,
    sin, nugget normals of N_MEMBERS draws) and ``obs`` (N_OBS,
    N_MEMBERS)."""
    L1, m = sampler.l_max + 1, sampler.n_lat * sampler.n_lon
    shapes = [(N_MEMBERS, L1, L1)] * 2 + [(N_MEMBERS, m)]

    def z(s):
        return torch.randn(s, generator=generator, dtype=torch.float64,
                           device=sampler.device)

    return {"states": [z(s) for s in shapes], "obs": z((N_OBS, N_MEMBERS))}


def covariance_block(la1, lo1, la2, lo2):
    """``PSILL exp(-d / RANGE_KM)`` between two point sets, by K1 on the
    card."""
    return pairwise_covariance(la1, lo1, la2, lo2, VARIOGRAM, "haversine",
                               variance=PSILL)


def kernel_block(la1, lo1, la2, lo2, coincide):
    """The script's ``kernel_block``: K1's tile plus NUGGET at the pairs
    `coincide` (a (rows, cols) index pair)."""
    C = covariance_block(la1, lo1, la2, lo2)
    C[coincide] += NUGGET
    return C


def krige_and_perturb(la, lo, idx, y, err_diag, states, obs_normals):
    """(field, members): ordinary kriging of `y` and the two-stage
    perturbation of the (m, N_MEMBERS) states, in the states' dtype."""
    dtype, device = states.dtype, states.device
    m = la.shape[0]
    idx_t = torch.as_tensor(idx, device=device)
    y = torch.as_tensor(y, device=device).to(dtype)
    err = torch.as_tensor(err_diag, device=device).to(dtype)
    la_o, lo_o = la[idx_t], lo[idx_t]
    rows = torch.arange(idx_t.numel(), device=device)
    K = kernel_block(la_o, lo_o, la_o, lo_o, (rows, rows))
    K.diagonal().add_(err)
    L = torch.linalg.cholesky(K)
    del K
    u = torch.cholesky_solve(torch.ones((idx_t.numel(), 1), dtype=dtype,
                                        device=device), L)[:, 0]
    s = torch.sum(u)
    uy = u @ y
    obs_normals = torch.as_tensor(obs_normals, device=device).to(dtype)
    sim_obs = states[idx_t, :] + obs_normals * torch.sqrt(err)[:, None]
    width = -(-m // N_BLOCKS)
    field = torch.empty(m, dtype=dtype, device=device)
    sim_grid = torch.empty((m, states.shape[1]), dtype=dtype, device=device)
    for b0 in range(0, m, width):
        b1 = min(b0 + width, m)
        inside = (idx_t >= b0) & (idx_t < b1)
        Cc = kernel_block(la_o, lo_o, la[b0:b1], lo[b0:b1],
                          (rows[inside], idx_t[inside] - b0))
        V = torch.cholesky_solve(Cc, L)
        lam = (torch.sum(V, dim=0) - 1.0) / s
        field[b0:b1] = V.T @ y - lam * uy
        sim_grid[b0:b1] = V.T @ sim_obs
    members = field[:, None] + (sim_grid - states)
    return field, members.T


def ensemble(sampler, la, lo, idx, y, err_diag, noise):
    """(field, (N_MEMBERS, m) members, seconds of the draws, seconds of
    the kriging) of one ensemble on the normals `noise`."""
    device = sampler.device
    _sync(device)
    t = time.perf_counter()
    states = sampler.draw(N_MEMBERS, noise=noise["states"]).T
    _sync(device)
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    field, members = krige_and_perturb(la.to(states.dtype),
                                       lo.to(states.dtype), idx, y,
                                       err_diag, states, noise["obs"])
    _sync(device)
    return field, members, draw_s, time.perf_counter() - t


def run(device=None, dtype=torch.float32, generator=None, noise=None,
        verbose=True):
    """The script; returns the field, the members, the sampler's facts and
    the walls (``times``). The normals come from `generator` (a generator
    on the device, seeded 0 when omitted; ``draw_noise``) or are given as
    ``noise`` (``draw_noise``'s dict); the cold and the warm ensemble use
    the same normals, as the script's two calls use one key."""
    device = resolve_device(device)
    lat, lon = grid()
    la, lo = cells(lat, lon, dtype, device)
    m = la.shape[0]
    idx, y, err_diag = observations(m)
    times: dict = {}
    t0 = time.perf_counter()
    sampler = state_sampler(lat, lon, dtype, device)
    _sync(device)
    times["sampler"] = time.perf_counter() - t0
    if verbose:
        print(f"SH sampler ready in {times['sampler']:.1f}s (l_max "
              f"{sampler.l_max}, retained variance "
              f"{sampler.truncation_fraction:.4f})")
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        noise = draw_noise(sampler, generator)
    out = {"sampler": sampler, "times": times, "idx": idx}
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        field, members, draw_s, krige_s = ensemble(
            sampler, la, lo, idx, y, err_diag, noise)
        times[label] = time.perf_counter() - t0
        times[f"{label}_draws"], times[f"{label}_krige"] = draw_s, krige_s
        if verbose:
            print(f"  SH state draws x{N_MEMBERS}: {draw_s:.2f}s")
            print(f"  krige + perturb: {krige_s:.2f}s")
            print(f"{label}: {times[label]:.2f}s")
    out.update(field=field, members=members,
               draws_per_s=N_MEMBERS / times["warm"])
    members_np = members[:, :2000].double().cpu().numpy()
    field_np = field[:2000].double().cpu().numpy()
    spread = members_np.std(axis=0)
    out["spread_mean"], out["spread_max"] = spread.mean(), spread.max()
    out["mean_deviation"] = np.abs(members_np.mean(0) - field_np).mean()
    if verbose:
        print(f"warm: {times['warm']:.2f}s for {N_MEMBERS} members at "
              f"M={m} ({out['draws_per_s']:.1f} draws/s)")
        print("member spread (first 2k cells): "
              f"mean {out['spread_mean']:.3f}, max {out['spread_max']:.3f}")
        print("ensemble-mean deviation from field:",
              f"{out['mean_deviation']:.4f}")
    if not np.isfinite(members_np).all():
        raise AssertionError("non-finite members")
    return out


if __name__ == "__main__":
    run()
