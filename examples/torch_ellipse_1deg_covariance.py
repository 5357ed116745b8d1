"""A 40,000-point non-stationary anisotropic (Paciorek-Schervish, nu =
0.5) covariance on the PyTorch port, on the card: the twin of
``examples/ellipse_1deg_covariance.py``.

The ellipse kernel K4 (``ops.cuda.ellipse.ellipse_covariance_cuda``)
builds all 40,000^2 entries (6.4 GB in f32) in one launch. The parameters
are smooth synthetic fields (latitude-dependent zonal stretching, like
fitted SST fields) at random ocean-like points. The script's own checks:
the diagonal is stdev^2 to 1e-4, a 512-point block is symmetric to 1e-6,
and its spectrum is printed.

Run: python examples/torch_ellipse_1deg_covariance.py  (on the card).
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

from glomargridding_tpu_torch.ops.cuda.ellipse import ellipse_covariance_cuda
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat
from glomargridding_tpu_torch.utils.device import resolve_device

N_POINTS = 40_000
NU = 0.5
DIAG_RTOL = 1e-4
SYMMETRY_TOL = 1e-6
BLOCK = 512


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def points():
    """(lats, lons, fields): the random points (numpy seed 0) and their
    smooth Lx, Ly, theta and stdev, float32."""
    rng = np.random.default_rng(0)
    lats = rng.uniform(-65.0, 65.0, N_POINTS).astype(np.float32)
    lons = rng.uniform(-180.0, 180.0, N_POINTS).astype(np.float32)
    coslat = np.cos(np.radians(lats))
    fields = {
        "Lx": (800.0 + 2200.0 * coslat**2).astype(np.float32),
        "Ly": (600.0 + 400.0 * coslat).astype(np.float32),
        "theta": (0.3 * np.sin(np.radians(2 * lats))).astype(np.float32),
        "stdev": (0.5 + 0.4 * coslat).astype(np.float32),
    }
    return lats, lons, fields


def kernel_inputs(lats, lons, fields, dtype=torch.float32, device=None):
    """(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) on the device."""
    device = resolve_device(device)

    def on(a):
        return torch.as_tensor(a, device=device).to(dtype)

    s00, s01, _, s11 = sigma_rot_flat(on(fields["Lx"]), on(fields["Ly"]),
                                      on(fields["theta"]))
    return (torch.deg2rad(on(lats)), torch.deg2rad(on(lons)),
            torch.stack([s00, s01, s11], dim=-1),
            torch.sqrt(s00 * s11 - s01 * s01), on(fields["stdev"]))


def build(inputs):
    """The (N_POINTS, N_POINTS) covariance by K4, with diag(stdev^2)."""
    return ellipse_covariance_cuda(*inputs, v=NU)


def check(diagonal, block, stdev):
    """The script's checks on the first 1,000 diagonal entries and the
    leading (BLOCK, BLOCK) block (float64 numpy); returns the block's
    eigenvalues."""
    np.testing.assert_allclose(diagonal, stdev[:diagonal.size] ** 2,
                               rtol=DIAG_RTOL)
    asym = np.abs(block - block.T).max()
    if not asym < SYMMETRY_TOL:
        raise AssertionError(f"block asymmetric by {asym:.3e}")
    return np.linalg.eigvalsh(block)


def run(device=None, dtype=torch.float32, verbose=True):
    """The script: a cold and a warm build, its checks; returns the warm
    covariance, the block's eigenvalues and the walls (``times``)."""
    device = resolve_device(device)
    lats, lons, fields = points()
    inputs = kernel_inputs(lats, lons, fields, dtype, device)
    times: dict = {}

    def timed(label):
        _sync(device)
        t0 = time.perf_counter()
        cov = build(inputs)
        _sync(device)
        times[label] = time.perf_counter() - t0
        return cov

    cov = timed("cold")
    if verbose:
        print(f"cold (build + run): {times['cold']:.2f}s")
    # keep only one 6.4 GB matrix alive at a time
    d = cov.diagonal()[:1000].cpu().numpy()
    blk = cov[:BLOCK, :BLOCK].double().cpu().numpy()
    del cov
    cov = timed("warm")
    n_pairs = N_POINTS * (N_POINTS - 1) // 2
    gpairs = n_pairs / times["warm"] / 1e9
    if verbose:
        print(f"warm: {times['warm']:.3f}s for {N_POINTS} points "
              f"({gpairs:.1f} Gpairs/s), "
              f"{cov.numel() * cov.element_size() / 2**30:.1f} GiB matrix")
    eigs = check(d, blk, fields["stdev"])
    if verbose:
        print(f"{BLOCK}-block spectrum: [{eigs.min():.2e}, {eigs.max():.2e}] "
              f"(min/max ratio {eigs.min() / eigs.max():.1e})")
    return {"cov": cov, "eigs": eigs, "gpairs_per_s": gpairs,
            "times": times, "inputs": inputs}


if __name__ == "__main__":
    run()
