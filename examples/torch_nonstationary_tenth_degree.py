"""The 0.1-degree (n = 6,480,000) non-stationary pipeline on the PyTorch
port, on the card: the twin of ``examples/nonstationary_tenth_degree.py``.

Zero-storage banded covariance operator -> reduced-rank matvec-only PSD
repair -> factored 100-member ensemble:

  1. heterogeneous ellipse parameter fields at 6,480,000 cells (rough
     maps from a dozen low-order harmonics, numpy seed 42, the JAX
     script's own);
  2. the 3,000 km-banded zero-storage stream operator: the latitude band
     plan is host-only (two ``searchsorted`` passes), a longitude
     certificate keeps the 64-point column chunks of each row block's
     window that can hold a pair within the cutoff, and every application
     builds each row block's tile against them with the ellipse kernel K4
     and multiplies it in true f32 (applications of at most 8 columns
     would take K3; none here is that narrow). A dense f32 covariance
     would be 168 TB;
  3. one W = 64 demonstration application, from numpy seed 11's normals;
  4. a REDUCED-RANK repair: the explained-variance clip (target 0.15)
     capped at rank ``GLOMAR_TENTH_RANK`` (default 88; k0 = max_rank =
     the cap, oversample 8, n_iter 2: 4 operator sweeps of 96 columns).
     The production 0.80-variance repair at this n needs rank ~3,000,
     (6,480,000 x 3,072) f32 blocks of 80 GB each: what the row-sharded
     eigensolver blocks of ``parallel.sharded_ellipse_stream_operator``
     divide over several cards;
  5. kriging and a 100-member two-stage ensemble off the factors (5,000
     observations, diagonal error 0.09), twice (the second is the warm
     wall).

Where the JAX script takes a ``jax.random.key``, ``run`` takes one
``generator`` for every draw, or the normals themselves (``noise=``,
``draw=``); the numpy draws (seed 11: the demonstration block, the
observed cells, the observation noise, in this order) are the script's.

Run: python examples/torch_nonstationary_tenth_degree.py [--small]
(on the card; ``--small`` is the 2-degree grid with 500 observations).
Env: GLOMAR_SAVE_OUTPUTS=<dir> stores the fields subsampled to 0.5
degree (``.npz``) and the stage walls; GLOMAR_TENTH_RANK=<k> sets the
repair's rank cap.
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

from glomargridding_tpu_torch.models.ellipse.covariance import (
    ellipse_covariance_operator,
)
from glomargridding_tpu_torch.models.lowrank import lowrank_ensemble_step
from glomargridding_tpu_torch.ops.covariance_tools import (
    explained_variance_clip_lowrank,
)
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat
from glomargridding_tpu_torch.utils.device import resolve_device

M_LAT, M_LON = 1800, 3600
N_OBS = 5000
N_MEMBERS = 100
DEMO_COLS = 64
MAX_DIST_KM = 3000.0
OBS_NOISE = 0.3
OBS_ERROR = 0.09
TARGET = 0.15
DEFAULT_RANK = "88"
# numpy rows drawn at a time for the demonstration block
DRAW_ROWS = 1 << 20


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grid():
    """(glat, glon): the flattened cells, float32 degrees."""
    lat = np.linspace(-89.95, 89.95, M_LAT).astype(np.float32)
    lon = np.linspace(-179.95, 179.95, M_LON).astype(np.float32)
    return np.repeat(lat, M_LON), np.tile(lon, M_LAT)


def heterogeneous_ellipse_fields(glat, glon, seed=42):
    """Rough spatially correlated ellipse fields (base scales ~900-1,800
    km with O(30%) log-variation), built on the host from a dozen
    low-order harmonics: (Lx, Ly, theta, stdev), float32."""
    rng = np.random.default_rng(seed)
    la, lo = np.radians(glat), np.radians(glon)

    def rough(scale):
        out = np.zeros_like(la)
        for _ in range(12):
            k1, k2 = rng.integers(1, 7, size=2)
            s1, s2 = rng.choice([-1.0, 1.0], size=2)
            out += rng.normal() * np.sin(
                s1 * k1 * la + s2 * k2 * lo + rng.uniform(0, 2 * np.pi)
            )
        return scale * out / np.sqrt(12.0)

    coslat = np.cos(la)
    Lx = (900.0 + 600.0 * coslat**2) * np.exp(rough(0.35))
    Ly = (600.0 + 300.0 * coslat) * np.exp(rough(0.35))
    theta = rough(0.4)
    stdev = (0.8 + 0.4 * coslat) * np.exp(rough(0.25))
    return tuple(a.astype(np.float32) for a in (Lx, Ly, theta, stdev))


def operator_inputs(glat, glon, fields, dtype=torch.float32, device=None):
    """(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) on the device, in
    `dtype` (the script's are float32)."""
    device = resolve_device(device)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    Lx, Ly, theta, stdev = fields
    s00, s01, _, s11 = sigma_rot_flat(on(Lx), on(Ly), on(theta))
    return (torch.deg2rad(on(glat)), torch.deg2rad(on(glon)),
            torch.stack([s00, s01, s11], dim=-1),
            torch.sqrt(s00 * s11 - s01 * s01), on(stdev))


def stream_operator(glat, glon, fields, n_blocks=None, dtype=torch.float32,
                    max_dist=MAX_DIST_KM, device=None):
    """``(matvec, n, trace)`` of the zero-storage covariance (nu = 1.5),
    banded at `max_dist` km, in the operator's row blocks unless
    `n_blocks` is given."""
    device = resolve_device(device)
    return ellipse_covariance_operator(
        *operator_inputs(glat, glon, fields, dtype, device), v=1.5,
        store="stream", max_dist=max_dist, n_blocks=n_blocks, device=device)


def demonstration_block(rng, n, device=None):
    """The (n, DEMO_COLS) float32 normals of the demonstration
    application, drawn from `rng` as the script draws them (in row
    chunks: the same values, a bounded host buffer)."""
    device = resolve_device(device)
    X = torch.empty((n, DEMO_COLS), dtype=torch.float32, device=device)
    for r0 in range(0, n, DRAW_ROWS):
        r1 = min(r0 + DRAW_ROWS, n)
        X[r0:r1] = torch.from_numpy(
            rng.normal(size=(r1 - r0, DEMO_COLS)).astype(np.float32))
    return X


def demonstration_application(mv, rng, n, device=None):
    """(X, C X): one W = DEMO_COLS application of the operator."""
    X = demonstration_block(rng, n, device)
    return X, mv(X)


def rank_cap():
    """``GLOMAR_TENTH_RANK`` (default 88)."""
    return int(os.environ.get("GLOMAR_TENTH_RANK", DEFAULT_RANK))


def psd_repair(mv, n, trace, generator=None, draw=None, dtype=None,
               device=None):
    """The rank-capped explained-variance clip of the operator (a
    ``LowRankPSD``): k0 = max_rank = the cap, oversample 8, n_iter 2."""
    k_cap = rank_cap()
    return explained_variance_clip_lowrank(
        mv, n=n, trace=trace, target_variance_fraction=TARGET,
        generator=generator, draw=draw, k0=k_cap, max_rank=k_cap,
        oversample=8, n_iter=2, rank_multiple=8, dtype=dtype,
        device=resolve_device(device))


def observations(psd, rng, generator=None, noise=None):
    """(idx, truth, y, E): N_OBS cells and the observation noise from
    `rng` (after the demonstration block), a truth drawn from the
    factors, and the diagonal error variance, beside the factors."""
    idx = np.sort(rng.choice(psd.n, N_OBS, replace=False))
    truth = psd.draw(1, generator=generator, noise=noise)[0]
    like = psd.vectors
    idx_t = torch.as_tensor(idx, device=like.device)
    y = truth[idx_t] + torch.as_tensor(
        OBS_NOISE * rng.normal(size=N_OBS).astype(np.float32),
        device=like.device).to(like.dtype)
    E = torch.full((N_OBS,), OBS_ERROR, dtype=like.dtype, device=like.device)
    return idx_t, truth, y, E


def ensemble(psd, idx, y, E, generator=None, noise=None):
    """(kriging result, (N_MEMBERS, n) members) off the factors."""
    return lowrank_ensemble_step(psd, idx, y, E, generator, N_MEMBERS,
                                 noise=noise)


def consistency(res, members, truth):
    """Field RMSE against the truth, member spread and mean kriging
    uncertainty (the script's three numbers)."""
    return {
        "rmse": float(torch.sqrt(torch.mean((res.field - truth) ** 2))),
        "spread": float((members - res.field).std(dim=0, correction=0)
                        .mean()),
        "uncertainty": float(res.uncertainty.mean()),
    }


def run(device=None, dtype=torch.float32, generator=None, noise=None,
        draw=None, n_blocks=None, verbose=True):
    """The pipeline; returns its stage outputs and per-stage seconds
    (``times``).

    The operator is float32, as in the script; `dtype` is the repair's
    (its blocks and factors) and so the ensemble's. Every draw comes
    from `generator` (a generator on the device, seeded 0 when omitted),
    in order: the clip's start blocks, the truth, two ensembles; or from
    ``noise``, a dict of ``truth`` (z1, z2), ``members`` and
    ``members_warm`` (z1, z2, zo each), and ``draw``, the clip's start
    blocks (``ops.eigsh``). `n_blocks` sets the stream's row blocks
    (default the operator's).
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
            print(f"[{name:<46s}] {times[name]:8.2f}s", flush=True)
        t0 = time.perf_counter()

    glat, glon = grid()
    n = glat.size
    if verbose:
        print(f"n = {n} grid cells, device={device}")
    out["fields"] = heterogeneous_ellipse_fields(glat, glon)
    stage(f"ellipse parameter fields ({n} cells)")
    mv, n_op, trace = stream_operator(glat, glon, out["fields"], n_blocks,
                                      device=device)
    out.update(trace=trace, band_stats=mv.band_stats)
    stage(f"banded stream operator (window {mv.band_stats['bw']}, "
          "0 bytes stored)")

    rng = np.random.default_rng(11)
    out["demo"] = demonstration_application(mv, rng, n, device)
    stage(f"W={DEMO_COLS} operator application")

    psd = psd_repair(mv, n_op, trace, generator, draw, dtype, device)
    out["psd"] = psd
    out["retained"] = float(psd.gains.sum()) / trace
    out["trace_rel"] = abs(psd.trace() - trace) / trace
    stage(f"matvec-only PSD repair (rank {psd.effective_rank})")
    if verbose:
        print(f"    retained top-spectrum variance {out['retained']:.3f} of "
              f"trace (cap rank {rank_cap()}); trace preserved to "
              f"{out['trace_rel']:.2e}")

    idx, truth, y, E = observations(psd, rng, generator, noise.get("truth"))
    out.update(idx=idx, truth=truth, y=y, E=E)
    res, members = ensemble(psd, idx, y, E, generator, noise.get("members"))
    stage(f"kriging + {N_MEMBERS} members")
    res, members = ensemble(psd, idx, y, E, generator,
                            noise.get("members_warm"))
    stage("kriging + members (warm)")
    out.update(result=res, members=members,
               **consistency(res, members, truth))
    if verbose:
        print(f"    field RMSE vs truth {out['rmse']:.3f}, member spread "
              f"{out['spread']:.3f}, mean kriging uncertainty "
              f"{out['uncertainty']:.3f}")
        print(f"  total: {sum(times.values()):.1f} s")
    return out


def save_outputs(out_dir, out):
    """The fields subsampled to every fifth row and column (0.5 degree on
    the full grid), the rank, the retained share, the scores and the
    stage walls."""
    os.makedirs(out_dir, exist_ok=True)

    def sub(t):
        return t.detach().cpu().numpy().astype(np.float32).reshape(
            M_LAT, M_LON)[::5, ::5]

    res = out["result"]
    path = os.path.join(out_dir, "nonstationary_6480k_torch.npz")
    np.savez_compressed(
        path, field=sub(res.field), uncertainty=sub(res.uncertainty),
        member0=sub(out["members"][0]), truth=sub(out["truth"]),
        walls=np.array(list(out["times"].items()), dtype=object),
        rank=out["psd"].effective_rank, retained_variance=out["retained"],
        rmse=out["rmse"], spread=out["spread"])
    print(f"  outputs -> {path}")


def main():
    global M_LAT, M_LON, N_OBS
    if "--small" in sys.argv:
        M_LAT, M_LON, N_OBS = 90, 180, 500
    out = run()
    out_dir = os.environ.get("GLOMAR_SAVE_OUTPUTS")
    if out_dir:
        save_outputs(out_dir, out)


if __name__ == "__main__":
    main()
