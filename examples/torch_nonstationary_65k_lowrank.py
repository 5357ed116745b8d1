"""The 1-degree (n = 64,800) non-stationary covariance -> PSD repair ->
ensemble on the PyTorch port, on the card, with no f32 n x n matrix: the
twin of ``examples/nonstationary_65k_lowrank.py``.

  1. ``ellipse_covariance_operator(store="bf16")`` builds the covariance
     without its diagonal once, through the ellipse kernel K2, into a bf16
     store (8.4 GB); the exact diagonal stays f32, and each application
     multiplies with f32 accumulation;
  2. ``explained_variance_clip_lowrank`` (target 0.90) repairs it from
     matvecs alone and returns the factored ``LowRankPSD``;
  3. the store is freed, and kriging and a 100-member two-stage ensemble
     run off the factors (5,000 observations, diagonal error 0.09), twice
     (the second is the warm wall).

The ellipse fields are smooth synthetic maps (tropics stretch zonally).
Where the JAX script takes a ``jax.random.key``, ``run`` takes one
``generator`` or the normals themselves (``noise=``, ``draw=``).

Run: python examples/torch_nonstationary_65k_lowrank.py  (on the card;
``GLOMAR_SAVE_OUTPUTS=<dir>`` stores the fields and a figure).
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

M_LAT, M_LON = 180, 360
N_OBS = 5000
N_MEMBERS = 100
OBS_NOISE = 0.3
OBS_ERROR = 0.09
CLIP_KW = dict(target_variance_fraction=0.90, k0=1024, max_rank=4096,
               n_iter=4, rank_multiple=128)
PAD_RANK = 256


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grid():
    """(glat, glon): the flattened cells, float32 degrees."""
    lat = np.arange(-89.5, 90.0, 180.0 / M_LAT, dtype=np.float32)
    lon = np.arange(-179.5, 180.0, 360.0 / M_LON, dtype=np.float32)
    return np.repeat(lat, M_LON), np.tile(lon, M_LAT)


def ellipse_fields(glat):
    """Smooth synthetic Lx, Ly, theta and stdev (float32)."""
    coslat = np.cos(np.radians(glat))
    return {
        "Lx": (2000.0 + 1500.0 * coslat**2).astype(np.float32),
        "Ly": (1500.0 + 600.0 * coslat).astype(np.float32),
        "theta": (0.3 * np.sin(np.radians(2.0 * glat))).astype(np.float32),
        "stdev": (0.6 + 0.5 * coslat).astype(np.float32),
    }


def bf16_operator(glat, glon, fields, device=None):
    """``(matvec, n, trace)`` of the bf16 store (nu = 1.5), built by K2."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    s00, s01, _, s11 = sigma_rot_flat(f32(fields["Lx"]), f32(fields["Ly"]),
                                      f32(fields["theta"]))
    sig = torch.stack([s00, s01, s11], dim=-1)
    sqd = torch.sqrt(s00 * s11 - s01 * s01)
    return ellipse_covariance_operator(
        torch.deg2rad(f32(glat)), torch.deg2rad(f32(glon)), sig, sqd,
        f32(fields["stdev"]), v=1.5, store="bf16", device=device)


def psd_repair(mv, n, trace, generator=None, draw=None, device=None):
    """(factors padded to PAD_RANK, the clip's own rank). The padding keeps
    the ensemble's shapes the same from month to month."""
    psd = explained_variance_clip_lowrank(mv, n=n, trace=trace,
                                          generator=generator, draw=draw,
                                          device=resolve_device(device),
                                          **CLIP_KW)
    return psd.pad_rank(PAD_RANK), psd.rank


def observations(psd, generator=None, noise=None):
    """(idx, truth, y, E): N_OBS cells (numpy seed 7), a truth drawn from
    the factors, its observations with OBS_NOISE and the (m,) diagonal
    error variance, on the factors' device."""
    rng = np.random.default_rng(7)
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
    uncertainty."""
    return {
        "rmse": float(torch.sqrt(torch.mean((res.field - truth) ** 2))),
        "spread": float((members - res.field).std(dim=0, correction=0)
                        .mean()),
        "uncertainty": float(res.uncertainty.mean()),
    }


def run(device=None, generator=None, noise=None, draw=None, verbose=True):
    """The pipeline; returns its stage outputs and per-stage seconds
    (``times``). Every draw comes from `generator` (a generator on the
    device, seeded 0 when omitted), in order: the clip's start blocks, the
    truth, two ensembles; or from ``noise``, a dict of ``truth`` (z1, z2),
    ``members`` and ``members_warm`` (z1, z2, zo each), and ``draw``, the
    clip's start blocks (``ops.eigsh``)."""
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
            print(f"[{name:<38s}] {times[name]:7.2f}s", flush=True)
        t0 = time.perf_counter()

    glat, glon = grid()
    n = glat.size
    if verbose:
        print(f"n = {n} grid cells, device={device}")
    fields = ellipse_fields(glat)
    mv, n_op, trace = bf16_operator(glat, glon, fields, device)
    mv(torch.ones((n_op,), device=device))
    stage("bf16 operator assembly")
    out["trace"] = trace

    psd, true_rank = psd_repair(mv, n_op, trace, generator, draw, device)
    out["psd"], out["true_rank"] = psd, true_rank
    stage(f"low-rank PSD repair (rank {true_rank}->{psd.rank})")
    out["trace_rel"] = abs(psd.trace() - trace) / trace
    if verbose:
        print(f"    trace preserved to {out['trace_rel']:.2e}")
    del mv  # frees the bf16 store before the ensemble

    idx, truth, y, E = observations(psd, generator, noise.get("truth"))
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
    return out


def save_outputs(out_dir, **arrays):
    """The kriged fields of the run and a figure of them."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "nonstationary_65k_fields_torch.npz"), **arrays)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lat = np.arange(-89.5, 90.0, 180.0 / M_LAT)
    lon = np.arange(-179.5, 180.0, 360.0 / M_LON)
    panels = [
        ("truth", "Model-drawn truth", "RdBu_r", True),
        ("field", "Kriged field (factored covariance)", "RdBu_r", True),
        ("uncertainty", "Kriging uncertainty", "Blues", False),
        ("member0", "Ensemble member 0", "RdBu_r", True),
    ]
    fig, axs = plt.subplots(2, 2, figsize=(11, 6), dpi=110)
    for ax, (key, title, cmap, centered) in zip(axs.ravel(), panels):
        f = arrays[key].reshape(M_LAT, M_LON)
        if centered:
            vmax = np.nanpercentile(np.abs(f), 99)
            kw = dict(vmin=-vmax, vmax=vmax)
        else:
            kw = dict(vmin=0.0)
        im = ax.pcolormesh(lon, lat, f, cmap=cmap, **kw)
        ax.set_title(title, fontsize=10, color="#333")
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.suptitle("1-degree full-globe non-stationary pipeline, n = 64,800 "
                 "(PyTorch port)", fontsize=11)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "nonstationary_65k_torch.png"))
    print(f"outputs stored in {out_dir}")


def main():
    out = run()
    out_dir = os.environ.get("GLOMAR_SAVE_OUTPUTS")
    if out_dir:
        res = out["result"]
        save_outputs(
            out_dir,
            field=res.field.cpu().numpy().astype(np.float32),
            uncertainty=res.uncertainty.cpu().numpy().astype(np.float32),
            member0=out["members"][0].cpu().numpy().astype(np.float32),
            truth=out["truth"].cpu().numpy().astype(np.float32),
            clip_gains=out["psd"].gains.cpu().numpy().astype(np.float32),
        )


if __name__ == "__main__":
    main()
