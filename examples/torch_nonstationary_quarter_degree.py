"""The half-degree (n = 259,200) non-stationary pipeline on the PyTorch
port, on the card: the twin of ``examples/nonstationary_quarter_degree.py``.

Whole-grid MLE -> zero-storage covariance -> matvec-only PSD repair ->
factored 100-member ensemble:

  1. a 60-state training cube drawn exactly by the spherical-harmonic
     sampler (exponential correlation, e-folding 1,000 km, nugget 0.05,
     l_max 256);
  2. the empirical correlation stays LAZY (``EllipseBuilder(cor_mode=
     "auto")``: the dense matrix would be 269 GB in f32), and each fit
     chunk rebuilds its correlation rows from the (T, n) normalised
     samples, one (B, T) x (T, n) product;
  3. the ellipse MLE of every cell (batched Nelder-Mead, nu = 1.5, a
     6,000 km window cut to its 2,048 nearest points), resumable from a
     checkpoint (``GLOMAR_MLE_CHECKPOINT``); failed fits take the median
     ellipse;
  4. ``store="stream"``: the Paciorek-Schervish covariance is rebuilt
     from the fitted fields in every application, banded at
     ``GLOMAR_MAX_DIST_KM`` (default 3,000 km; empty or <= 0: no cutoff):
     applications of up to 8 columns run the fused kernel K3, wider ones
     K4 tiles and a true-f32 product;
  5. the randomized explained-variance clip (target 0.90) sees only
     matvecs and returns the covariance factored (``LowRankPSD``);
  6. kriging and a 100-member two-stage ensemble off the factors, from
     5,000 observations with a diagonal error of 0.09, twice (the second
     is the warm wall).

Where the JAX script takes a ``jax.random.key``, ``run`` takes one
``generator`` for every draw, or the normals themselves (``noise=``,
``draw=``). Stage functions are public so that each can be run alone.

Run: python examples/torch_nonstationary_quarter_degree.py  (on the card;
prints stage timings; ``GLOMAR_SAVE_OUTPUTS=<dir>`` stores the fields and
a figure).
"""

import os
import sys
import tempfile
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
    EllipseModel,
)
from glomargridding_tpu_torch.models.ellipse.covariance import (
    ellipse_covariance_operator,
)
from glomargridding_tpu_torch.models.lowrank import lowrank_ensemble_step
from glomargridding_tpu_torch.ops.covariance_tools import (
    explained_variance_clip_lowrank,
)
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat
from glomargridding_tpu_torch.ops.sphere import SphericalHarmonicSampler
from glomargridding_tpu_torch.utils.device import resolve_device

M_LAT, M_LON = 360, 720
T_TRAIN = 60
# e-folding ~1000 km: the retained rank of the 0.90-variance clip
# depends on the angular spectrum, not on the grid's resolution
TRAIN_RANGE_KM = 3000.0
EARTH_KM = 6371.0
L_MAX = 256
NUGGET = 0.05
N_OBS = 5000
N_MEMBERS = 100
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
    max_train_cols=2048,  # ~1,400 km window at this resolution
)
# lanes per fit chunk: the fastest of 1,024, 2,048 and 4,096 at 259,200
# cells on an NVIDIA H100 80GB HBM3, 700 W (chip_smoke.py phase 29,
# chunk_ms_per_lane: 1.91, 1.16 and 0.97 ms a lane on an equatorial and
# a polar chunk); its build takes 34 GB, and compute_params cuts it to
# what the device's free memory allows. A lane's answer does not depend
# on it.
CHUNK_SIZE = 4096
CLIP_KW = dict(target_variance_fraction=0.90, k0=1024, max_rank=2048,
               n_iter=3, rank_multiple=128)
PAD_RANK = 256
DEFAULT_MAX_DIST_KM = "3000"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def axes():
    """(lat, lon, glat, glon): the grid's axes and its flattened cells,
    float32 degrees."""
    lat = np.linspace(-89.75, 89.75, M_LAT).astype(np.float32)
    lon = np.linspace(-179.75, 179.75, M_LON).astype(np.float32)
    return lat, lon, np.repeat(lat, M_LON), np.tile(lon, M_LAT)


def training_sampler(lat, lon, dtype=torch.float32, device=None):
    """The exact stationary sampler of the training field."""
    r = TRAIN_RANGE_KM / 3.0 / EARTH_KM
    return SphericalHarmonicSampler(
        lambda ang: np.exp(-ang / r), 1.0, lat, lon, nugget=NUGGET,
        l_max=L_MAX, dtype=dtype, device=device)


def cube_noise(sampler, generator):
    """The normals of the cube's T_TRAIN draws (cos and sin coefficients,
    nugget), drawn in float64 from `generator` so that a float32 and a
    float64 cube see the same values."""
    L1, m = sampler.l_max + 1, sampler.n_lat * sampler.n_lon
    shapes = [(T_TRAIN, L1, L1)] * 2 + [(T_TRAIN, m)]
    return [torch.randn(s, generator=generator, dtype=torch.float64,
                        device=sampler.device) for s in shapes]


def training_cube(sampler, noise):
    """The (T_TRAIN, M_LAT, M_LON) cube, on the sampler's device."""
    return sampler.draw(T_TRAIN, noise=noise).reshape(T_TRAIN, M_LAT, M_LON)


def correlation(cube, lat, lon):
    """The ``EllipseBuilder`` of the cube; above the size its device can
    hold densely (``cor_mode="auto"``) its correlation is lazy."""
    coords = Coordinates(
        {"time": np.arange(T_TRAIN), "latitude": lat, "longitude": lon})
    return EllipseBuilder(cube, coords)


def checkpoint_path():
    """``GLOMAR_MLE_CHECKPOINT``, else a file in the temporary directory."""
    return os.environ.get(
        "GLOMAR_MLE_CHECKPOINT",
        os.path.join(tempfile.gettempdir(), "glomar_quarter_deg_mle.npz"))


def fit_ellipses(builder, checkpoint=None):
    """The ellipse parameter fields of every cell (a ``Dataset``), by
    batched Nelder-Mead, CHUNK_SIZE lanes at a time."""
    return builder.compute_params(
        matern_ellipse=EllipseModel(**FIT_MODEL), chunk_size=CHUNK_SIZE,
        checkpoint=checkpoint, **FIT_KW)


def fitted_fields(params):
    """(fields, n_fit): Lx, Ly, theta and standard_deviation as flat
    float32 arrays, every failed fit (Lx < 0 or QC 9) set to the median
    of the converged ones, so that the operator keeps every cell."""
    def flat(name):
        return np.asarray(getattr(params[name], "values", params[name]))

    fields = {name: flat(name).ravel().astype(np.float32)
              for name in ("Lx", "Ly", "theta", "standard_deviation")}
    qc = flat("qc_code").ravel()
    good = (fields["Lx"] > 0) & (qc != 9)
    n_fit = int(good.sum())
    if n_fit < good.size:
        for arr in fields.values():
            arr[~good] = np.median(arr[good])
    return fields, n_fit


def max_dist_km():
    """The stream's cutoff from ``GLOMAR_MAX_DIST_KM`` (default 3,000 km):
    empty or <= 0 means no cutoff (a literal 0 km would zero every
    off-diagonal entry)."""
    md_env = os.environ.get("GLOMAR_MAX_DIST_KM", DEFAULT_MAX_DIST_KM)
    max_dist = float(md_env) if md_env else None
    if max_dist is not None and max_dist <= 0.0:
        max_dist = None
    return max_dist


def stream_inputs(glat, glon, fields, dtype=torch.float32, device=None):
    """(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) of the fitted
    fields on the device, in `dtype` (the operator's are float32)."""
    device = resolve_device(device)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    s00, s01, _, s11 = sigma_rot_flat(on(fields["Lx"]), on(fields["Ly"]),
                                      on(fields["theta"]))
    return (torch.deg2rad(on(glat)), torch.deg2rad(on(glon)),
            torch.stack([s00, s01, s11], dim=-1),
            torch.sqrt(s00 * s11 - s01 * s01),
            on(fields["standard_deviation"]))


def stream_operator(glat, glon, fields, max_dist, device=None):
    """``(matvec, n, trace)`` of the zero-storage covariance of the fitted
    fields (nu = 1.5), banded at `max_dist` km."""
    device = resolve_device(device)
    return ellipse_covariance_operator(
        *stream_inputs(glat, glon, fields, device=device), v=1.5,
        store="stream", max_dist=max_dist, device=device)


def psd_repair(mv, n, trace, generator=None, draw=None, device=None):
    """(factors padded to PAD_RANK, the clip's own rank)."""
    psd = explained_variance_clip_lowrank(mv, n=n, trace=trace,
                                          generator=generator, draw=draw,
                                          device=resolve_device(device),
                                          **CLIP_KW)
    return psd.pad_rank(PAD_RANK), psd.rank


def observations(psd, generator=None, noise=None):
    """(idx, truth, y, E): N_OBS cells (numpy seed 7), a truth drawn from
    the factors, its observations with OBS_NOISE and the diagonal error
    variance, on the factors' device."""
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
    uncertainty (the example's three numbers)."""
    return {
        "rmse": float(torch.sqrt(torch.mean((res.field - truth) ** 2))),
        "spread": float((members - res.field).std(dim=0, correction=0)
                        .mean()),
        "uncertainty": float(res.uncertainty.mean()),
    }


def run(device=None, dtype=torch.float32, generator=None, noise=None,
        draw=None, checkpoint=None, ellipse_params=None, verbose=True):
    """The pipeline; returns its stage outputs and per-stage seconds
    (``times``).

    `dtype` is that of the training cube and the fit; as in the JAX
    example, the fitted fields go on in float32 (operator, clip,
    ensemble). Every draw comes from `generator` (a generator on the
    device, seeded 0 when omitted), in order: the cube's normals (float64),
    the clip's start blocks, the truth, two ensembles; or from ``noise``,
    a dict of ``cube`` (cos, sin, nugget), ``truth`` (z1, z2),
    ``members`` and ``members_warm`` (z1, z2, zo each), and ``draw``, the
    clip's start blocks (``ops.eigsh``). `checkpoint` defaults to
    ``checkpoint_path()``. ``ellipse_params`` (a Dataset or dict of Lx,
    Ly, theta, standard_deviation and qc_code) skips the cube and the fit.
    """
    device = resolve_device(device)
    noise = {} if noise is None else noise
    if generator is None and len(noise) < 4:
        generator = torch.Generator(device=device).manual_seed(0)
    if checkpoint is None:
        checkpoint = checkpoint_path()
    times: dict = {}
    out: dict = {"times": times}
    t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        _sync(device)
        times[name] = time.perf_counter() - t0
        if verbose:
            print(f"[{name:<44s}] {times[name]:7.2f}s", flush=True)
        t0 = time.perf_counter()

    lat, lon, glat, glon = axes()
    n = glat.size
    if verbose:
        print(f"n = {n} grid cells, device={device}")
    if ellipse_params is None:
        sampler = training_sampler(lat, lon, dtype, device)
        stage("sampler build")
        cube_z = noise.get("cube")
        if cube_z is None:
            cube_z = cube_noise(sampler, generator)
        out["cube"] = training_cube(sampler, cube_z)
        stage(f"training cube ({T_TRAIN} states, on device)")
        builder = correlation(out["cube"], lat, lon)
        out["lazy"] = not isinstance(builder.cor, torch.Tensor)
        float(builder.cor[0, 0])
        stage("lazy empirical correlation (row build)" if out["lazy"]
              else "dense empirical correlation")
        ellipse_params = fit_ellipses(builder, checkpoint)
        del builder
        stage("whole-grid MLE")
    out["params"] = ellipse_params
    fields, n_fit = fitted_fields(ellipse_params)
    out["fields"], out["n_fit"] = fields, n_fit
    if verbose:
        print(f"    {n_fit} converged fits"
              + (f", {n - n_fit} failed -> median-ellipse fallback"
                 if n_fit < n else ""))

    max_dist = max_dist_km()
    mv, n_op, trace = stream_operator(glat, glon, fields, max_dist, device)
    mv(torch.ones((n_op,), device=device))
    stage(f"stream operator (banded at {max_dist} km, 0 bytes)"
          if max_dist else "stream operator (1 warm-up sweep, 0 bytes)")
    out["trace"] = trace
    out["band_stats"] = getattr(mv, "band_stats", None)

    psd, true_rank = psd_repair(mv, n_op, trace, generator, draw, device)
    del mv
    out["psd"], out["true_rank"] = psd, true_rank
    stage(f"matvec-only PSD repair (rank {true_rank}->{psd.rank})")
    out["trace_rel"] = abs(psd.trace() - trace) / trace
    if verbose:
        print(f"    trace preserved to {out['trace_rel']:.2e}")

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
    """The kriged fields and the fitted ellipse fields of the run, and a
    figure of them."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "nonstationary_259k_fields_torch.npz"),
        **arrays)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lat, lon, _, _ = axes()
    panels = [
        ("truth", "Model-drawn truth", "RdBu_r", "centered"),
        ("field", "Kriged field (factored covariance)", "RdBu_r",
         "centered"),
        ("member0", "Ensemble member 0", "RdBu_r", "centered"),
        ("uncertainty", "Kriging uncertainty", "Blues", "pos"),
        ("Lx", "Fitted ellipse Lx (km)", "viridis", "pos"),
        ("theta", "Fitted ellipse rotation (rad)", "twilight", "raw"),
    ]
    fig, axs = plt.subplots(2, 3, figsize=(15.5, 6), dpi=110)
    for ax, (key, title, cmap, scale) in zip(axs.ravel(), panels):
        f = arrays[key].reshape(M_LAT, M_LON)
        if scale == "centered":
            vmax = np.nanpercentile(np.abs(f), 99)
            kw = dict(vmin=-vmax, vmax=vmax)
        elif scale == "pos":
            kw = dict(vmin=0.0, vmax=np.nanpercentile(f, 99))
        else:
            kw = {}
        im = ax.pcolormesh(lon, lat, f, cmap=cmap, **kw)
        ax.set_title(title, fontsize=10, color="#333")
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.suptitle("0.5-degree full-globe non-stationary pipeline, n = "
                 "259,200 (PyTorch port)", fontsize=11)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "nonstationary_259k_torch.png"))
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
            Lx=out["fields"]["Lx"],
            theta=out["fields"]["theta"],
        )


if __name__ == "__main__":
    main()
