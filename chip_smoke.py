#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (glomargridding_tpu_torch).

Drives the port's main path on one NVIDIA GPU: ordinary kriging of the
1-degree global grid (64,800 cells) from 5,000 observations, Matern
nu = 0.5 (sklearn convention), psill 1.2, range 1200 km, haversine
distance and a diagonal error covariance, through
``kriging_from_kernel(variogram_kernel(MaternVariogram(...)), ...)``.
It builds the path's kernel (the pairwise covariance tile) from the
sources in this checkout, holds it against its plain PyTorch twin,
checks the kriging outputs against the same call in float64 on the card,
runs the 100-member ensemble and the 259,200-cell grid, and times them.

Usage, from the repository root, with no arguments:

    python3 chip_smoke.py

One line per phase. Any failure raises and the script exits non-zero
without the final line. The final line is one JSON object with the
device; the line before it lists each kernel with its launch count on
the main path, its error against the plain twin and its time.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_OBS = 5000
N_MEMBERS = 100
PSILL = 1.2
RANGE_KM = 1200.0
SEED = 0
REPEATS = 5

# K1 against its plain twin: max |kernel - plain| / variance. Both
# evaluate the same formula; the kernel's FMA contraction moves a few
# roundings. f64: a few ulp. f32: asin_poly's f32 value carries an
# absolute error of ~1 ulp of pi/2 (1.2e-7 rad) at every distance (it is
# a difference of two numbers near pi/2), so a few ulp there move d by
# up to ~5e-3 km and corr by scale * 5e-3 / range, up to ~1e-5.
TILE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# f32 kriging against the f64 run of the same call on the card, relative
# to each output's scale (max |field|, sqrt(variance), 1): f32 eps
# (6e-8) times cond(K) ~1e3 for K = C_obs + E with E >= 0.1.
KRIGING_TOL = 1e-3
# the ensemble's field is the ordinary field through a wider GEMM that
# sums in another order: both are f32 values of one quantity, each within
# KRIGING_TOL of f64, so they are held to each other by the same bound
ENSEMBLE_FIELD_TOL = KRIGING_TOL
# small f64 problem, card (kernel) vs CPU (plain twin)
SMALL_RTOL = 1e-10


def sync():
    torch.cuda.synchronize()


def phase(number, title, **values):
    parts = [f"{k}={v}" for k, v in values.items()]
    print(f"phase {number} {title}: " + " ".join(parts), flush=True)


def max_rel(a, b, scale=None):
    """max |a - b| / scale (scale defaults to max |b|), as a float."""
    err = torch.max(torch.abs(a.double() - b.double())).item()
    ref = torch.max(torch.abs(b.double())).item() if scale is None else scale
    return err / ref


def grid_1deg():
    lat = np.arange(-89.5, 90.0, 1.0, dtype=np.float32)
    lon = np.arange(-179.5, 180.0, 1.0, dtype=np.float32)
    return np.repeat(lat, lon.size), np.tile(lon, lat.size)


def grid_linspace(n_lat, n_lon):
    half_dlat, half_dlon = 90.0 / n_lat, 180.0 / n_lon
    lat = np.linspace(-90 + half_dlat, 90 - half_dlat, n_lat).astype(np.float32)
    lon = np.linspace(-180 + half_dlon, 180 - half_dlon, n_lon).astype(
        np.float32
    )
    return np.repeat(lat, n_lon), np.tile(lon, n_lat)


def observations(m, device):
    """The benchmark's observation draw (seed 0), as f32 tensors."""
    rng = np.random.default_rng(SEED)
    idx = np.sort(rng.choice(m, size=N_OBS, replace=False)).astype(np.int64)
    y = rng.normal(size=N_OBS).astype(np.float32)
    err = np.diag((0.1 + 0.05 * rng.random(N_OBS)).astype(np.float32))
    return (
        torch.as_tensor(idx, device=device),
        torch.as_tensor(y, device=device),
        torch.as_tensor(err, device=device),
    )


def cuda_time_ms(fn, iters=20):
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / iters


def wall_median_s(fn):
    fn()
    sync()
    walls = []
    for _ in range(REPEATS):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def check_kriging(res, oracle, variance, label):
    errs = {
        "field": max_rel(res.field, oracle.field),
        "uncertainty": max_rel(
            res.uncertainty, oracle.uncertainty, variance**0.5
        ),
        "constraint_mask": max_rel(
            res.constraint_mask, oracle.constraint_mask, 1.0
        ),
    }
    for name, value in zip(res._fields, res):
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    bad = {k: v for k, v in errs.items() if not v <= KRIGING_TOL}
    if bad:
        raise AssertionError(f"{label}: f32 vs f64 beyond {KRIGING_TOL}: {bad}")
    return errs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")

    from glomargridding_tpu_torch import (
        MaternVariogram,
        ensemble_from_kernel,
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_tpu_torch.ops.cuda import build
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        DISTANCES,
        pairwise_covariance,
        pairwise_covariance_torch,
    )

    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    precision = torch.get_float32_matmul_precision()
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"f32 matmul precision is {precision!r}")
    phase(1, "device", torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), matmul_precision=precision)

    # 2. build K1 from the sources in this checkout
    t0 = time.perf_counter()
    build.load_library("pairwise_tile")
    phase(2, "build", seconds=f"{time.perf_counter() - t0:.1f}",
          library=build.library_path("pairwise_tile").name)

    # 3. K1 against its plain twin at the main path's tile shapes
    glat, glon = grid_1deg()
    m = glat.size
    idx, y, err = observations(m, dev)
    la = torch.deg2rad(torch.as_tensor(glat, device=dev))
    lo = torch.deg2rad(torch.as_tensor(glon, device=dev))
    la_o, lo_o = la[idx], lo[idx]
    shapes = {"5000x4096": slice(0, 4096), "5000x4133": slice(7000, 11133),
              "5000x5000(K)": None}
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for nu in (0.5, 1.5, 2.5, 3.5):
            vario = MaternVariogram(psill=PSILL, nugget=0.05, range=RANGE_KM,
                                    nu=nu)
            for distance in DISTANCES:
                for label, cols in shapes.items():
                    rows = (la_o.to(dtype), lo_o.to(dtype))
                    col = rows if cols is None else (
                        la[cols].to(dtype), lo[cols].to(dtype))
                    args = (*rows, *col, vario, distance)
                    k = pairwise_covariance(*args)
                    p = pairwise_covariance_torch(*args)
                    sync()
                    if not bool(torch.isfinite(k).all()):
                        raise AssertionError(f"non-finite K1 tile {label}")
                    rel = max_rel(k, p, vario.psill + vario.nugget)
                    if not rel <= TILE_RTOL[dtype]:
                        raise AssertionError(
                            f"K1 {dtype} nu={nu} {distance} {label}: "
                            f"{rel:.3e} > {TILE_RTOL[dtype]}"
                        )
                    worst[dtype] = max(worst[dtype], rel)
        del k, p
    # the main path's own configuration, for the kernel report
    main_vario = MaternVariogram(psill=PSILL, range=RANGE_KM, nu=0.5)
    tile_args = (la_o, lo_o, la[:4096].contiguous(), lo[:4096].contiguous(),
                 main_vario, "haversine")
    main_abs_err = torch.max(torch.abs(
        pairwise_covariance(*tile_args) - pairwise_covariance_torch(*tile_args)
    )).item()
    phase(3, "k1_parity", shapes="|".join(shapes), nus="0.5|1.5|2.5|3.5",
          distances="|".join(DISTANCES),
          f32_max_rel=f"{worst[torch.float32]:.3e}",
          f32_bound=TILE_RTOL[torch.float32],
          f64_max_rel=f"{worst[torch.float64]:.3e}",
          f64_bound=TILE_RTOL[torch.float64],
          main_f32_max_abs=f"{main_abs_err:.3e}")

    # 4. the main path: 64,800 cells x 5,000 observations
    kernel = variogram_kernel(main_vario, distance="haversine")
    glat_t = torch.as_tensor(glat, device=dev)
    glon_t = torch.as_tensor(glon, device=dev)

    def krige(method, dtype=torch.float32, lats=glat_t, lons=glon_t,
              obs=(idx, y, err), n_blocks=16):
        i, yy, e = obs
        return kriging_from_kernel(
            kernel, lats.to(dtype), lons.to(dtype), i, yy.to(dtype),
            error_cov=e.to(dtype), variance=PSILL, method=method,
            n_blocks=n_blocks,
        )

    pairwise_covariance.launches = 0
    ordinary = krige("ordinary")
    sync()
    main_launches = pairwise_covariance.launches
    if main_launches == 0:
        raise AssertionError("the main path launched no K1 tile")
    simple = krige("simple")
    errs_o = check_kriging(ordinary, krige("ordinary", torch.float64),
                           PSILL, "ordinary")
    errs_s = check_kriging(simple, krige("simple", torch.float64),
                           PSILL, "simple")
    if ordinary.field.shape != (m,):
        raise AssertionError(f"field shape {tuple(ordinary.field.shape)}")

    # small f64 problem: card (K1) against CPU (plain twin)
    rng = np.random.default_rng(SEED)
    s_lat = np.repeat(np.arange(-82.5, 90, 15.0), 24)
    s_lon = np.tile(np.arange(-172.5, 180, 15.0), 12)
    s_idx = np.sort(rng.choice(s_lat.size, 20, replace=False))
    s_obs = rng.normal(size=20)
    s_err = np.diag(0.1 + 0.05 * rng.random(20))
    small = [
        kriging_from_kernel(kernel, s_lat, s_lon, s_idx, s_obs, s_err,
                            variance=PSILL, n_blocks=3, device=d)
        for d in (dev, "cpu")
    ]
    small_err = max(
        max_rel(a.cpu(), b) for a, b in zip(small[0], small[1])
    )
    if not small_err <= SMALL_RTOL:
        raise AssertionError(f"card vs CPU small f64: {small_err:.3e}")
    phase(4, "kriging_64800x5000", k1_launches=main_launches,
          tol=KRIGING_TOL,
          **{f"ordinary_{k}": f"{v:.3e}" for k, v in errs_o.items()},
          **{f"simple_{k}": f"{v:.3e}" for k, v in errs_s.items()},
          small_card_vs_cpu_f64=f"{small_err:.3e}")

    # 5. the 100-member ensemble
    def ensemble():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ensemble_from_kernel(kernel, glat_t, glon_t, idx, y, err, gen,
                                    n_members=N_MEMBERS, n_blocks=16)

    field_e, members = ensemble()
    sync()
    field_err = max_rel(field_e, ordinary.field)
    if not field_err <= ENSEMBLE_FIELD_TOL:
        raise AssertionError(f"ensemble field vs ordinary: {field_err:.3e}")
    if members.shape != (N_MEMBERS, m) or not bool(
        torch.isfinite(members).all()
    ):
        raise AssertionError("ensemble members malformed")
    # each member's perturbation is simple-kriged unit noise through K, so
    # its variance at a cell is c' K^-1 c = variance * constraint mask
    spread = torch.var(members - field_e, dim=0).mean().item()
    expected = (PSILL * ordinary.constraint_mask).mean().item()
    if not 0.8 <= spread / expected <= 1.25:
        raise AssertionError(f"ensemble spread ratio {spread / expected:.3f}")
    phase(5, "ensemble_100", field_vs_ordinary=f"{field_err:.3e}",
          tol=ENSEMBLE_FIELD_TOL, spread_ratio=f"{spread / expected:.4f}")
    del members

    # 6. the 0.25-degree-class grid: 259,200 cells, 64 blocks
    q_lat, q_lon = grid_linspace(360, 720)
    q_glat = torch.as_tensor(q_lat, device=dev)
    q_glon = torch.as_tensor(q_lon, device=dev)
    q_obs = observations(q_lat.size, dev)

    def krige_quarter(dtype=torch.float32):
        return krige("ordinary", dtype, q_glat, q_glon, q_obs, n_blocks=64)

    quarter = krige_quarter()
    errs_q = check_kriging(quarter, krige_quarter(torch.float64), PSILL,
                           "259200")
    phase(6, "kriging_259200x5000", tol=KRIGING_TOL,
          **{k: f"{v:.3e}" for k, v in errs_q.items()})
    del quarter

    # 7. warm times
    k1_ms = cuda_time_ms(lambda: pairwise_covariance(*tile_args))
    plain_ms = cuda_time_ms(lambda: pairwise_covariance_torch(*tile_args))
    walls = {
        "kriging_64800_s": wall_median_s(lambda: krige("ordinary")),
        "kriging_simple_64800_s": wall_median_s(lambda: krige("simple")),
        "ensemble_100_s": wall_median_s(ensemble),
        "kriging_259200_s": wall_median_s(krige_quarter),
    }
    torch.cuda.reset_peak_memory_stats()
    krige("ordinary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase(7, "times", repeats=REPEATS, k1_5000x4096_ms=f"{k1_ms:.4f}",
          plain_5000x4096_ms=f"{plain_ms:.4f}",
          **{k: f"{v:.4f}" for k, v in walls.items()},
          kriging_64800_peak_gb=f"{peak_gb:.3f}")

    print(json.dumps({"kernels": [{
        "name": "pairwise_tile",
        "route": "cuda",
        "source": "glomargridding_tpu_torch/ops/cuda/csrc/pairwise_tile.cu",
        "replaces": "glomargridding_tpu/ops/pallas/pairwise.py:102",
        "launches": main_launches,
        "max_abs_err": main_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
