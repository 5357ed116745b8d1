"""ESA-CCI SST 5-degree monthly 1982-2022: kriging 41 Marches in one
batched call on the PyTorch port, on the card: the twin of
``examples/esa_months_scan.py``.

Each March's ocean anomalies become that month's observations; monthly
observation sets are padded to one size (huge-nugget padding) and
``months_scan_kriging`` krige all of them on the 2,592-cell grid, each
covariance tile built by the stationary kernel K1.

Run: python examples/torch_esa_months_scan.py
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

from glomargridding_tpu_torch.io import load_array
from glomargridding_tpu_torch.models.kernel_kriging import (
    months_scan_kriging,
    pad_month_observations,
    variogram_kernel,
)
from glomargridding_tpu_torch.ops.variogram import MaternVariogram
from glomargridding_tpu_torch.utils.device import resolve_device

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MONTH = 3
N_BLOCKS = 4  # column blocks of each month's grid


def month_observations(load=load_array, dtype=torch.float32):
    """(grid lats, grid lons, padded idx, obs, error cov, per-month obs
    counts) of the March anomalies, numpy in `dtype`."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    esa = load(
        f"{DATA}/esa_cci_sst_5deg_monthly_1982-2022_{MONTH:02d}.nc",
        "sst_anomaly",
    )
    vals = np.asarray(esa.values, dtype=np.float32)  # (41, 36, 72)
    vals[vals > 1e5] = np.nan
    vals = vals.astype(np_dtype)
    lat = np.asarray(esa.coords["lat"]).astype(np_dtype)
    lon = np.asarray(esa.coords["lon"]).astype(np_dtype)
    glat = np.repeat(lat, len(lon))
    glon = np.tile(lon, len(lat))

    idx_months, obs_months, err_months = [], [], []
    for t in range(vals.shape[0]):
        flat = vals[t].reshape(-1)
        idx = np.nonzero(np.isfinite(flat))[0]
        idx_months.append(idx)
        obs_months.append(flat[idx])
        err_months.append(np.diag(np.full(len(idx), 0.05, np_dtype)))
    idx_m, obs_m, err_m = pad_month_observations(
        idx_months, obs_months, err_months
    )
    return (glat, glon, idx_m, obs_m.astype(np_dtype),
            err_m.astype(np_dtype), [len(i) for i in idx_months])


def scan_kernel():
    """The stationary Matern(1.5) kernel every month is kriged with."""
    return variogram_kernel(MaternVariogram(
        psill=1.2, nugget=0.0, range=1300.0, nu=1.5, method="sklearn"
    ))


def run(device=None, dtype=torch.float32, load=load_array, verbose=True):
    """Krige every March, fields only and with the uncertainty and
    constraint mask; returns the outputs (tensors on the device) and the
    cold and warm seconds of each variant."""
    device = resolve_device(device)
    glat, glon, idx_m, obs_m, err_m, counts = month_observations(
        load, dtype)
    n_months = idx_m.shape[0]
    if verbose:
        print(f"{n_months} months, obs per month "
              f"{min(counts)}..{max(counts)}, bucket {idx_m.shape[1]}")
    kernel = scan_kernel()

    def scan(diagnostics):
        out = months_scan_kriging(
            kernel, glat, glon, idx_m, obs_m, err_m,
            variance=1.2, n_blocks=N_BLOCKS, diagnostics=diagnostics,
            device=device,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    times = {}
    results = {"counts": counts, "times": times}
    for diagnostics, label in ((False, "fields"),
                               (True, "fields+uncertainty+mask")):
        for phase in ("cold", "warm"):
            t0 = time.perf_counter()
            out = scan(diagnostics)
            times[f"{label} {phase}"] = time.perf_counter() - t0
        if verbose:
            warm = times[f"{label} warm"]
            print(f"{label}: cold {times[f'{label} cold']:.3f}s, warm "
                  f"{warm:.3f}s total, {warm / n_months * 1e3:.2f} "
                  f"ms/month", flush=True)
        if diagnostics:
            results["fields"], results["uncertainty"], \
                results["constraint_mask"] = out[:3]
        else:
            results["fields_only"] = out
    if tuple(results["fields"].shape) != (n_months, len(glat)):
        raise AssertionError(f"fields {tuple(results['fields'].shape)}")
    if not bool(torch.isfinite(results["fields"]).all()):
        raise AssertionError("non-finite fields")
    return results


if __name__ == "__main__":
    fields = run()["fields"].cpu().numpy()
    print(
        "per-month field rms:",
        np.sqrt((fields**2).mean(axis=1)).round(3)[:8],
        "...",
    )
