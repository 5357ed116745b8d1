"""The stationary configurations' common part: kriging of a regular
global grid against a Matern covariance of great-circle distance. The
state on the card (the grid and the port's covariance kernel) and a
month's inputs, made on the card from the seed: m distinct observed
cells, standard-normal observations and diagonal error variances
uniform in the configuration's range. The entries ``kriging`` and
``ensemble`` drive the port with them.
"""

import numpy as np
import torch

from glomargridding_tpu_torch import MaternVariogram, variogram_kernel

from .. import accounting


def grid(cfg):
    """Flattened cell centres (float32 degrees), latitude-major."""
    step = float(cfg["grid"]["step_deg"])
    lat = np.arange(-90.0 + step / 2, 90.0, step, dtype=np.float64)
    lon = np.arange(-180.0 + step / 2, 180.0, step, dtype=np.float64)
    return (np.repeat(lat, lon.size).astype(np.float32),
            np.tile(lon, lat.size).astype(np.float32))


class State:
    """The configuration on the card: the grid and the covariance
    kernel."""

    def __init__(self, cfg, device):
        if cfg["dtype"] != "float32":
            raise ValueError("the family runs in float32")
        lat, lon = grid(cfg)
        self.cfg, self.device = cfg, device
        self.lat = torch.as_tensor(lat, device=device)
        self.lon = torch.as_tensor(lon, device=device)
        self.n = lat.size
        v = cfg["variogram"]
        self.kernel = variogram_kernel(
            MaternVariogram(psill=v["psill"], nugget=v.get("nugget", 0.0),
                            range=v["range_km"], nu=v["nu"],
                            method=v["method"]),
            distance=cfg["distance"])
        self.variance = v["psill"] + v.get("nugget", 0.0)


def build(cfg, device, seed, control):
    return State(cfg, device)


def observations(state, m, gen):
    """(idx, y, E): m distinct cells in order, N(0, 1) values and the
    (m, m) diagonal error covariance."""
    dev = state.device
    idx = torch.sort(torch.randperm(state.n, generator=gen, device=dev)[:m])[0]
    y = torch.randn(m, generator=gen, device=dev)
    lo, hi = state.cfg["error_variance"]
    err = lo + (hi - lo) * torch.rand(m, generator=gen, device=dev)
    return idx, y, torch.diag(err)


def max_rel(got, want, scale=None):
    """max |got - want| over `scale` (max |want| by default)."""
    want = want.to(torch.float64)
    scale = float(want.abs().max()) if scale is None else scale
    return float((got.to(torch.float64) - want).abs().max()) / scale


def k1_least_ms(m, n):
    """The K1 tiles of one month: the (m, m) system and (m, n) cross."""
    return accounting.k1_least_ms(m, m)[0] + accounting.k1_least_ms(m, n)[0]
