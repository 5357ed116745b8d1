"""The ellipse configurations' common part: the non-stationary
(Paciorek-Schervish) covariance of per-cell ellipses on a regular global
grid, through the port's repaired pipeline:
``ellipse_covariance_operator`` (the store the configuration names: K2's
bf16 store, or the stream), ``explained_variance_clip_lowrank``,
``LowRankPSD.pad_rank`` and ``lowrank_ensemble_step`` (field,
uncertainty, constraint mask, members). The entries ``month`` and
``variant`` drive the port with it.

The ellipse fields are fixed by the configuration (``fields.seed``): the
synthetic maps of ``realistic_ellipse_params`` (base scales 900-1,800 km
with ~30% spatially correlated log-variation, rotated ellipses, a rough
standard deviation), so that every run's covariance, and with it the
rank and the work, is the same. The seed draws the rest on the card: the
observed cells, values and noise, the variants' order and the clip's
start blocks.
"""

import math

import numpy as np
import torch

from glomargridding_tpu_torch import ellipse_covariance_operator
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat

from .. import accounting
from .stationary import grid, max_rel

PROBE_COLUMNS = 8  # columns of the clip's first block compared with C X


def ellipse_fields(cfg, lat, lon):
    """(Lx, Ly, theta, stdev), float32 on the grid's device: sums of
    random plane waves on the sphere (wave numbers, signs, phases and
    amplitudes drawn from ``fields.seed``) shape the base fields."""
    rng = np.random.default_rng(int(cfg["fields"]["seed"]))
    ncomp = int(cfg["fields"]["components"])
    la = torch.deg2rad(lat.to(torch.float64))
    lo = torch.deg2rad(lon.to(torch.float64))

    def rough():
        out = torch.zeros_like(la)
        for _ in range(ncomp):
            k1, k2 = rng.integers(1, 7, size=2)
            s1, s2 = rng.choice([-1.0, 1.0], size=2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.normal()
            out += float(amp) * torch.sin(float(s1 * k1) * la
                                          + float(s2 * k2) * lo + float(ph))
        return out / math.sqrt(ncomp)

    coslat = torch.cos(la)
    Lx = (900.0 + 600.0 * coslat**2) * torch.exp(0.35 * rough())
    Ly = (600.0 + 300.0 * coslat) * torch.exp(0.35 * rough())
    theta = 0.4 * rough()
    stdev = (0.8 + 0.4 * coslat) * torch.exp(0.25 * rough())
    return tuple(a.to(torch.float32) for a in (Lx, Ly, theta, stdev))


class State:
    """The configuration on the card: the grid and the base fields."""

    def __init__(self, cfg, device, control):
        if cfg["dtype"] != "float32":
            raise ValueError("the ellipse configurations run in float32")
        lat, lon = grid(cfg)
        self.cfg, self.device, self.control = cfg, device, control
        self.lat = torch.as_tensor(lat, device=device)
        self.lon = torch.as_tensor(lon, device=device)
        self.la = torch.deg2rad(self.lat)
        self.lo = torch.deg2rad(self.lon)
        self.n = lat.size
        self.Lx, self.Ly, self.theta, self.stdev = ellipse_fields(
            cfg, self.lat, self.lon)


def build(cfg, device, seed, control):
    return State(cfg, device, control)


class Counted:
    """The operator handed to the clip, counting its applications and
    columns and keeping the first block it is given with its image."""

    def __init__(self, op):
        self.op, self.calls, self.columns, self.first = op, 0, 0, None

    def __call__(self, x):
        y = self.op(x)
        self.calls += 1
        self.columns += x.shape[1] if x.dim() == 2 else 1
        if self.first is None:
            x2, y2 = (x, y) if x.dim() == 2 else (x[:, None], y[:, None])
            self.first = (x2[:, :PROBE_COLUMNS].clone(),
                          y2[:, :PROBE_COLUMNS].clone())
        return y


def operator(state, Lx, Ly, theta, reference):
    """(matvec, n, trace) of the covariance of these fields: the port's
    operator with the configuration's store and cutoff, or, where that is
    the bf16 store, in the control the reference's fp8 store."""
    cfg = state.cfg
    if state.control and reference is not None and cfg["store"] == "bf16":
        f = reference_fields(state, reference, Lx, Ly, theta)
        return (reference.fp8_operator(f, float(cfg["nu"])), state.n,
                float(torch.sum(state.stdev.double() ** 2)))
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, theta)
    sig = torch.stack([s00, s01, s11], dim=-1)
    sqd = torch.sqrt(s00 * s11 - s01 * s01)
    return ellipse_covariance_operator(
        state.la, state.lo, sig, sqd, state.stdev, v=float(cfg["nu"]),
        delta_x_method=cfg["delta_x_method"], max_dist=cfg["max_dist_km"],
        n_blocks=cfg.get("n_blocks"), store=cfg["store"], device=state.device)


def observations(state, m, members, rank, gen):
    """(idx, y, e, z1, z2, zo) of one month on rank-`rank` factors: m
    distinct cells in order, N(0, 1) values, the diagonal error variance
    and the ensemble's standard normals ((n, M), (rank, M), (m, M); z2 is
    None where the rank is not known yet)."""
    dev = state.device
    idx = torch.sort(torch.randperm(state.n, generator=gen, device=dev)[:m])[0]
    y = torch.randn(m, generator=gen, device=dev)
    e = torch.full((m,), float(state.cfg["error_variance"]), device=dev)
    z1 = torch.randn((state.n, members), generator=gen, device=dev)
    z2 = None if rank is None else torch.randn((rank, members), generator=gen,
                                               device=dev)
    zo = torch.randn((m, members), generator=gen, device=dev)
    return idx, y, e, z1, z2, zo


def step_work(state, psd, m, members):
    r = int(torch.count_nonzero(psd.gains))
    return {"f32_flops": accounting.lowrank_step_flops(state.n, r, m, members),
            "rank": r}


def compare_step(psd, res, members, obs, reference):
    """The factored outputs against the reference's dense float64 solve
    on the same factors and normals."""
    f64 = torch.float64
    V, g, f = (t.to(f64) for t in (psd.vectors, psd.gains, psd.floor))
    idx, y, e, z1, z2, zo = obs
    field, unc, mask, mem = reference.lowrank(
        V, g, f, idx, *(t.to(f64) for t in (y, e, z1, z2, zo)))
    sd = float(torch.sqrt(torch.max(f + torch.sum(V * V * g, dim=1))))
    return {"field_err": max_rel(res.field, field),
            "uncertainty_err": max_rel(res.uncertainty, unc, sd),
            "mask_err": max_rel(res.constraint_mask, mask, 1.0),
            "members_err": max_rel(members, mem)}


def worst(numbers, into):
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


def eigen_numbers(fields, psd, nu, residual=True):
    """The clip's retained eigenpairs under the reference's float64
    covariance C, with theta_i = gain_i + floor the eigenvalue that the
    factors carry for v_i:

    - ``ritz_err``: max_i |v_i' C v_i / v_i' v_i - theta_i| over max
      theta: the factors' eigenvalues against C on their own vectors (a
      gain altered, or a store far from C, moves it; a subspace that has
      not converged does not, since its Ritz values are its Rayleigh
      quotients);
    - ``eig_res`` (with `residual`): the mean over the pairs of
      ||C v_i - theta_i v_i|| / (theta_i ||v_i||). A subspace that has
      not converged, at any rank, leaves its pairs' residuals large; the
      mean weighs every retained pair alike, so the pairs near the cut
      count as much as the leading ones, which converge first."""
    kept = psd.gains > 0
    V = psd.vectors[:, kept].to(torch.float64)
    theta = psd.gains[kept].to(torch.float64) + psd.floor[0].to(
        torch.float64)
    R = fields.apply(V, nu)
    vv = torch.sum(V * V, dim=0)
    rho = torch.sum(V * R, dim=0) / vv
    out = {"ritz_err": float((rho - theta).abs().max() / theta.abs().max())}
    if residual:
        R -= V * theta[None, :]
        res = torch.linalg.vector_norm(R, dim=0) / torch.sqrt(vv)
        out["eig_res"] = float(torch.mean(res / theta))
    return out


def reference_fields(state, reference, Lx, Ly, theta):
    """The reference's inputs for these fields, with the configuration's
    cutoff and displacement."""
    cfg = state.cfg
    return reference.Fields(state.lat, state.lon, Lx, Ly, theta, state.stdev,
                            max_dist_km=cfg["max_dist_km"],
                            delta_x_method=cfg["delta_x_method"])
