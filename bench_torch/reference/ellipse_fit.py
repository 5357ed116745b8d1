"""Plain reference of the ellipse fit in float64: the maximum-likelihood
ellipse (Lx, Ly, theta) of chosen centre cells from a training cube, as
GloMarGridding's ``EllipseBuilder.compute_params`` describes it (the
``ellipse`` package, the ``Ellipse_to_grid`` notebook; Karspeck et al.
2012, local anisotropic Matern fits to training correlations; the
Paciorek-Schervish ellipse).

For each centre c:

- the empirical correlations rho_cj of the cube's (T, n) samples, each
  cell's mean removed;
- its training columns: the cells j with min_distance < d_cj <=
  max_distance, d the great-circle (haversine) distance, and of those the
  k nearest by the length of the displacement (dx, dy) in km: dy = R
  (lat_j - lat_c), dx = R (lon_j - lon_c) [0.5 (cos lat_c + cos lat_j)
  with the Modified Met Office displacement], the longitude difference
  wrapped into [-180, 180] with exactly +-180 left as it is;
- the Fisher-z negative log-likelihood of the rotated anisotropic Matern
  with unit sigma, over the training columns,

      f(p) = sum_j [ (z_j - m_j(p))^2 / 2 + log sqrt(2 pi) ],
      z_j = arctanh(clip(rho_cj)), m_j = arctanh(clip(M_nu(x_j))),

  clip to +-0.999999, x_j = 2 sqrt(nu) tau_j, tau_j^2 = (u / Lx)^2 + (v /
  Ly)^2 with (u, v) = (cos t dx + sin t dy, -sin t dx + cos t dy), and
  M_nu in closed form (nu = 1.5: (1 + x) e^-x, that is (1 + sqrt(3) r)
  e^(-sqrt(3) r) with r = sqrt(2) tau);
- a textbook Nelder-Mead (scipy's decision tree: reflection 1, expansion
  2, contractions 1/2, shrink 1/2), every trial point clipped into the
  box, from scipy's initial simplex about the guess (each coordinate x
  1.05, or 0.00025 where it is 0), stopping when the simplex spreads by
  at most `tol` in f and in every coordinate about its best vertex, or
  after `maxiter` iterations.

Ties: on a regular grid many columns share a displacement length (a
column and its mirror in longitude), so the k-th nearest is often one of
a tied pair, and which one a fit keeps is not defined. ``columns`` marks
the columns strictly nearer than the k-th length (``inside``) and those
at it (``tied``, within a relative 1e-6, where float32 lengths may order
differently); the reference's own fit keeps the first k of a stable sort,
and ``tied_interval`` gives the least and the most objective any choice
of the tied columns can take.

Departures from the description: a column at exactly `min_distance` is
left out (none of the 1-degree grid's is); the iteration limit counts
iterations from 0, so a lane may take `maxiter` of them (scipy's loop
stops at `maxiter` - 1); f is summed over the lane's columns in one
float64 reduction. The lanes of a block are fitted side by side, each
with its own simplex. Only the rotated anisotropic model with unit sigma
in physical distance is written here.
"""

import math

import torch

from .ellipse import matern

RADIUS_KM = 6371.0  # the mean radius of the Earth
CLIP = 0.999999
TIE_RTOL = 1e-6
F64 = torch.float64


def set_precision():
    """True f64 products: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def correlation_rows(cube, centres):
    """(L, n) empirical correlations of the centres with every cell, from
    the (T, n) cube, in float64."""
    x = cube.to(F64)
    x = x - x.mean(dim=0, keepdim=True)
    x = x / torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
    return x[:, centres].T @ x


def displacements_km(lat, lon, centres, delta_x_method):
    """(dx, dy), (L, n) in km from each centre to every cell, and the
    great-circle distance d."""
    la = torch.deg2rad(lat.to(F64))
    lo = lon.to(F64)
    lac = la[centres, None]
    dlon = lo[None, :] - lo[centres, None]
    dlon = torch.where(dlon > 180.0, dlon - 360.0, dlon)
    dlon = torch.where(dlon < -180.0, dlon + 360.0, dlon)
    dlon = torch.deg2rad(dlon)
    dx = RADIUS_KM * dlon
    if delta_x_method == "Modified_Met_Office":
        dx = dx * 0.5 * (torch.cos(lac) + torch.cos(la[None, :]))
    elif delta_x_method != "Met_Office":
        raise ValueError(f"unknown displacement {delta_x_method!r}")
    dy = RADIUS_KM * (la[None, :] - lac)
    hav = torch.sin(0.5 * (la[None, :] - lac)) ** 2 + torch.cos(lac) \
        * torch.cos(la[None, :]) * torch.sin(0.5 * dlon) ** 2
    d = 2.0 * RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(hav, max=1.0)))
    return dx, dy, d


def columns(cube, lat, lon, centres, *, k, min_distance, max_distance,
            delta_x_method):
    """Each centre's training columns, the nearest first: a dict of (L, W)
    tensors, W the most any centre needs (its k columns and the ties at
    the k-th length): ``dx``, ``dy`` (km), ``z`` (the Fisher-transformed
    correlations), ``kept`` (the reference's k columns), ``inside`` and
    ``tied``, and ``take`` (L,), how many tied columns make up k."""
    dx, dy, d = displacements_km(lat, lon, centres, delta_x_method)
    window = (d > min_distance) & (d <= max_distance)
    length2 = torch.where(window, dx * dx + dy * dy,
                          torch.full_like(dx, math.inf))
    length2, order = torch.sort(length2, dim=1, stable=True)
    n_window = window.sum(dim=1)
    kth = length2[:, min(k, length2.shape[1]) - 1:][:, :1]
    finite = torch.isfinite(kth)
    inside = (length2 < kth * (1.0 - TIE_RTOL)) | (
        ~finite & torch.isfinite(length2))
    tied = finite & (torch.abs(length2 - kth) <= TIE_RTOL * kth)
    width = int((inside | tied).sum(dim=1).max())
    order = order[:, :width]
    rho = torch.take_along_dim(correlation_rows(cube, centres), order, dim=1)
    pos = torch.arange(width, device=order.device)[None, :]
    kept = pos < n_window.clamp(max=k)[:, None]
    inside, tied = inside[:, :width], tied[:, :width]
    return {"dx": torch.take_along_dim(dx, order, dim=1),
            "dy": torch.take_along_dim(dy, order, dim=1),
            "z": torch.arctanh(torch.clamp(rho, -CLIP, CLIP)),
            "kept": kept, "inside": inside, "tied": tied,
            "take": torch.minimum(k - inside.sum(dim=1), tied.sum(dim=1))}


def terms(cols, p, nu):
    """Each column's term of f at the points p (L, P, 3): (L, P, W)."""
    Lx, Ly, t = (p[..., i, None] for i in range(3))
    dx, dy = cols["dx"][:, None, :], cols["dy"][:, None, :]
    u = torch.cos(t) * dx + torch.sin(t) * dy
    v = -torch.sin(t) * dx + torch.cos(t) * dy
    tau = torch.sqrt((u / Lx) ** 2 + (v / Ly) ** 2)
    m = torch.arctanh(torch.clamp(matern(2.0 * math.sqrt(nu) * tau, nu),
                                  -CLIP, CLIP))
    return 0.5 * (cols["z"][:, None, :] - m) ** 2 + 0.5 * math.log(
        2.0 * math.pi)


def objective(cols, p, nu):
    """f over the reference's k columns at p (L, P, 3): (L, P)."""
    return torch.sum(terms(cols, p, nu) * cols["kept"][:, None, :], dim=-1)


def tied_interval(cols, x, nu):
    """(least, most) of f at x (L, 3) over every choice of the tied
    columns that makes up k."""
    c = terms(cols, x[:, None, :], nu)[:, 0]
    base = torch.sum(c * cols["inside"], dim=1)
    tied = torch.where(cols["tied"], c, torch.full_like(c, math.inf))
    low = torch.sort(tied, dim=1).values
    high = torch.sort(torch.where(cols["tied"], c, -math.inf), dim=1,
                      descending=True).values
    pick = torch.arange(c.shape[1], device=c.device)[None, :] \
        < cols["take"][:, None]
    zero = torch.zeros_like(c)
    return (base + torch.sum(torch.where(pick, low, zero), dim=1),
            base + torch.sum(torch.where(pick, high, zero), dim=1))


def nelder_mead(fun, x0, lo, hi, tol, maxiter):
    """Minimise fun (L, P, d) -> (L, P) lane by lane from x0 (L, d), each
    point clipped into [lo, hi]: (x, f, iterations), (L, d), (L,), (L,)."""
    L, d = x0.shape
    sim = x0[:, None, :].repeat(1, d + 1, 1)
    for i in range(d):
        sim[:, i + 1, i] = torch.where(x0[:, i] != 0, 1.05 * x0[:, i],
                                       torch.full_like(x0[:, i], 0.00025))
    sim = torch.clamp(sim, lo, hi)
    fs = fun(sim)
    nit = torch.zeros(L, dtype=torch.long, device=x0.device)
    for _ in range(maxiter):
        order = torch.argsort(fs, dim=1, stable=True)
        sim = torch.take_along_dim(sim, order[..., None], dim=1)
        fs = torch.take_along_dim(fs, order, dim=1)
        done = (torch.amax(torch.abs(sim[:, 1:] - sim[:, :1]), dim=(1, 2))
                <= tol) & (torch.amax(torch.abs(fs[:, 1:] - fs[:, :1]),
                                      dim=1) <= tol)
        if bool(done.all()):
            break
        xbar = sim[:, :-1].mean(dim=1)
        worst = sim[:, -1]
        trial = torch.clamp(torch.stack([
            2.0 * xbar - worst,  # reflection
            3.0 * xbar - 2.0 * worst,  # expansion
            1.5 * xbar - 0.5 * worst,  # outside contraction
            0.5 * xbar + 0.5 * worst,  # inside contraction
        ], dim=1), lo, hi)
        fr, fe, fc, fcc = fun(trial).unbind(dim=1)
        f0, f_second, f_worst = fs[:, 0], fs[:, -2], fs[:, -1]
        # scipy's tree: expansion or reflection where the reflection beats
        # the best, reflection where it beats the second worst, else a
        # contraction, else a shrink
        pick = torch.where(
            fr < f0, torch.where(fe < fr, 1, 0), torch.where(
                fr < f_second, 0, torch.where(
                    fr < f_worst, torch.where(fc <= fr, 2, 4),
                    torch.where(fcc < f_worst, 3, 4))))
        shrink = pick == 4
        new_sim = sim.clone()
        new_fs = fs.clone()
        step = ~shrink
        take = pick.clamp(max=3)
        new_sim[:, -1] = torch.where(step[:, None], torch.take_along_dim(
            trial, take[:, None, None], dim=1)[:, 0], worst)
        new_fs[:, -1] = torch.where(step, torch.take_along_dim(
            torch.stack([fr, fe, fc, fcc], dim=1), take[:, None],
            dim=1)[:, 0], f_worst)
        if bool((shrink & ~done).any()):
            shrunk = torch.clamp(sim[:, :1] + 0.5 * (sim - sim[:, :1]), lo, hi)
            shrunk_f = fun(shrunk)
            new_sim = torch.where(shrink[:, None, None], shrunk, new_sim)
            new_fs = torch.where(shrink[:, None], shrunk_f, new_fs)
        sim = torch.where(done[:, None, None], sim, new_sim)
        fs = torch.where(done[:, None], fs, new_fs)
        nit += (~done).long()
    best = torch.argmin(fs, dim=1)
    return (torch.take_along_dim(sim, best[:, None, None], dim=1)[:, 0],
            torch.take_along_dim(fs, best[:, None], dim=1)[:, 0], nit)


def fit(cube, lat, lon, centres, x_program, *, nu, k, min_distance,
        max_distance, delta_x_method, guesses, bounds, tol, maxiter):
    """The reference's fit of `centres` beside the program's optima
    `x_program` (L, 3): a dict of float64 tensors, ``x`` and ``f`` its own
    optima and objective, ``f_program`` its objective at the program's
    optima, ``low`` and ``high`` the least and most f there over the
    tied columns' choices, ``nit`` its iterations."""
    set_precision()
    cols = columns(cube, lat, lon, centres, k=k, min_distance=min_distance,
                   max_distance=max_distance, delta_x_method=delta_x_method)
    dev = cols["z"].device
    lo, hi = (torch.tensor([b[i] for b in bounds], dtype=F64, device=dev)
              for i in range(2))
    x0 = torch.tensor(guesses, dtype=F64, device=dev).expand(
        len(centres), len(guesses)).clone()
    x, f, nit = nelder_mead(lambda p: objective(cols, p, nu), x0, lo, hi,
                            tol, maxiter)
    xp = x_program.to(F64)
    low, high = tied_interval(cols, xp, nu)
    return {"x": x, "f": f, "nit": nit, "low": low, "high": high,
            "f_program": objective(cols, xp[:, None, :], nu)[:, 0]}
