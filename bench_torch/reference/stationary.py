"""Plain reference of the stationary configuration: the Matern
covariance of great-circle distance (sklearn's convention), ordinary and
simple kriging, and the observation-perturbation ensemble, in float64.

Nothing here is the port's: the haversine distance and the Matern
function are written from their definitions, and the solves are
``reference.kriging``'s.
"""

import math

import torch

from . import kriging

RADIUS_KM = 6371.0  # the mean radius of the Earth


def matern_correlation(x, nu):
    """The Matern correlation at x = sqrt(2 nu) d / range (sklearn), in
    closed form for the half-integer orders."""
    if nu == 0.5:
        return torch.exp(-x)
    if nu == 1.5:
        return (1.0 + x) * torch.exp(-x)
    if nu == 2.5:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    raise ValueError(f"no closed form for nu = {nu}")


def haversine_km(lat1, lon1, lat2, lon2):
    """(len(lat1), len(lat2)) great-circle distances; degrees in."""
    p1, p2 = torch.deg2rad(lat1)[:, None], torch.deg2rad(lat2)[None, :]
    dl = torch.deg2rad(lon1)[:, None] - torch.deg2rad(lon2)[None, :]
    a = torch.sin(0.5 * (p1 - p2)) ** 2 + (
        torch.cos(p1) * torch.cos(p2) * torch.sin(0.5 * dl) ** 2)
    return 2.0 * RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(a, max=1.0)))


def covariance(cfg, lat1, lon1, lat2, lon2):
    """psill * corr(d) + nugget at d = 0 (the nugget is 0 here)."""
    v = cfg["variogram"]
    if v["method"] != "sklearn" or cfg["distance"] != "haversine":
        raise ValueError("the reference knows the sklearn Matern of "
                         "haversine distance only")
    nu = float(v["nu"])
    d = haversine_km(lat1, lon1, lat2, lon2)
    c = v["psill"] * matern_correlation(math.sqrt(2.0 * nu) * d / v["range_km"],
                                        nu)
    return torch.where(d == 0.0, c + v.get("nugget", 0.0), c)


def _system(cfg, lat, lon, idx, err):
    lo, la = lon[idx], lat[idx]
    K = covariance(cfg, la, lo, la, lo) + torch.diag(err)

    def cross(a, b):
        return covariance(cfg, la, lo, lat[a:b], lon[a:b])

    c0 = torch.full_like(lat, cfg["variogram"]["psill"]
                         + cfg["variogram"].get("nugget", 0.0))
    return K, cross, c0


def kriging_fields(cfg, lat, lon, idx, y, err, method="ordinary"):
    """(field, uncertainty, constraint mask) of the grid (lat, lon in
    degrees, float64) from observations y at cells idx with diagonal
    error variances err."""
    K, cross, c0 = _system(cfg, lat, lon, idx, err)
    if method == "ordinary":
        return kriging.ordinary(K, cross, c0, y)
    return kriging.simple(K, cross, c0, y)


def ensemble(cfg, lat, lon, idx, y, err, z):
    """(ordinary field, members): each member is the field plus the
    simple-kriged draw L z_k of the observations' covariance K = L L'
    (z: (members, m) standard normals)."""
    K, cross, c0 = _system(cfg, lat, lon, idx, err)
    field, _, _ = kriging.ordinary(K, cross, c0, y)
    sim = torch.linalg.cholesky(K) @ z.T
    return field, field[None, :] + kriging.kriged_draws(K, cross, lat.shape[0],
                                                        sim)
