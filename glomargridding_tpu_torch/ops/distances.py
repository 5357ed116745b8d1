"""Great-circle and ellipse geometry on tensors.

Port of ``glomargridding_tpu/ops/distances.py``: the haversine pieces of
the stationary path (``:45-111``) and the ellipse geometry of the
non-stationary path (``rot_mat``, ``displacements``, ``sigma_rot_func``,
``sigma_rot_flat``). Latitude/longitude are in degrees unless stated;
distances come out in ``radius`` units (default: Earth radius in km).
"""

import math

import torch

from ..constants import RADIUS_OF_EARTH_KM
from ..utils.device import resolve_device

# Abramowitz-Stegun 4.4.46, highest order first, as in the reference
_ASIN_COEFFS = (
    -0.0012624911,
    0.0066700901,
    -0.0170881256,
    0.0308918810,
    -0.0501743046,
    0.0889789874,
    -0.2145988016,
    1.5707963050,
)


def asin_poly(x: torch.Tensor) -> torch.Tensor:
    """arcsin(x) for x in [0, 1] via Abramowitz-Stegun 4.4.46.

    Same Horner order and the same ``0.5 * pi`` constant in the working
    dtype as the reference. The polynomial's value at 0 is not 0
    (1.19e-7 in f32, 2.18e-8 in f64), so a self-pair gets a small
    positive distance and the Matern ``d == 0`` branch never fires on
    the diagonal: replacing this with ``torch.asin`` would change
    diag(K).
    """
    x = torch.clamp(x, 0.0, 1.0)
    p = torch.full_like(x, _ASIN_COEFFS[0])
    for c in _ASIN_COEFFS[1:]:
        p = p * x + c
    half_pi = torch.tensor(0.5 * math.pi, dtype=x.dtype, device=x.device)
    return half_pi - torch.sqrt(1.0 - x) * p


def _haversine_rad(lat1, lon1, lat2, lon2):
    """Central angle (radians) between broadcastable radian coordinates."""
    dlat = lat1 - lat2
    dlon = lon1 - lon2
    a = (
        torch.sin(dlat / 2.0) ** 2
        + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2
    )
    # clip guards f32 rounding at antipodes (a slightly > 1)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def radians(x: torch.Tensor) -> torch.Tensor:
    """Degrees to radians with the reference's constant (``jnp.radians``)."""
    return x * (math.pi / 180.0)


def degrees(x: torch.Tensor) -> torch.Tensor:
    """Radians to degrees with the reference's constant (``jnp.degrees``)."""
    return x * (180.0 / math.pi)


def haversine_matrix(
    lats1,
    lons1,
    lats2=None,
    lons2=None,
    radius: float = RADIUS_OF_EARTH_KM,
    device=None,
) -> torch.Tensor:
    """Pairwise great-circle distance matrix (degrees in, `radius` units
    out): |set1| x |set1|, or |set1| x |set2| with two sets. On `device`;
    with none, on the inputs' if one is a tensor, else on the card."""
    device = resolve_device(device, lats1, lons1, lats2, lons2)
    lats1 = torch.as_tensor(lats1, device=device)
    lons1 = torch.as_tensor(lons1, device=lats1.device)
    if lats2 is None:
        lats2, lons2 = lats1, lons1
    lats2 = torch.as_tensor(lats2, device=lats1.device)
    lons2 = torch.as_tensor(lons2, device=lats1.device)
    la1 = radians(lats1)[:, None]
    lo1 = radians(lons1)[:, None]
    la2 = radians(lats2)[None, :]
    lo2 = radians(lons2)[None, :]
    return radius * _haversine_rad(la1, lo1, la2, lo2)


def rot_mat(angle) -> torch.Tensor:
    """2-d rotation matrix from an angle in radians."""
    angle = torch.as_tensor(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def displacements(
    lats, lons, lats2=None, lons2=None, delta_x_method: str | None = None
):
    """N-S and E-W displacement matrices (disp_y, disp_x) for all pairs.

    Longitude differences are wrapped into (-180, 180]. With
    ``delta_x_method=None`` the results are in degrees; "Met_Office"
    converts them to radians on a cylindrical Earth, and
    "Modified_Met_Office" also scales the zonal displacement by the
    pair's mean cos-latitude. Not multiplied by a radius.
    """
    if delta_x_method not in (None, "Met_Office", "Modified_Met_Office"):
        raise ValueError(
            f"Unknown 'delta_x_method' value, got '{delta_x_method}'"
        )
    lats = torch.atleast_1d(torch.as_tensor(lats))
    lons = torch.atleast_1d(torch.as_tensor(lons, device=lats.device))
    lats2 = lats if lats2 is None else torch.atleast_1d(
        torch.as_tensor(lats2, device=lats.device))
    lons2 = lons if lons2 is None else torch.atleast_1d(
        torch.as_tensor(lons2, device=lats.device))

    disp_y = lats[:, None] - lats2[None, :]
    disp_x = lons[:, None] - lons2[None, :]
    disp_x = torch.where(disp_x > 180.0, disp_x - 360.0, disp_x)
    disp_x = torch.where(disp_x < -180.0, disp_x + 360.0, disp_x)
    if delta_x_method is None:
        return disp_y, disp_x

    disp_y = radians(disp_y)
    disp_x = radians(disp_x)
    if delta_x_method == "Modified_Met_Office":
        y_cos_mean = 0.5 * (
            torch.cos(radians(lats))[:, None]
            + torch.cos(radians(lats2))[None, :]
        )
        disp_x = disp_x * y_cos_mean
    return disp_y, disp_x


def sigma_rot_func(Lx, Ly, theta=None) -> torch.Tensor:
    """Sigma(Lx, Ly, theta) = R diag(Lx^2, Ly^2) R^T (2 x 2), Karspeck et
    al. 2011 Eq. 15 / Paciorek-Schervish 2006 Eq. 6."""
    Lx, Ly = torch.as_tensor(Lx), torch.as_tensor(Ly)
    L = torch.diag(torch.stack([Lx**2.0, Ly**2.0]))
    if theta is None:
        return L
    R = rot_mat(theta).to(L.dtype)
    return R @ L @ R.T


def sigma_rot_flat(Lx, Ly, theta):
    """Flattened (s00, s01, s10, s11) Sigma entries for vector parameters,
    the layout the ellipse kernels consume."""
    ct = torch.cos(theta)
    st = torch.sin(theta)
    c2 = ct * ct
    s2 = st * st
    cs = ct * st
    Lx2 = Lx * Lx
    Ly2 = Ly * Ly
    s00 = c2 * Lx2 + s2 * Ly2
    s01 = cs * (Lx2 - Ly2)
    s11 = s2 * Lx2 + c2 * Ly2
    return s00, s01, s01, s11
