"""Great-circle geometry on tensors.

Port of ``glomargridding_tpu/ops/distances.py:45-111`` (the main-path
pieces). Latitude/longitude are in degrees unless stated; distances come
out in ``radius`` units (default: Earth radius in km).
"""

import math

import torch

from ..constants import RADIUS_OF_EARTH_KM

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
    out): |set1| x |set1|, or |set1| x |set2| with two sets."""
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
