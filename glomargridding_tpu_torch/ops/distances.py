"""Great-circle and ellipse geometry on tensors.

Port of ``glomargridding_tpu/ops/distances.py``: the pairwise distance
matrices (haversine, chordal, planar), the displacements, the 2 x 2
ellipse helpers and the Mahalanobis distances of the non-stationary
path, and the frame-level wrappers (pandas is imported inside the
functions that build a frame). Latitude/longitude are in degrees unless
stated; distances come out in ``radius`` units (default: Earth radius in
km). The matrix forms place numpy inputs by ``resolve_device``; the
elementwise forms work where their tensors live.
"""

import math

import numpy as np
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


def _pair_angle(lats1, lons1, lats2, lons2, device):
    """Central angles |set1| x |set2| (radians) of degree coordinates."""
    device = resolve_device(device, lats1, lons1, lats2, lons2)
    lats1 = torch.as_tensor(lats1, device=device)
    lons1 = torch.as_tensor(lons1, device=device)
    if lats2 is None:
        lats2, lons2 = lats1, lons1
    lats2 = torch.as_tensor(lats2, device=device)
    lons2 = torch.as_tensor(lons2, device=device)
    return _haversine_rad(radians(lats1)[:, None], radians(lons1)[:, None],
                          radians(lats2)[None, :], radians(lons2)[None, :])


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
    return radius * _pair_angle(lats1, lons1, lats2, lons2, device)


def euclidean_matrix(
    lats1,
    lons1,
    lats2=None,
    lons2=None,
    radius: float = RADIUS_OF_EARTH_KM,
    device=None,
) -> torch.Tensor:
    """Pairwise chordal ("tunnel") distance through the sphere:
    2 R sin(c / 2) of the haversine central angle c, which is stable at
    small separations. Placed as ``haversine_matrix`` places it."""
    c = _pair_angle(lats1, lons1, lats2, lons2, device)
    return 2.0 * radius * torch.sin(c / 2.0)


def cartesian_euclidean_matrix(lats1, lons1, lats2=None, lons2=None,
                               device=None) -> torch.Tensor:
    """Plain planar Euclidean distance on (lat, lon) treated as x/y, as
    ``sklearn.metrics.pairwise.euclidean_distances`` gives it."""
    device = resolve_device(device, lats1, lons1, lats2, lons2)
    lats1 = torch.as_tensor(lats1, device=device)
    lons1 = torch.as_tensor(lons1, device=device)
    lats2 = lats1 if lats2 is None else torch.as_tensor(lats2, device=device)
    lons2 = lons1 if lons2 is None else torch.as_tensor(lons2, device=device)
    dy = lats1[:, None] - lats2[None, :]
    dx = lons1[:, None] - lons2[None, :]
    return torch.sqrt(dy * dy + dx * dx)


def radial_dist(lat1, lon1, lat2, lon2, radius: float = RADIUS_OF_EARTH_KM):
    """Single-pair great-circle distance (degrees in); a 0-d tensor."""
    lat1, lon1, lat2, lon2 = (
        torch.as_tensor(a, dtype=None if isinstance(a, torch.Tensor)
                        else torch.float64)
        for a in (lat1, lon1, lat2, lon2))
    return radius * _haversine_rad(radians(lat1), radians(lon1),
                                   radians(lat2), radians(lon2))


def rot_mat(angle) -> torch.Tensor:
    """2-d rotation matrix from an angle in radians."""
    angle = torch.as_tensor(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def inv_2d(mat) -> torch.Tensor:
    """Inverse of a 2 x 2 matrix."""
    mat = torch.as_tensor(mat)
    det = mat[0, 0] * mat[1, 1] - mat[0, 1] * mat[1, 0]
    inv = torch.stack([torch.stack([mat[1, 1], -mat[0, 1]]),
                       torch.stack([-mat[1, 0], mat[0, 0]])])
    return inv / det


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


def tau_dist(dE, dN, sigma) -> torch.Tensor:
    """Mahalanobis distance sqrt(dx' Sigma^{-1} dx) for one 2 x 2 Sigma."""
    sigma = torch.as_tensor(sigma)
    dx_vec = torch.stack([torch.as_tensor(dE, dtype=sigma.dtype),
                          torch.as_tensor(dN, dtype=sigma.dtype)])
    return torch.sqrt(dx_vec @ inv_2d(sigma) @ dx_vec)


def mahal_dist_func(delta_x, delta_y, Lx, Ly, theta=None):
    """Mahalanobis tau for displacement tensors and one ellipse's
    parameters (0-d tensors or numbers):

    tau = sqrt(dx (dx si00 + dy si01) + dy (dx si10 + dy si11)) with
    si = Sigma(Lx, Ly, theta)^{-1}; elementwise, and differentiable in the
    parameters away from tau = 0.
    """
    if theta is None:
        s00, s01, s10, s11 = Lx * Lx, 0.0, 0.0, Ly * Ly
    else:
        s00, s01, s10, s11 = sigma_rot_flat(
            torch.as_tensor(Lx), torch.as_tensor(Ly), torch.as_tensor(theta))
    det = s00 * s11 - s01 * s10
    i00 = s11 / det
    i01 = -s01 / det
    i10 = -s10 / det
    i11 = s00 / det
    q = delta_x * (delta_x * i00 + delta_y * i01) + delta_y * (
        delta_x * i10 + delta_y * i11
    )
    return torch.sqrt(torch.clamp(q, min=0.0))


def tau_dist_matrix(
    lats,
    lons,
    Lx,
    Ly,
    theta,
    delta_x_method: str = "Modified_Met_Office",
    radius: float = RADIUS_OF_EARTH_KM,
    device=None,
) -> torch.Tensor:
    """Pairwise Mahalanobis tau for one set of points and a shared
    ellipse; displacements by the chosen convention, scaled to `radius`
    units. Placed as ``haversine_matrix`` places it."""
    device = resolve_device(device, lats, lons)
    lats = torch.as_tensor(lats, device=device)
    lons = torch.as_tensor(lons, device=device)
    dy, dx = displacements(lats, lons, delta_x_method=delta_x_method)
    return mahal_dist_func(radius * dx, radius * dy, Lx, Ly, theta)


# --------------------------------------------------------------------------
# Frame-level wrappers: a frame with 'lat'/'lon' columns in, numpy out
# --------------------------------------------------------------------------
def _lat_lon(df):
    if list(df.columns) != ["lat", "lon"]:
        raise ValueError("Input must only contain 'lat' and 'lon' columns")
    return (np.asarray(df["lat"], dtype=float),
            np.asarray(df["lon"], dtype=float))


def haversine_distance_from_frame(df, radius: float = RADIUS_OF_EARTH_KM,
                                  device=None) -> np.ndarray:
    """Pairwise haversine matrix from a frame with 'lat'/'lon' columns."""
    lat, lon = _lat_lon(df)
    return haversine_matrix(lat, lon, radius=radius,
                            device=device).cpu().numpy()


def euclidean_distance(df, radius: float = RADIUS_OF_EARTH_KM,
                       device=None) -> np.ndarray:
    """Pairwise chordal (tunnel) matrix from a frame with 'lat'/'lon'."""
    lat, lon = _lat_lon(df)
    return euclidean_matrix(lat, lon, radius=radius,
                            device=device).cpu().numpy()


def cartesian_euclidean_from_frame(df, device=None, **_ignored) -> np.ndarray:
    """Planar Euclidean pairwise matrix from a lat/lon frame."""
    lat, lon = _lat_lon(df)
    return cartesian_euclidean_matrix(lat, lon, device=device).cpu().numpy()


def calculate_distance_matrix(
    df,
    dist_func=haversine_distance_from_frame,
    lat_col: str = "lat",
    lon_col: str = "lon",
    **dist_kwargs,
):
    """Distance matrix from a positional frame using a distance function,
    which receives a two-column frame named lat/lon."""
    import pandas as pd

    frame = pd.DataFrame(
        {"lat": np.asarray(df[lat_col]), "lon": np.asarray(df[lon_col])}
    )
    return dist_func(frame, **dist_kwargs)


def haversine_gaussian(
    df,
    R: float = RADIUS_OF_EARTH_KM,
    r: float = 40.0,
    s: float = 0.6,
    device=None,
) -> np.ndarray:
    """Gaussian-model-weighted haversine matrix, usable as a distance
    function for within-gridbox error-covariance weighting."""
    from ..utils.frames import check_cols

    check_cols(df, ["lat", "lon"])
    lat = np.asarray(df["lat"], dtype=float)
    lon = np.asarray(df["lon"], dtype=float)
    C = haversine_matrix(lat, lon, radius=R, device=device).cpu().numpy()
    C = np.exp(-(C**2) / r**2)
    return s / 2.0 * C


# WGS84 ellipsoid (the datum behind an EPSG:4326 -> tmerc reprojection)
WGS84_A_KM = 6378.137
WGS84_F = 1.0 / 298.257223563


def tmerc_forward(
    lats_deg,
    lons_deg,
    lat0_deg: float,
    lon0_deg: float,
    k0: float = 0.9996,
    a: float = WGS84_A_KM,
    f: float = WGS84_F,
) -> tuple[np.ndarray, np.ndarray]:
    """Ellipsoidal Transverse Mercator forward projection (km), in numpy
    on the host.

    Gauss-Krueger projection via the 6th-order Krueger alpha series in
    the third flattening n (Karney 2011, "Transverse Mercator with an
    accuracy of a few nanometers"), reproducing a
    ``+proj=tmerc +lat_0=.. +lon_0=.. +k=0.9996 +units=km`` CRS without
    pyproj. Returns (easting, northing) in km with the false origin at
    (lat0, lon0): northing is measured from the lat0 parallel.
    """
    lats = np.radians(np.asarray(lats_deg, dtype=np.float64))
    lons = np.asarray(lons_deg, dtype=np.float64)
    dlam = np.radians(((lons - lon0_deg) + 180.0) % 360.0 - 180.0)

    n = f / (2.0 - f)
    n2, n3 = n * n, n**3
    n4, n5, n6 = n**4, n**5, n**6
    # rectifying radius
    A = a / (1.0 + n) * (1.0 + n2 / 4.0 + n4 / 64.0 + n6 / 256.0)
    alpha = np.array(
        [
            n / 2.0 - 2.0 * n2 / 3.0 + 5.0 * n3 / 16.0 + 41.0 * n4 / 180.0
            - 127.0 * n5 / 288.0 + 7891.0 * n6 / 37800.0,
            13.0 * n2 / 48.0 - 3.0 * n3 / 5.0 + 557.0 * n4 / 1440.0
            + 281.0 * n5 / 630.0 - 1983433.0 * n6 / 1935360.0,
            61.0 * n3 / 240.0 - 103.0 * n4 / 140.0 + 15061.0 * n5 / 26880.0
            + 167603.0 * n6 / 181440.0,
            49561.0 * n4 / 161280.0 - 179.0 * n5 / 168.0
            + 6601661.0 * n6 / 7257600.0,
            34729.0 * n5 / 80640.0 - 3418889.0 * n6 / 1995840.0,
            212378941.0 * n6 / 149968080.0,
        ]
    )
    e = math.sqrt(f * (2.0 - f))

    def _xi_eta(phi, lam):
        s = np.clip(np.sin(phi), -1.0, 1.0)
        # conformal latitude chi, as tan(chi)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        t = np.where(np.abs(s) >= 1.0, np.copysign(np.inf, s), t)
        xi_p = np.arctan2(t, np.cos(lam))
        eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
        j = np.arange(1, 7, dtype=np.float64)
        two_j_xi = 2.0 * j[:, None] * np.ravel(xi_p)[None, :]
        two_j_eta = 2.0 * j[:, None] * np.ravel(eta_p)[None, :]
        xi = np.ravel(xi_p) + alpha @ (np.sin(two_j_xi) * np.cosh(two_j_eta))
        eta = np.ravel(eta_p) + alpha @ (
            np.cos(two_j_xi) * np.sinh(two_j_eta)
        )
        return xi.reshape(np.shape(phi)), eta.reshape(np.shape(phi))

    xi, eta = _xi_eta(lats, dlam)
    xi0, _ = _xi_eta(np.asarray(math.radians(lat0_deg)), np.asarray(0.0))
    easting = k0 * A * eta
    northing = k0 * A * (xi - float(xi0))
    return easting, northing


def tau_dist_from_frame(df, displacement: str = "tmerc",
                        device=None) -> np.ndarray:
    """exp(-tau) matrix for all records within one gridbox.

    Requires columns lat/lon plus the gridbox ellipse parameters
    grid_lat/grid_lon/grid_lx/grid_ly/grid_theta (first row used: all
    records share the gridbox). ``displacement`` selects how observation
    coordinates become local northing/easting: ``"tmerc"`` (default), the
    Transverse Mercator about the gridbox centre with k = 0.9996 on
    WGS84; or ``"tangent"``, the spherical local-tangent approximation
    (within ~0.5% of tmerc at gridbox scales). The projection runs in
    numpy on the host; the pairwise Mahalanobis distance runs on `device`
    (with none, on the card) and the matrix comes back as numpy.
    """
    from ..utils.frames import check_cols

    required = ["grid_lon", "grid_lat", "grid_lx", "grid_ly", "grid_theta",
                "lat", "lon"]
    check_cols(df, required)
    lat0 = float(np.asarray(df["grid_lat"])[0])
    lon0 = float(np.asarray(df["grid_lon"])[0])
    Lx = float(np.asarray(df["grid_lx"])[0])
    Ly = float(np.asarray(df["grid_ly"])[0])
    theta = float(np.asarray(df["grid_theta"])[0])

    lats = np.asarray(df["lat"], dtype=float)
    lons = np.asarray(df["lon"], dtype=float)
    if displacement == "tmerc":
        easting, northing = tmerc_forward(lats, lons, lat0, lon0)
    elif displacement == "tangent":
        km_per_deg = RADIUS_OF_EARTH_KM * math.pi / 180.0
        northing = lats * km_per_deg
        easting = lons * km_per_deg * math.cos(math.radians(lat0))
    else:
        raise ValueError(f"unknown displacement method {displacement!r}")
    device = resolve_device(device)
    northing = torch.as_tensor(northing, device=device)
    easting = torch.as_tensor(easting, device=device)
    dN = northing[:, None] - northing[None, :]
    dE = easting[:, None] - easting[None, :]
    Lx, Ly, theta = (torch.tensor(p, dtype=dE.dtype, device=device)
                     for p in (Lx, Ly, theta))
    return torch.exp(-mahal_dist_func(dE, dN, Lx, Ly, theta)).cpu().numpy()
