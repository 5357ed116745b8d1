"""Plain reference of the ellipse configuration in float64: the
Paciorek-Schervish covariance of per-cell ellipses (PS06 Eq. 8, Karspeck
et al. 2012 Eq. 17) with the Modified Met Office displacement, its
products with a block of columns, and ordinary kriging with the
two-stage perturbation ensemble on a factored covariance
diag(f) + V diag(g) V'.

    c_ij = s_i s_j |S_i|^1/4 |S_j|^1/4 / |(S_i + S_j) / 2|^1/2 M_nu(tau)

with S = R(theta) diag(Lx^2, Ly^2) R(theta)', tau the Mahalanobis length
of the displacement (dx, dy) under (S_i + S_j) / 2, dx the longitude
difference wrapped into [-pi, pi] and scaled by the mean of the two
cosines of latitude (the Met Office displacement leaves it unscaled),
and M_nu the Matern correlation at 2 sqrt(nu) tau. With a cutoff, a
pair whose great-circle (haversine) distance exceeds it is 0.
The wrap is taken on the difference in degrees, which is exact for grid
longitudes: a pair exactly 180 degrees apart is not wrapped (its sign
then follows the order of the pair), as the definition has it.
"""

import math

import torch

from . import kriging

RADIUS_KM = 6371.0  # the mean radius of the Earth
ROWS = 1024


def matern(x, nu):
    """The Matern correlation at x = 2 sqrt(nu) tau, in closed form."""
    if nu == 0.5:
        return torch.exp(-x)
    if nu == 1.5:
        return (1.0 + x) * torch.exp(-x)
    if nu == 2.5:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    raise ValueError(f"no closed form for nu = {nu}")


class Fields:
    """The per-cell inputs in float64: latitude and longitude (degrees),
    the ellipse (Lx, Ly in km, theta in radians) and the standard
    deviation; the configuration's cutoff (km, or None) and
    displacement."""

    def __init__(self, lat, lon, Lx, Ly, theta, stdev, max_dist_km=None,
                 delta_x_method="Modified_Met_Office"):
        if delta_x_method not in ("Modified_Met_Office", "Met_Office"):
            raise ValueError(f"unknown displacement {delta_x_method!r}")
        self.max_dist_km, self.delta_x_method = max_dist_km, delta_x_method
        f64 = dict(dtype=torch.float64)
        self.lat = torch.deg2rad(lat.to(**f64))
        self.lon = lon.to(**f64)  # degrees
        Lx, Ly, theta = Lx.to(**f64), Ly.to(**f64), theta.to(**f64)
        c, s = torch.cos(theta), torch.sin(theta)
        self.s00 = c * c * Lx * Lx + s * s * Ly * Ly
        self.s01 = c * s * (Lx * Lx - Ly * Ly)
        self.s11 = s * s * Lx * Lx + c * c * Ly * Ly
        det = self.s00 * self.s11 - self.s01 * self.s01
        self.amp = stdev.to(**f64) * det ** 0.25
        self.stdev = stdev.to(**f64)

    @property
    def n(self):
        return self.lat.shape[0]

    def rows(self, a, b, nu):
        """C[a:b, :], the diagonal included."""
        la_i, la_j = self.lat[a:b, None], self.lat[None, :]
        dx = self.lon[a:b, None] - self.lon[None, :]
        dx = torch.where(dx > 180.0, dx - 360.0, dx)
        dx = torch.where(dx < -180.0, dx + 360.0, dx)
        dlon = torch.deg2rad(dx)
        dx = RADIUS_KM * dlon
        if self.delta_x_method == "Modified_Met_Office":
            dx = dx * 0.5 * (torch.cos(la_i) + torch.cos(la_j))
        dy = RADIUS_KM * (la_i - la_j)
        s00 = 0.5 * (self.s00[a:b, None] + self.s00[None, :])
        s01 = 0.5 * (self.s01[a:b, None] + self.s01[None, :])
        s11 = 0.5 * (self.s11[a:b, None] + self.s11[None, :])
        det = s00 * s11 - s01 * s01
        tau2 = (s11 * dx * dx - 2.0 * s01 * dx * dy + s00 * dy * dy) / det
        x = 2.0 * math.sqrt(nu) * torch.sqrt(torch.clamp(tau2, min=0.0))
        c = (self.amp[a:b, None] * self.amp[None, :]) / torch.sqrt(det) \
            * matern(x, nu)
        if self.max_dist_km is not None:
            hav = torch.sin(0.5 * (la_i - la_j)) ** 2 + torch.cos(la_i) \
                * torch.cos(la_j) * torch.sin(0.5 * dlon) ** 2
            half = min(self.max_dist_km / (2.0 * RADIUS_KM), 0.5 * math.pi)
            c = torch.where(hav > math.sin(half) ** 2, 0.0, c)
        return c

    def apply(self, X, nu, rows=ROWS):
        """C @ X for X (n, k), in float64, a block of rows at a time."""
        X = X.to(torch.float64)
        out = X.new_empty((self.n, X.shape[1]))
        for a in range(0, self.n, rows):
            b = min(a + rows, self.n)
            out[a:b] = self.rows(a, b, nu) @ X
        return out


def fp8_operator(fields, nu, rows=ROWS):
    """The control's operator: the covariance without its diagonal stored
    in fp8 (e4m3, a power-of-two scale per row; every such value is exact
    in bf16, which holds it), the diagonal in f32, applied in f32. It
    stands where the program's bf16 store would."""
    n = fields.n
    store = torch.empty((n, n), dtype=torch.bfloat16, device=fields.lat.device)
    for a in range(0, n, rows):
        b = min(a + rows, n)
        C = fields.rows(a, b, nu)
        C[torch.arange(b - a, device=C.device),
          torch.arange(a, b, device=C.device)] = 0.0
        top = torch.clamp(C.abs().amax(dim=1, keepdim=True), min=1e-30)
        scale = torch.exp2(torch.ceil(torch.log2(top / 448.0)))
        q = (C / scale).float().to(torch.float8_e4m3fn).double() * scale
        store[a:b] = q.to(torch.bfloat16)
    diag = (fields.stdev ** 2).to(torch.float32)

    def matvec(x):
        x2 = x if x.dim() == 2 else x[:, None]
        x2 = x2.to(torch.float32)
        y = torch.empty_like(x2)
        for a in range(0, n, rows):
            b = min(a + rows, n)
            y[a:b] = store[a:b].float() @ x2
        y += diag[:, None] * x2
        return y if x.dim() == 2 else y[:, 0]

    return matvec


def lowrank(V, g, f, idx, y, e, z1, z2, zo):
    """Ordinary kriging and the two-stage ensemble on the factored
    covariance C = diag(f) + V diag(g) V', in the inputs' precision:
    (field, uncertainty, constraint mask, members). The states are
    x = f^1/2 z1 + V g^1/2 z2, their observations x[idx] + e^1/2 zo, and
    each member is field + C(grid, obs) K^-1 (observed state) - state."""
    Vo = V[idx]
    m = idx.shape[0]

    def cross(a, b):
        Cx = (Vo * g) @ V[a:b].T
        inside = (idx >= a) & (idx < b)
        rows = torch.nonzero(inside)[:, 0]
        Cx[rows, idx[rows] - a] += f[idx[rows]]
        return Cx

    K = (Vo * g) @ Vo.T
    K.diagonal().add_(f[idx] + e)
    c0 = f + torch.sum(V * V * g, dim=1)
    field, unc, mask = kriging.ordinary(K, cross, c0, y)
    states = torch.sqrt(f)[:, None] * z1 + V @ (torch.sqrt(g)[:, None] * z2)
    sim = states[idx] + torch.sqrt(e)[:, None] * zo
    members = field[None, :] + kriging.kriged_draws(K, cross, V.shape[0], sim) \
        - states.T
    return field, unc, mask, members
