r"""Spherical-harmonic sampling of stationary Gaussian fields, on tensors.

Port of ``glomargridding_tpu/ops/sphere.py``. An isotropic correlation on
the sphere is diagonal in spherical harmonics,

.. math::
    corr(\gamma) = \sum_l \frac{2l+1}{4\pi} \hat c_l P_l(\cos\gamma),

so a field whose coefficients over an orthonormal real harmonic basis are
independent, :math:`a_{lm} \sim N(0, \hat c_l)`, has covariance exactly
:math:`corr(\gamma(x, y))` (the addition theorem). On a regular lat-lon
grid the synthesis is two dense products in true f32: one batched over m
(coefficients against the Legendre table) and one against cos/sin tables
over longitude. Truncation at l_max drops the spectrum's tail; the
retained fraction is ``truncation_fraction``. The angular power comes
from Gauss-Legendre quadrature of the correlation, so any isotropic
correlation works.

The host functions (``angular_power``, ``legendre_table``,
``dft_tables``, ``matern_correlation``) are numpy/scipy copies of the
reference's. ``_legendre_table_device`` builds the table on the device
with the reference's f32-safe carry. ``jax.random`` keys become
``generator=`` or injected normals (``noise=``); ``member_batch`` only
bounds how many members are synthesised at once.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device


def angular_power(corr_fn, l_max: int, n_quad: int = 2048) -> np.ndarray:
    r"""Angular power spectrum \hat c_l of an isotropic correlation.

    `corr_fn(gamma)` takes central angles in radians (vectorised numpy).
    Returns \hat c_l for l = 0..l_max by Gauss-Legendre quadrature:
    \hat c_l = 2 pi \int_{-1}^{1} corr(acos t) P_l(t) dt.
    """
    from scipy.special import roots_legendre

    t, w = roots_legendre(n_quad)
    gamma = np.arccos(np.clip(t, -1.0, 1.0))
    f = np.asarray(corr_fn(gamma), dtype=np.float64)

    # Legendre recurrence over the quadrature nodes
    c = np.empty(l_max + 1)
    p_prev = np.ones_like(t)
    p_cur = t.copy()
    c[0] = 2.0 * np.pi * np.sum(w * f * p_prev)
    if l_max >= 1:
        c[1] = 2.0 * np.pi * np.sum(w * f * p_cur)
    for l in range(2, l_max + 1):
        p_next = ((2 * l - 1) * t * p_cur - (l - 1) * p_prev) / l
        c[l] = 2.0 * np.pi * np.sum(w * f * p_next)
        p_prev, p_cur = p_cur, p_next
    # tiny negative values are quadrature noise
    return np.maximum(c, 0.0)


def legendre_table(l_max: int, lats_deg) -> np.ndarray:
    r"""Orthonormal associated Legendre functions at given latitudes
    (host, f64).

    Returns (l_max+1, l_max+1, n_lat) with entry [l, m, j] =
    :math:`\tilde P_l^m(\sin(lat_j))`, normalised so that the real
    harmonics {P̃_l0, sqrt(2) P̃_lm cos(m lam), sqrt(2) P̃_lm sin(m lam)}
    are orthonormal on the sphere: the diagonal, then upward recurrence
    in l.
    """
    x = np.sin(np.radians(np.asarray(lats_deg, dtype=np.float64)))
    sx = np.sqrt(np.maximum(1.0 - x * x, 0.0))  # cos(lat)
    P = np.zeros((l_max + 1, l_max + 1, x.shape[0]))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, l_max + 1):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * sx * P[m - 1, m - 1]
    for m in range(0, l_max):
        P[m + 1, m] = x * np.sqrt(2 * m + 3.0) * P[m, m]
    for l in range(2, l_max + 1):
        m = np.arange(0, l - 1)
        a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))[:, None]
        b = np.sqrt(
            ((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0)
        )[:, None]
        P[l, : l - 1] = a * (
            x[None, :] * P[l - 1, : l - 1] - b * P[l - 2, : l - 1]
        )
    return P


def _legendre_table_device(x: torch.Tensor, l_max: int) -> torch.Tensor:
    r"""The P̃_l^m table of ``legendre_table``, built on x's device in x's
    dtype from x = sin(lat), (n_lat,): a loop over l, so that only the
    (n_lat,) vector crosses to the device.

    Two f32 hazards shape it, as in the reference:

    1. *Underflow.* P̃_m^m ~ cos(lat)^m falls below the f32 minimum long
       before the recurrence regrows O(1) values at l >> m, so each
       (m, lat) lane carries a mantissa pair (p_prev, p_cur) and an
       integer count k of rescales by 2^40: the value is p 2^(40 k).
    2. *Approximate transcendentals.* Nothing approximate touches the
       carry: rescales multiply by the exact constants 2^±40, and
       ``exp2(40 k)`` is applied only when a row is emitted.
    """
    dtype, device = x.dtype, x.device
    L = l_max
    J = x.shape[0]
    sx = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))  # cos(lat)
    up = 2.0**40
    dn = 2.0**-40

    # diagonal seeds P̃_m^m = prod_k -sqrt((2k+1)/(2k)) cos(lat), as an
    # exactly rescaled product chain (value = d_p 2^(40 d_k))
    mf = torch.arange(1, L + 1, dtype=dtype, device=device)
    diag_coef = -torch.sqrt((2.0 * mf + 1.0) / (2.0 * mf))
    diag_p = torch.empty((L + 1, J), dtype=dtype, device=device)
    diag_k = torch.zeros((L + 1, J), dtype=torch.int32, device=device)
    diag_p[0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, L + 1):
        pd = diag_coef[m - 1] * sx * diag_p[m - 1]
        shrink = torch.abs(pd) < dn
        diag_p[m] = torch.where(shrink, pd * up, pd)
        diag_k[m] = diag_k[m - 1] - shrink.to(torch.int32)

    # the recurrence coefficients of every step at once, in x's dtype;
    # lanes m >= l are NaN/inf and are overwritten below
    lf = torch.arange(1, L + 1, dtype=dtype, device=device)[:, None]
    m_arr = torch.arange(L + 1, dtype=dtype, device=device)
    a_tab = torch.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - m_arr * m_arr))
    b_tab = torch.sqrt(((lf - 1.0) ** 2 - m_arr * m_arr)
                       / (4.0 * (lf - 1.0) ** 2 - 1.0))
    m_col = m_arr[:, None]

    table = torch.empty((L + 1, L + 1, J), dtype=dtype, device=device)
    # carry: mantissa rows P[l-1], P[l] and their shared rescale count
    p_prev = torch.zeros((L + 1, J), dtype=dtype, device=device)
    p_cur = torch.zeros((L + 1, J), dtype=dtype, device=device)
    p_cur[0] = diag_p[0]
    k = torch.zeros((L + 1, J), dtype=torch.int32, device=device)
    table[0] = p_cur
    for l in range(1, L + 1):
        p_next = a_tab[l - 1][:, None] * (
            x[None, :] * p_cur - b_tab[l - 1][:, None] * p_prev)
        # inject the diagonal at m == l and zero m > l BEFORE the rescale
        # tests, so that the NaN lanes never reach the shared state
        is_diag = m_col == l
        valid = m_col <= l
        p_next = torch.where(is_diag, diag_p[l][None, :], p_next)
        p_next = torch.where(valid, p_next, 0.0)
        p_cur = torch.where(is_diag, 0.0, p_cur)
        k = torch.where(is_diag, diag_k[l][None, :], k)
        k = torch.where(valid, k, 0)
        # exact power-of-two renormalisation of the pair (shared k)
        mag = torch.maximum(torch.abs(p_next), torch.abs(p_cur))
        grow = mag > up
        shrink = (mag > 0.0) & (mag < dn)
        f = torch.where(grow, dn, torch.where(shrink, up, 1.0)).to(dtype)
        p_prev, p_cur = p_cur * f, p_next * f
        k = k + grow.to(torch.int32) - shrink.to(torch.int32)
        table[l] = p_cur * torch.exp2(40.0 * k.to(dtype))
    return table


def dft_tables(l_max: int, lons_deg) -> np.ndarray:
    r"""cos/sin synthesis matrices over the grid longitudes: (2, l_max+1,
    n_lon) f64 with cos(m lam_q) and sin(m lam_q).

    The angles m lam_q are reduced mod 2 pi in f64 on the host: at l_max
    ~ 700 they reach ~5e3 rad, where an f32 reduction on the device would
    cost ~1e-4 of accuracy.
    """
    lam = np.radians(np.asarray(lons_deg, dtype=np.float64))
    theta = np.mod(np.arange(l_max + 1)[:, None] * lam[None, :],
                   2.0 * np.pi)
    return np.stack([np.cos(theta), np.sin(theta)])


def _synthesize(c_l, P_table, trig, z_cos, z_sin):
    """Fields (members, lat, lon) from standard-normal coefficients
    `z_cos`, `z_sin` (members, L+1, L+1).

    f[k, j, q] = sum_m w_m (h_cos[k, m, j] cos(m lam_q)
    + h_sin[k, m, j] sin(m lam_q)), h[k, m, j] = sum_l a[k, l, m]
    P̃_lm(lat_j), with w_0 = 1 and w_m = sqrt(2) (the real harmonics'
    normalisation) and the m > l triangle zeroed.
    """
    L = c_l.shape[0] - 1
    dtype, device = P_table.dtype, P_table.device
    std = torch.sqrt(c_l)[None, :, None]
    lm_valid = (torch.arange(L + 1, device=device)[:, None]
                >= torch.arange(L + 1, device=device)[None, :]).to(dtype)
    a_cos = z_cos * std * lm_valid
    a_sin = z_sin * std * lm_valid
    h_cos = torch.einsum("klm,lmj->kmj", a_cos, P_table)
    h_sin = torch.einsum("klm,lmj->kmj", a_sin, P_table)
    weights = torch.full((L + 1,), np.sqrt(2.0), dtype=dtype, device=device)
    weights[0] = 1.0
    weights = weights[None, :, None]
    return (torch.einsum("kmj,mq->kjq", h_cos * weights, trig[0])
            + torch.einsum("kmj,mq->kjq", h_sin * weights, trig[1]))


class SphericalHarmonicSampler:
    """Exact stationary-field sampler on a regular lat-lon grid.

    Parameters
    ----------
    corr_fn : callable
        Isotropic correlation of the central angle (radians),
        numpy-vectorised; corr_fn(0) should be 1.
    variance : float
        Point variance (psill) scaling the field.
    lats_deg, lons_deg : array
        Regular grid axes (longitudes equally spaced over the circle).
    l_max : int | None
        Spectral truncation; default min(3 * n_lat, 720).
    nugget : float
        Independent white-noise variance added per grid point.
    member_batch : int
        Members synthesised at once: it bounds the (members, L+1, L+1)
        coefficient tensors. Draws do not depend on it.
    table : str
        "device" (default) builds the Legendre table on the device
        (``_legendre_table_device``); "host" computes it in f64 numpy
        (the oracle) and copies it over.
    device :
        Where the tables live and the draws are made; by default the
        card (``resolve_device``).
    """

    def __init__(
        self,
        corr_fn,
        variance: float,
        lats_deg,
        lons_deg,
        l_max: int | None = None,
        nugget: float = 0.0,
        n_quad: int = 4096,
        dtype=torch.float32,
        member_batch: int = 64,
        table: str = "device",
        device=None,
    ):
        self.device = resolve_device(device)
        lats_deg = np.asarray(lats_deg)
        lons_deg = np.asarray(lons_deg)
        self.n_lat = len(lats_deg)
        self.n_lon = len(lons_deg)
        if l_max is None:
            l_max = min(3 * self.n_lat, 720)
        self.l_max = l_max
        self.variance = float(variance)
        self.nugget = float(nugget)

        c_l = angular_power(corr_fn, l_max, n_quad)
        total = np.sum((2 * np.arange(l_max + 1) + 1) * c_l) / (4 * np.pi)
        # corr_fn(0) is the continuum's full variance; the truncated
        # series reproduces `total` of it
        self.truncation_fraction = float(total / corr_fn(np.zeros(1))[0])
        self.c_l = torch.as_tensor(variance * c_l, dtype=dtype,
                                   device=self.device)
        if table == "device":
            x = torch.as_tensor(np.sin(np.radians(lats_deg)), dtype=dtype,
                                device=self.device)
            self.P_table = _legendre_table_device(x, l_max)
        elif table == "host":
            self.P_table = torch.as_tensor(legendre_table(l_max, lats_deg),
                                           dtype=dtype, device=self.device)
        else:
            raise ValueError(
                f"table must be 'device' or 'host', got {table!r}")
        self.trig = torch.as_tensor(dft_tables(l_max, lons_deg), dtype=dtype,
                                    device=self.device)
        self._dtype = dtype
        self.member_batch = int(member_batch)

    def _shapes(self, n_members):
        """Shapes of the normals of `n_members` draws: the cos and sin
        coefficients, and with a nugget the per-cell nugget normals."""
        L1, M = self.l_max + 1, self.n_lat * self.n_lon
        shapes = [(n_members, L1, L1)] * 2
        return shapes + [(n_members, M)] if self.nugget > 0.0 else shapes

    def _drawn(self, n_members, generator):
        """Normals for `n_members` draws from `generator`, one member at a
        time (cos, sin, nugget), so that no draw depends on how members
        are batched."""
        out = [torch.empty(s, dtype=self._dtype, device=self.device)
               for s in self._shapes(n_members)]
        for i in range(n_members):
            for z in out:
                z[i] = torch.randn(z.shape[1:], dtype=self._dtype,
                                   device=self.device, generator=generator)
        return out

    def draw(self, n_members: int, generator=None, noise=None):
        """(n_members, n_lat * n_lon) stationary field draws.

        The standard normals come from `generator` (a ``torch.Generator``
        on the sampler's device), or are given as `noise`: the cos and sin
        coefficients, each (n_members, L+1, L+1), and with a nugget the
        (n_members, n_lat * n_lon) nugget normals. From a generator they
        are drawn a batch of ``member_batch`` members at a time.
        """
        shapes = self._shapes(n_members)
        if noise is not None:
            if len(noise) != len(shapes):
                raise ValueError(f"noise must hold {len(shapes)} arrays")
            noise = [torch.as_tensor(z, dtype=self._dtype, device=self.device)
                     for z in noise]
            for z, s in zip(noise, shapes):
                if tuple(z.shape) != s:
                    raise ValueError(f"noise has shape {tuple(z.shape)}, "
                                     f"expected {s}")
        B = self.member_batch
        out = []
        for s in range(0, n_members, B):
            k = min(B, n_members - s)
            z = (self._drawn(k, generator) if noise is None
                 else [a[s:s + k] for a in noise])
            f = _synthesize(self.c_l, self.P_table, self.trig, z[0],
                            z[1]).reshape(k, self.n_lat * self.n_lon)
            if self.nugget > 0.0:
                f = f + math.sqrt(self.nugget) * z[2]
            out.append(f)
        return torch.cat(out)


def matern_correlation(nu: float, range_km: float, radius_km: float = 6371.0):
    """Isotropic Matern correlation of the central angle (sklearn form):
    a numpy-vectorised gamma -> corr function for
    ``SphericalHarmonicSampler`` (great-circle distance = radius * gamma).
    """
    from scipy.special import gamma as sgamma
    from scipy.special import kv as skv

    def corr(gamma):
        d = radius_km * np.asarray(gamma, dtype=np.float64)
        inner = np.sqrt(2.0 * nu) * d / range_km
        with np.errstate(invalid="ignore", over="ignore"):
            out = (
                (2.0 ** (1.0 - nu) / sgamma(nu))
                * np.power(inner, nu)
                * skv(nu, inner)
            )
        out = np.where(inner == 0.0, 1.0, out)
        return np.nan_to_num(out, nan=0.0)

    return corr
