"""Non-stationary (ellipse) covariance kernels K2, K3, K4: CUDA kernels
and their plain twins.

All three evaluate the Paciorek-Schervish pair function of
``glomargridding_tpu/ops/pallas/pairwise.py:_ellipse_tile_value``
(half-integer Matern closed form, zero at zero displacement, optional
haversine cutoff) on points packed by ``pack_points`` into an (n, 16)
tensor of their parameters and the per-point values the pair function
reads (``PACKED``):

- ``ellipse_tile`` (K4): the (m, n) tile C(rows, cols), no diagonal term.
  Counterpart of ``ellipse_covariance_pallas``; the row-block builds and
  the stream operator's wide applications use it.
- ``ellipse_sym`` (K2): the full C(P, P) from upper-triangle tiles, with
  diag(stdev^2), f32/f64 or a bf16 store. Counterpart of
  ``ellipse_covariance_pallas_sym``.
- ``ellipse_matvec`` (K3): y = C x without the diagonal, for x of at most
  ``MV_W`` columns, banded by per-row-block limits. Counterpart of
  ``ellipse_matvec_pallas``.

Dispatch is by the tensors' device, decided before any launch: a CUDA
tensor runs the kernel in ``csrc/ellipse_tile.cu`` (built at first use)
and a failed build or launch raises; a CPU tensor runs the plain twin
(``*_torch``), which follows ``_ellipse_tile_value`` op for op. Callers
route by ``kernel_order`` alone; what a kernel takes is stated once, by
``takes`` (K2, K4) or ``matvec_takes`` (K3), and its wrapper refuses the
rest on every device.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from ...constants import RADIUS_OF_EARTH_KM
from ...utils.device import resolve_device
from ...utils.profiling import count
from ..special import HALF_INTEGER_ORDERS, xv_kv
from . import build

TILE = 64  # the kernels' tile side (kTile in csrc/ellipse_tile.cu)
MV_W = 8  # K3's column width (kMvW)
MV_DEPTH = 16  # column blocks per K3 block (kMvDepth)
DELTA_X_METHODS = ("Met_Office", "Modified_Met_Office")

# pack_points' columns; 14 and 15 are zero
PACKED = ("lat", "lon", "s00", "s01", "s11", "sqrt_det", "stdev", "cos_lat",
          "amp", "sin_half_lat", "cos_half_lat", "sin_half_lon",
          "cos_half_lon", "cos_lat_from_half")
_WIDTH = 16
_NU_CODES = {v: code for code, v in enumerate(HALF_INTEGER_ORDERS)}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_TWO_PI = 2.0 * math.pi
# tile-sized values the general-order pair function holds (46 measured)
_GENERAL_TILE_VALUES = 48


def pack_points(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs):
    """(n, 16) packed points in ``sig_flat``'s dtype and on its device:
    lat, lon (radians), Sigma's s00, s01, s11, sqrt det Sigma, stdev, then
    the per-point values of ``_ellipse_tile_value`` (cos lat, the
    amplitude stdev * sqrt(sqrt det), and the cutoff's half-angle sines
    and cosines with cos lat = 1 - 2 sin^2(lat/2)), computed once here so
    that the kernels and the plain twins read the same values."""
    sig = torch.as_tensor(sig_flat)
    like = dict(dtype=sig.dtype, device=sig.device)
    la = torch.as_tensor(lats_rad, **like)
    lo = torch.as_tensor(lons_rad, **like)
    sd = torch.as_tensor(sqrt_dets, **like)
    sg = torch.as_tensor(stdevs, **like)
    sh = torch.sin(0.5 * la)
    columns = (la, lo, sig[:, 0], sig[:, 1], sig[:, 2], sd, sg, torch.cos(la),
               sg * torch.sqrt(sd), sh, torch.cos(0.5 * la),
               torch.sin(0.5 * lo), torch.cos(0.5 * lo), 1.0 - 2.0 * sh * sh)
    P = torch.zeros((sig.shape[0], _WIDTH), **like)
    for k, col in enumerate(columns):
        P[:, k] = col
    return P


def kernel_order(v: float) -> bool:
    """Whether the kernels have order `v` (its closed form): the route of
    every build and application, which then refuses a dtype it does not
    take (``takes``)."""
    return float(v) in _NU_CODES


def takes(v: float, dtype: torch.dtype) -> bool:
    """Whether K2 and K4 (and their plain twins) take order `v` on points
    of `dtype`."""
    return kernel_order(v) and dtype in _DTYPE_CODES


def matvec_takes(v: float, dtype: torch.dtype) -> bool:
    """Whether K3 (and its plain twin) takes order `v` on points and x of
    `dtype`."""
    return kernel_order(v) and dtype == torch.float32


def tile_pair_bytes(v: float, dtype: torch.dtype) -> int:
    """Device bytes a tile's build holds per pair: K4's one value at a
    ``kernel_order``, else the general-order pair function's values."""
    item = torch.empty((), dtype=dtype).element_size()
    return item if kernel_order(v) else item * _GENERAL_TILE_VALUES


def _require(predicate, v: float, dtype: torch.dtype) -> None:
    """Raise unless ``predicate(v, dtype)``: the Pallas wrappers'
    ``ValueError`` for an order no kernel takes, else a ``TypeError``."""
    if predicate(v, dtype):
        return
    if not kernel_order(v):
        raise ValueError("the ellipse kernels support half-integer v in "
                         f"{list(HALF_INTEGER_ORDERS)} only, got v={v}")
    raise TypeError(f"{predicate.__name__}: not {dtype} points")


def _kernel_args(v: float, delta_x_method: str, max_dist):
    """(nu code, None at an order no kernel takes; modified flag; cutoff
    km or 0.0)."""
    if delta_x_method not in DELTA_X_METHODS:
        raise ValueError(f"Unknown 'delta_x_method' value: {delta_x_method}")
    md = 0.0 if max_dist is None else float(max_dist)
    return (
        _NU_CODES.get(float(v)),
        int(delta_x_method == "Modified_Met_Office"),
        max(md, 0.0),
    )


def _check_points(*points):
    for P in points:
        if not isinstance(P, torch.Tensor):
            raise TypeError("points must be a torch tensor (pack_points)")
        if P.dim() != 2 or P.shape[1] != _WIDTH:
            raise ValueError(
                f"points must be (n, {_WIDTH}) (pack_points), got "
                f"{tuple(P.shape)}"
            )
        if not P.is_contiguous():
            raise ValueError("points must be contiguous")
    if any(P.dtype != points[0].dtype for P in points):
        raise TypeError("points must share one dtype")
    if any(P.device != points[0].device for P in points):
        raise ValueError("points must lie on one device")
    device = points[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {device}")
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------
def _matern_halfint_corr(x, nu: float):
    """e^-x poly_nu(x), the closed form of ``_matern_halfint_corr``."""
    if nu == 0.5:
        poly = 1.0
    elif nu == 1.5:
        poly = 1.0 + x
    elif nu == 2.5:
        poly = 1.0 + x + x * x / 3.0
    else:
        poly = 1.0 + x + 2.0 * x * x / 5.0 + x * x * x / 15.0
    return torch.exp(-x) * poly


def ellipse_tile_torch(
    rows, cols, v: float, delta_x_method="Modified_Met_Office",
    max_dist=None, radius=RADIUS_OF_EARTH_KM,
):
    """The plain (m, n) tile of any order from the packed columns: at an
    order the kernels take, op for op as ``_ellipse_tile_value`` (the
    closed form; a cutoff <= 0 km is none, as the kernels read it); at
    any other, op for op as the reference's jnp tile (the general-order
    K_nu; NaN and inf read as 0; any cutoff given applies)."""
    nu_code, modified, md = _kernel_args(v, delta_x_method, max_dist)
    r = {name: rows[:, k : k + 1] for k, name in enumerate(PACKED)}
    c = {name: cols[:, k][None, :] for k, name in enumerate(PACKED)}
    dy = r["lat"] - c["lat"]
    dx = r["lon"] - c["lon"]
    dx = torch.where(dx > _scalar(math.pi, dx), dx - _TWO_PI, dx)
    dx = torch.where(dx < _scalar(-math.pi, dx), dx + _TWO_PI, dx)
    if modified:
        dx = dx * (0.5 * (r["cos_lat"] + c["cos_lat"]))
    dy = radius * dy
    dx = radius * dx

    s00 = 0.5 * (r["s00"] + c["s00"])
    s01 = 0.5 * (r["s01"] + c["s01"])
    s11 = 0.5 * (r["s11"] + c["s11"])
    det_bar = s00 * s11 - s01 * s01
    r_det = torch.rsqrt(det_bar)
    amp = r["amp"] * c["amp"]
    if nu_code is None:
        amp = amp / (math.gamma(v) * (2.0 ** (v - 1.0)))
    pref = amp * r_det

    quad = (
        dx * (dx * s11 - dy * s01) + dy * (dy * s00 - dx * s01)
    ) * (r_det * r_det)
    tau = torch.sqrt(torch.clamp(quad, min=0.0))
    inner = (2.0 * math.sqrt(v)) * tau
    val = pref * (xv_kv(v, inner) if nu_code is None
                  else _matern_halfint_corr(inner, float(v)))
    out = torch.where(inner > 0.0, val, torch.zeros_like(val))
    if nu_code is None:
        out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)

    if md > 0.0 or (nu_code is None and max_dist is not None):
        out = torch.where(beyond_cutoff(rows, cols, float(max_dist), radius),
                          torch.zeros_like(out), out)
    return out


def beyond_cutoff(rows, cols, max_dist: float, radius=RADIUS_OF_EARTH_KM):
    """The (len(rows), len(cols)) mask of pairs farther apart than
    `max_dist` km, as the kernels classify them: haversine-a from the
    packed half-angle values, one rounding per operation, against
    sin^2 of the half angle rounded to the points' dtype."""
    half = min(max_dist / (2.0 * radius), 0.5 * math.pi)
    r = {name: rows[:, k : k + 1] for k, name in enumerate(PACKED)}
    c = {name: cols[:, k][None, :] for k, name in enumerate(PACKED)}
    sdlat = (r["sin_half_lat"] * c["cos_half_lat"]
             - r["cos_half_lat"] * c["sin_half_lat"])
    sdlon = (r["sin_half_lon"] * c["cos_half_lon"]
             - r["cos_half_lon"] * c["sin_half_lon"])
    cl = r["cos_lat_from_half"] * c["cos_lat_from_half"]
    a = sdlat * sdlat + cl * (sdlon * sdlon)
    return a > _scalar(math.sin(half) ** 2, a)


def _scalar(value: float, like):
    """A Python float rounded to `like`'s dtype, as the kernels round
    their scalars (and as a weakly typed float meets an array in JAX)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def ellipse_sym_torch(
    P, v: float, delta_x_method="Modified_Met_Office", max_dist=None,
    out_dtype=None, add_diag: bool = True, keep_pad: bool = False,
):
    """The plain K2: the full tile, diag(stdev^2) added on the diagonal,
    rounded once to `out_dtype`, zero-padded to the tile multiple when
    `keep_pad`."""
    C = ellipse_tile_torch(P, P, v, delta_x_method, max_dist)
    if add_diag:
        C.diagonal().add_(P[:, 6] * P[:, 6])
    C = C.to(out_dtype or P.dtype)
    if keep_pad:
        n_pad = _padded(P.shape[0])
        C = torch.nn.functional.pad(
            C, (0, n_pad - C.shape[1], 0, n_pad - C.shape[0])
        )
    return C


def band_limits(hi, n: int, device):
    """(nb,) int32 band limits on `device` (None: unbanded) and the depth
    max(hi[i] - i) + 1; raises unless i <= hi[i] < nb."""
    nb = -(-n // TILE)
    hi = (
        np.full(nb, nb - 1, np.int32) if hi is None
        else np.asarray(torch.as_tensor(hi).cpu(), np.int64)
    )
    rows = np.arange(nb)
    if hi.shape != (nb,) or (hi < rows).any() or (hi >= nb).any():
        raise ValueError(f"hi must be ({nb},) with i <= hi[i] < {nb}")
    depth = int((hi - rows).max()) + 1
    return torch.as_tensor(hi.astype(np.int32), device=device), depth


def ellipse_matvec_torch(
    P, x, hi, v: float, delta_x_method="Modified_Met_Office", max_dist=None,
):
    """The plain K3: each row block's band of tiles at once, applied as
    y_I += T x_J over j >= i and y_J += T' x_I over j > i."""
    n = P.shape[0]
    hi_t, _ = band_limits(hi, n, "cpu")
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for i, last in enumerate(hi_t.tolist()):
        r0, r1 = i * TILE, min((i + 1) * TILE, n)
        c1 = min((last + 1) * TILE, n)
        T = ellipse_tile_torch(P[r0:r1], P[r0:c1], v, delta_x_method,
                               max_dist)
        y[r0:r1] += T @ x[r0:c1]
        if c1 > r1:
            y[r1:c1] += T[:, r1 - r0 :].T @ x[r0:r1]
    return y


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain twin for CPU tensors
# ---------------------------------------------------------------------------
def ellipse_tile(
    rows, cols, v: float, delta_x_method="Modified_Met_Office",
    max_dist=None, out=None,
):
    """K4: the (len(rows), len(cols)) tile C(rows, cols), no diagonal.

    `out`, when given, is a contiguous (m, n) tensor of the points' dtype
    that receives the tile (a reused workspace).
    """
    on_card = _check_points(rows, cols)
    _require(takes, v, rows.dtype)
    args = _kernel_args(v, delta_x_method, max_dist)
    m, n = rows.shape[0], cols.shape[0]
    if out is None:
        out = torch.empty((m, n), dtype=rows.dtype, device=rows.device)
    elif (out.shape != (m, n) or out.dtype != rows.dtype
          or out.device != rows.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (m, n) tensor like rows")
    if not on_card:
        return out.copy_(
            ellipse_tile_torch(rows, cols, v, delta_x_method, max_dist)
        )
    if m == 0 or n == 0:
        return out
    nu, modified, md = args
    with torch.cuda.device(rows.device):
        status = _library().ellipse_tile_launch(
            _DTYPE_CODES[rows.dtype], nu, modified, md, RADIUS_OF_EARTH_KM,
            float(v), rows.data_ptr(), m, cols.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"ellipse_tile_launch failed with cudaError {status} "
            f"(m={m}, n={n}, dtype={rows.dtype}, v={v})"
        )
    count("k4.launches")
    return out


def ellipse_sym(
    P, v: float, delta_x_method="Modified_Met_Office", max_dist=None,
    out_dtype=None, add_diag: bool = True, keep_pad: bool = False,
):
    """K2: the (n, n) covariance C(P, P) from upper-triangle tiles.

    Adds diag(stdev^2) unless ``add_diag=False``. ``out_dtype`` (default
    the points' dtype) may be ``torch.bfloat16`` for f32 points: the f32
    tile is rounded once, at the store. ``keep_pad=True`` returns the
    (n_pad, n_pad) matrix, n_pad the next multiple of ``TILE``, whose
    padded rows and columns are exact zeros.
    """
    on_card = _check_points(P)
    _require(takes, v, P.dtype)
    nu, modified, md = _kernel_args(v, delta_x_method, max_dist)
    out_dtype = out_dtype or P.dtype
    if out_dtype not in (P.dtype, torch.bfloat16) or (
        out_dtype == torch.bfloat16 and P.dtype != torch.float32
    ):
        raise TypeError(f"out_dtype {out_dtype} for {P.dtype} points")
    if not on_card:
        return ellipse_sym_torch(P, v, delta_x_method, max_dist, out_dtype,
                                 add_diag, keep_pad)
    n = P.shape[0]
    ld = _padded(n) if keep_pad else n
    out = torch.empty((ld, ld), dtype=out_dtype, device=P.device)
    if n == 0:
        return out
    with torch.cuda.device(P.device):
        status = _library().ellipse_sym_launch(
            _DTYPE_CODES[P.dtype], int(out_dtype == torch.bfloat16), nu,
            modified, md, RADIUS_OF_EARTH_KM, float(v), P.data_ptr(), n,
            out.data_ptr(), ld, int(add_diag),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"ellipse_sym_launch failed with cudaError {status} "
            f"(n={n}, dtype={P.dtype}, out_dtype={out_dtype}, v={v})"
        )
    count("k2.launches")
    return out


def ellipse_matvec(
    P, x, hi=None, v: float = 0.5, delta_x_method="Modified_Met_Office",
    max_dist=None,
):
    """K3: y = C x without the diagonal, f32, x of shape (n, w <= MV_W).

    `hi` is the (ceil(n / TILE),) per-row-block upper band limit (the
    last column block j >= i whose tile can be nonzero; None: unbanded).
    On the card the blocks add their partial sums with atomics, so the
    result agrees with the plain twin to rounding, not bit for bit. The
    grid bounds the band depth at 65,535 * MV_DEPTH blocks.
    """
    on_card = _check_points(P)
    _require(matvec_takes, v, P.dtype)
    nu, modified, md = _kernel_args(v, delta_x_method, max_dist)
    n = P.shape[0]
    if x.dtype != P.dtype:
        raise TypeError("the fused matvec is float32")
    if x.dim() != 2 or x.shape[0] != n or x.shape[1] > MV_W:
        raise ValueError(
            f"x must be (n, <= {MV_W}), got {tuple(x.shape)} for n={n}"
        )
    if x.device != P.device:
        raise ValueError("x and the points must lie on one device")
    if not on_card:
        return ellipse_matvec_torch(P, x, hi, v, delta_x_method, max_dist)
    if n == 0:
        return torch.zeros_like(x)
    hi_t, depth = band_limits(hi, n, P.device)
    if -(-depth // MV_DEPTH) > 65535:
        raise ValueError(f"band depth {depth} exceeds the kernel's grid")
    n_pad = _padded(n)
    xp = torch.zeros((n_pad, MV_W), dtype=torch.float32, device=P.device)
    xp[:n, : x.shape[1]] = x
    y = torch.zeros_like(xp)
    with torch.cuda.device(P.device):
        status = _library().ellipse_matvec_launch(
            nu, modified, md, RADIUS_OF_EARTH_KM, float(v), P.data_ptr(), n,
            hi_t.data_ptr(), depth, xp.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"ellipse_matvec_launch failed with cudaError {status} "
            f"(n={n}, depth={depth}, v={v})"
        )
    count("k3.launches")
    return y[:n, : x.shape[1]]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load_library("ellipse_tile")
    i, d, p, n = ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64
    signatures = {
        "ellipse_tile_launch": [i, i, i, d, d, d, p, n, p, n, p, p],
        "ellipse_sym_launch": [i, i, i, i, d, d, d, p, n, p, n, i, p],
        "ellipse_matvec_launch": [i, i, d, d, d, p, n, p, n, p, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    geometry = {"ellipse_tile_side": TILE, "ellipse_matvec_width": MV_W,
                "ellipse_matvec_depth": MV_DEPTH}
    for name, value in geometry.items():
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != value:
            raise RuntimeError(f"csrc/ellipse_tile.cu and {name} disagree")
    return lib


def ellipse_covariance_cuda(
    lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs, v: float = 0.5,
    delta_x_method="Modified_Met_Office", max_dist: float = 0.0,
    device=None,
):
    """Counterpart of ``ellipse_covariance_pallas``, with its signature:
    K4 over all tiles, then diag(stdev^2). Runs on `device`: by default
    that of a tensor input, else the card (``resolve_device``)."""
    device = resolve_device(device, sig_flat, lats_rad, lons_rad, sqrt_dets,
                            stdevs)
    P = pack_points(lats_rad, lons_rad, torch.as_tensor(sig_flat,
                                                        device=device),
                    sqrt_dets, stdevs)
    C = ellipse_tile(P, P, v, delta_x_method, max_dist)
    C.diagonal().add_(P[:, 6] * P[:, 6])
    return C


__all__ = [
    "DELTA_X_METHODS",
    "MV_W",
    "PACKED",
    "TILE",
    "band_limits",
    "beyond_cutoff",
    "ellipse_covariance_cuda",
    "ellipse_matvec",
    "ellipse_matvec_torch",
    "ellipse_sym",
    "ellipse_sym_torch",
    "ellipse_tile",
    "ellipse_tile_torch",
    "kernel_order",
    "matvec_takes",
    "pack_points",
    "takes",
    "tile_pair_bytes",
]
