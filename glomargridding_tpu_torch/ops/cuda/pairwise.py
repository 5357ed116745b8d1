"""Stationary pairwise covariance tile (K1): CUDA kernel and plain twin.

``pairwise_covariance`` is the tile every kriging step uses: row points
(la1, lo1) against column points (la2, lo2), radians in, an (M, N)
row-major tile of ``variance - gamma(d)`` out. It is the counterpart of
``_VariogramKernel.__call__`` + ``_vario_kernel(fused=True)``
(``glomargridding_tpu/models/kernel_kriging.py:78-105``) and of the
Pallas kernel ``matern_covariance_pallas``
(``glomargridding_tpu/ops/pallas/pairwise.py:102-168``).

Dispatch is by the tensors' device and the variogram, decided before any
launch (``tile_route``): a CUDA tensor goes to the hand-written kernel
(``csrc/pairwise_tile.cu``), built at first use, and a CPU tensor to
``pairwise_covariance_torch``, the plain PyTorch version of the same
function. The kernel has templates for the Matern orders of
``ops.special.HALF_INTEGER_ORDERS`` and the other families; a Matern
order outside them takes the
plain tile on the card too (general-order K_nu, ``ops/special``), as the
reference sends such orders to its jnp tile
(``glomargridding_tpu/ops/pallas/pairwise.py:19``). That route is chosen
from nu alone and counted (``COUNTS["k1.plain_tiles"]``). It is
not a fallback: a kernel that fails to build or launch raises.
"""

import ctypes
import functools

import torch

from ...constants import RADIUS_OF_EARTH_KM
from ..distances import asin_poly, degrees, radians
from ...utils.profiling import count
from ..special import HALF_INTEGER_ORDERS
from ..variogram import MaternVariogram, Variogram, matern_left, matern_scale
from . import build

DISTANCES = ("haversine", "chordal", "cartesian")
TILE_N = 128  # the kernel's f32 column tile (kTileN in csrc/pairwise_tile.cu)

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_DISTANCE_CODES = {name: i for i, name in enumerate(DISTANCES)}
_MATERN_ORDERS = {nu: code for code, nu in enumerate(HALF_INTEGER_ORDERS)}
_FAMILY_CODES = {"exponential": 4, "gaussian": 5, "spherical": 6}


def _check_inputs(la1, lo1, la2, lo2, distance):
    if distance not in DISTANCES:
        raise ValueError(f"Unknown distance: {distance}")
    coords = (la1, lo1, la2, lo2)
    if not all(isinstance(c, torch.Tensor) for c in coords):
        raise TypeError("coordinates must be torch tensors")
    if any(c.dim() != 1 for c in coords):
        raise ValueError("coordinates must be 1-D")
    if la1.shape != lo1.shape or la2.shape != lo2.shape:
        raise ValueError(
            f"lat/lon lengths differ: {tuple(la1.shape)} vs "
            f"{tuple(lo1.shape)}, {tuple(la2.shape)} vs {tuple(lo2.shape)}"
        )
    if la1.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or float64, got {la1.dtype}")
    if any(c.dtype != la1.dtype for c in coords):
        raise TypeError("coordinates must share one dtype")
    if any(c.device != la1.device for c in coords):
        raise ValueError("coordinates must lie on one device")
    if not all(c.is_contiguous() for c in coords):
        raise ValueError("coordinates must be contiguous")


def tile_route(variogram: Variogram) -> str:
    """"kernel" (K1) or "plain" (``pairwise_covariance_torch``): the route
    of a CUDA tile, from the variogram alone."""
    if variogram.kind == "matern" and float(variogram.nu) not in (
            _MATERN_ORDERS):
        return "plain"
    return "kernel"


def launch_args(variogram: Variogram, distance: str, variance, radius):
    """(distance code, family code, scalar arguments) for the kernel.

    Raises ``NotImplementedError`` for a Matern order the kernel has no
    template for.
    """
    if variogram.kind == "matern":
        nu = float(variogram.nu)
        if tile_route(variogram) == "plain":
            raise NotImplementedError(
                f"the CUDA tile covers Matern nu in {list(HALF_INTEGER_ORDERS)}"
                f", got nu={nu}"
            )
        family = _MATERN_ORDERS[nu]
        scale = matern_scale(nu, variogram.method.lower())
        left = matern_left(nu)
    elif variogram.kind in _FAMILY_CODES:
        family = _FAMILY_CODES[variogram.kind]
        scale = left = 0.0
    else:
        raise ValueError(f"Unknown variogram kind: {variogram.kind}")
    scalars = (
        float(variogram.psill),
        float(variogram.nugget),
        float(variogram.range),
        float(variance),
        float(radius),
        scale,
        left,
    )
    return _DISTANCE_CODES[distance], family, scalars


def pairwise_covariance_torch(
    la1, lo1, la2, lo2, variogram: Variogram, distance="haversine",
    variance=None, radius=RADIUS_OF_EARTH_KM,
):
    """The plain PyTorch tile, op for op as the reference's jnp tile."""
    if variance is None:
        variance = variogram.psill + variogram.nugget
    if distance == "cartesian":
        dy = degrees(la1[:, None] - la2[None, :])
        dx = degrees(lo1[:, None] - lo2[None, :])
        d = torch.sqrt(dy * dy + dx * dx)
    else:
        a = (
            torch.sin((la1[:, None] - la2[None, :]) / 2.0) ** 2
            + torch.cos(la1)[:, None]
            * torch.cos(la2)[None, :]
            * torch.sin((lo1[:, None] - lo2[None, :]) / 2.0) ** 2
        )
        a = torch.clamp(a, 0.0, 1.0)
        if distance == "chordal":
            d = 2.0 * radius * torch.sqrt(a)
        elif distance == "haversine":
            d = 2.0 * radius * asin_poly(torch.sqrt(a))
        else:
            raise ValueError(f"Unknown distance: {distance}")
    return variance - variogram._kernel(d)


def pairwise_covariance(
    la1, lo1, la2, lo2, variogram: Variogram, distance="haversine",
    variance=None, radius=RADIUS_OF_EARTH_KM,
):
    """(len(la1), len(la2)) covariance tile, radians in.

    CUDA tensors run the hand-written kernel, or the plain tile for a
    Matern order it has no template for (``tile_route``); CPU tensors run
    ``pairwise_covariance_torch``. `variance` defaults to the sill.
    """
    _check_inputs(la1, lo1, la2, lo2, distance)
    if variance is None:
        variance = variogram.psill + variogram.nugget
    if la1.device.type == "cpu":
        return pairwise_covariance_torch(
            la1, lo1, la2, lo2, variogram, distance, variance, radius
        )
    if la1.device.type != "cuda":
        raise ValueError(f"unsupported device: {la1.device}")
    if tile_route(variogram) == "plain":
        count("k1.plain_tiles")
        return pairwise_covariance_torch(
            la1, lo1, la2, lo2, variogram, distance, variance, radius
        )
    return _launch(la1, lo1, la2, lo2, variogram, distance, variance, radius)


def _launch(la1, lo1, la2, lo2, variogram, distance, variance, radius):
    dist_code, family, scalars = launch_args(
        variogram, distance, variance, radius
    )
    m, n = la1.shape[0], la2.shape[0]
    out = torch.empty((m, n), dtype=la1.dtype, device=la1.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(la1.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.pairwise_tile_launch(
            _DTYPE_CODES[la1.dtype], dist_code, family,
            la1.data_ptr(), lo1.data_ptr(), la2.data_ptr(), lo2.data_ptr(),
            m, n, out.data_ptr(), *scalars, stream,
        )
    if status != 0:
        raise RuntimeError(
            f"pairwise_tile_launch failed with cudaError {status} "
            f"(m={m}, n={n}, dtype={la1.dtype}, distance={distance}, "
            f"family={family})"
        )
    count("k1.launches")
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load_library("pairwise_tile")
    fn = lib.pairwise_tile_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int64] * 2
        + [ctypes.c_void_p]
        + [ctypes.c_double] * 7
        + [ctypes.c_void_p]
    )
    lib.pairwise_tile_cols.restype = ctypes.c_int
    if lib.pairwise_tile_cols() != TILE_N:
        raise RuntimeError("csrc/pairwise_tile.cu and TILE_N disagree")
    return lib


def matern_covariance_cuda(
    lats1, lons1, lats2, lons2, nu: float = 0.5, psill: float = 1.0,
    range_km: float = 1200.0, radius: float = RADIUS_OF_EARTH_KM,
):
    """Counterpart of ``matern_covariance_pallas``: degrees in, the
    haversine sklearn-convention half-integer Matern tile psill * corr
    out (variance = psill, no nugget)."""
    vario = MaternVariogram(psill=psill, nugget=0.0, range=range_km, nu=nu)
    return pairwise_covariance(
        radians(lats1), radians(lons1), radians(lats2), radians(lons2),
        vario, "haversine", variance=psill, radius=radius,
    )


__all__ = [
    "DISTANCES",
    "TILE_N",
    "launch_args",
    "matern_covariance_cuda",
    "pairwise_covariance",
    "pairwise_covariance_torch",
    "tile_route",
]
