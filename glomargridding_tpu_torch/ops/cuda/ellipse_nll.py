"""The ellipse fit's Fisher-z objective over a stacked call of points (K5):
the CUDA kernel's wrapper.

``fisher_z_nll(points, X, z_y, w, mask, v=, fit_sigma=)`` is
``EllipseModel._nll_fit_z`` of every point of a (K, B, d) stack and every
lane of its (B, N) training data, as ``ops.optim.stacked_objective``
lifts it with ``torch.func.vmap``, in one launch of
``csrc/ellipse_nll.cu``: each lane's data is read once and its K points
are evaluated from registers; a lane outside `mask` reads +inf and
nothing else. The result is (K, B) float64, the f32 terms summed in
float64 as ``_weighted_nll`` sums them.

``takes`` states what the kernel takes: the anisotropic forms, rotated
(3 shape parameters) or not (2), with or without a fitted sigma (the
last of d), at nu in ``ops.special.HALF_INTEGER_ORDERS``, f32 or f64. It
replaces no TPU kernel; its plain twin is the vmapped ``_nll_fit_z``
itself, which the CPU and the gradient lanes run. A CUDA tensor launches
or raises: there is no fallback, and everything the kernel does not take
is refused before any launch.
"""

import ctypes
import functools
import math
from contextlib import nullcontext

import torch

from ...utils.profiling import count
from ..special import HALF_INTEGER_ORDERS, half_integer_coeffs
from . import build

MAX_POINTS = 5  # kMaxPoints: d + 1 for three shape parameters and sigma
# threads a block (one block a lane), from tools/k5_sweep.py at the
# 1-degree fit's shapes on an H100: 512 against 256 reads 0.138 against
# 0.131 ms with every lane live and 0.058 against 0.081 ms with 30%, the
# share of a fit's calls most lie near (PERF.md)
THREADS = 512
# models/ellipse/model.py's clip and constant (this layer imports no
# model; a test holds them equal)
ARCTANH_THRESHOLD = 0.999999
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_SHAPE_PARAMS = (2, 3)  # the anisotropic forms: unrotated, rotated


def takes(v: float, n_shape: int, dtype: torch.dtype) -> bool:
    """Whether K5 takes a fit of order `v` with `n_shape` shape parameters
    (its model's ``n_params``) on data of `dtype`."""
    return (float(v) in HALF_INTEGER_ORDERS and n_shape in _SHAPE_PARAMS
            and dtype in _DTYPE_CODES)


def _check(points, X, z_y, w, mask, v, fit_sigma):
    """(K, B, N, d, n_shape), or raises on what the kernel does not
    take."""
    tensors = (points, X, z_y, w, mask)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("points, X, z_y, w and mask must be torch tensors")
    shapes = _shapes(points, X, z_y, w, mask, fit_sigma)
    n_shape = shapes[-1]
    if not takes(v, n_shape, points.dtype):
        if float(v) not in HALF_INTEGER_ORDERS:
            raise ValueError(f"K5 takes nu in {HALF_INTEGER_ORDERS}, got {v}")
        if n_shape not in _SHAPE_PARAMS:
            raise ValueError(
                f"K5 takes 2 or 3 shape parameters, got d={points.shape[2]}"
                f" with fit_sigma={bool(fit_sigma)}")
        raise TypeError(f"dtype must be float32 or float64, got "
                        f"{points.dtype}")
    if any(t.dtype != points.dtype for t in (X, z_y, w)):
        raise TypeError("points, X, z_y and w must share one dtype")
    if any(t.device != points.device for t in tensors):
        raise ValueError("the inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the inputs must be contiguous")
    if points.device.type != "cuda":
        raise ValueError(
            f"K5 runs on CUDA tensors, got {points.device}; elsewhere the "
            "objective is EllipseModel._nll_fit_z under vmap")
    return shapes


def _shapes(points, X, z_y, w, mask, fit_sigma):
    """(K, B, N, d, n_shape) of a call, or raises."""
    if points.dim() != 3:
        raise ValueError(f"points must be (K, B, d), got {tuple(points.shape)}")
    K, B, d = points.shape
    n_shape = d - int(bool(fit_sigma))
    if not 1 <= K <= MAX_POINTS:
        raise ValueError(f"K5 takes 1 to {MAX_POINTS} points a call, got {K}")
    if X.dim() != 3 or X.shape[0] != B or X.shape[2] != 2:
        raise ValueError(f"X must be ({B}, N, 2), got {tuple(X.shape)}")
    N = X.shape[1]
    if B == 0 or N == 0:
        raise ValueError("K5 needs at least one lane and one column")
    for name, t in (("z_y", z_y), ("w", w)):
        if tuple(t.shape) != (B, N):
            raise ValueError(f"{name} must be ({B}, {N}), got "
                             f"{tuple(t.shape)}")
    if tuple(mask.shape) != (B,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a ({B},) bool tensor")
    return K, B, N, d, n_shape


def fisher_z_nll(points, X, z_y, w, mask, *, v: float, fit_sigma: bool):
    """(K, B) float64 objective of the stacked `points` (K, B, d) on each
    lane's training data (X (B, N, 2), z_y and w (B, N)); +inf outside the
    (B,) bool `mask`. Launches K5 on the tensors' device and its current
    stream; raises on anything it does not take (``_check``) and if the
    launch fails."""
    K, B, N, d, n_shape = _check(points, X, z_y, w, mask, v, fit_sigma)
    n_coeffs, consts = _consts(float(v))
    width = 16 // points.element_size()
    vec = N % width == 0 and all(t.data_ptr() % 16 == 0 for t in (X, z_y, w))
    device = points.device
    out = torch.empty((K, B), dtype=torch.float64, device=device)
    lib = _library()
    # at few live lanes a call costs what the host spends on it (48 us
    # with a device switch and a Stream object, against 12 us for an
    # eager PyTorch op, on the H100 machine's host): switch only to
    # another device, and take the raw stream
    with (nullcontext() if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        status = lib.fisher_z_nll_launch(
            _DTYPE_CODES[points.dtype], K, n_coeffs, points.data_ptr(),
            X.data_ptr(), z_y.data_ptr(), w.data_ptr(), mask.data_ptr(), B, N,
            d, n_shape, int(bool(fit_sigma)), int(vec), consts,
            out.data_ptr(), THREADS,
            torch._C._cuda_getCurrentRawStream(device.index))
    if status != 0:
        raise RuntimeError(
            f"fisher_z_nll_launch failed with cudaError {status} (K={K}, "
            f"B={B}, N={N}, d={d}, dtype={points.dtype})")
    count("k5.launches")
    return out


@functools.cache
def _consts(v: float):
    """(the Horner coefficients' count, the kernel's constants at `v`):
    first, sqrt(pi / 2), sqrt(nu), the clip, log sqrt(2 pi), the
    coefficients."""
    coeffs = half_integer_coeffs(v)
    return len(coeffs), (ctypes.c_double * (5 + len(coeffs)))(
        1.0 / (math.gamma(v) * 2.0 ** (v - 1.0)), math.sqrt(math.pi / 2.0),
        math.sqrt(v), ARCTANH_THRESHOLD, LOG_SQRT_2PI, *coeffs)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load_library("ellipse_nll")
    fn = lib.fisher_z_nll_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_double), ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p]
    )
    for name, want in (("fisher_z_nll_max_points", MAX_POINTS),
                       ("fisher_z_nll_max_coeffs",
                        len(half_integer_coeffs(HALF_INTEGER_ORDERS[-1])))):
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != want:
            raise RuntimeError(f"csrc/ellipse_nll.cu and the wrapper "
                               f"disagree on {name}")
    return lib


__all__ = ["MAX_POINTS", "THREADS", "fisher_z_nll", "takes"]
