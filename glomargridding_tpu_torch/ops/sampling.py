r"""Matrix-free operators and Gaussian sampling by Chebyshev square-root
matvecs.

Port of ``glomargridding_tpu/ops/sampling.py``. A draw
:math:`y \sim N(0, C)` needs no factorisation:

.. math::
    y = p_d(C)\, z \approx C^{1/2} z, \qquad z \sim N(0, I),

where :math:`p_d` is the degree-d Chebyshev expansion of sqrt on the
spectral interval [lam_min, lam_max]; each degree costs one matvec,
shared by all members. The operator is a dense (possibly bf16-stored)
matrix (``dense_matvec``) or a kernel whose tiles are rebuilt per row
block on every application (``kernel_matvec``; on the card a
``VariogramKernel`` builds them with K1).

lam_max must bound the MATRIX spectrum, which for a densely sampled
smooth kernel is hundreds of times the sill: measure it with
``estimate_spectral_range``, whose lam_min is only a floor (1e-3
lam_max) for callers to max() with a known nugget. The expansion
converges like :math:`\exp(-2 d \sqrt{a/b})`; degree ~ 4 sqrt(lam_max /
lam_min) gives ~3e-4 relative accuracy. Eigenvalues outside the interval
make the polynomial diverge, so the bounds must be honest.

What differs from the reference: the JAX ``Matvec`` splits a matvec into
a static function and array operands so that ``jit`` passes the operands
as arguments; PyTorch runs eagerly, so here a ``Matvec`` is the function
plus the work accounting (``band_stats``) that the stream covariance
operator reports, and ``chebyshev_apply`` takes it or any callable. The
reference's ``lax.scan`` loops are Python loops; its 256-row rounding of
kernel blocks and its ``BoundedCache`` of matvecs serve XLA's compile
cache and are left out. ``jax.random`` keys become ``generator=`` or
injected normals (``noise=``).
"""

import numpy as np
import torch

from ..utils.device import resolve_device

# rows of a bf16 matrix upcast at a time by the CPU product (bytes of f32)
_CPU_CHUNK_BYTES = 1 << 30


class Matvec:
    """``y = fn(x)`` with optional ``band_stats`` (a dict of the pairs each
    path assembles per application, or None)."""

    def __init__(self, fn, band_stats=None):
        self.fn = fn
        self.band_stats = band_stats

    def __call__(self, x):
        return self.fn(x)


def _mm_bf16_f32(A, xb):
    """A @ xb for bf16 operands with f32 accumulation and an f32 result.

    On the card one cuBLAS GEMM with an f32 output; on the CPU (whose
    build lacks that form) row chunks of A upcast to f32, whose products
    of bf16 values are exact."""
    if A.is_cuda:
        return torch.mm(A, xb, out_dtype=torch.float32)
    rows = max(1, (_CPU_CHUNK_BYTES // 4) // A.shape[1])
    xf = xb.float()
    return torch.cat([A[r : r + rows].float() @ xf
                      for r in range(0, A.shape[0], rows)])


def dense_matvec(cov, compute_dtype=torch.float32) -> Matvec:
    """Matvec over a dense (possibly bf16-stored) covariance tensor.

    ``matvec(v)`` takes (n,) or (n, b), rounds v to the store's dtype and
    returns ``cov @ v`` in v's dtype, accumulated in `compute_dtype`
    whatever the store: a bf16 store with f32 accumulation costs ~3
    decimal digits on the matrix entries but none on the accumulation
    (one GEMM with an f32 output); an f32 store with f64 accumulation is
    the product of the operands widened to f64. Where the store is at
    least as wide as `compute_dtype` the product runs in the store's own
    dtype (true f32 for f32: the port never enables TF32).
    """
    compute_dtype = torch.promote_types(cov.dtype, compute_dtype)

    def apply(v):
        v = torch.as_tensor(v, device=cov.device)
        v2 = (v if v.dim() == 2 else v[:, None]).to(cov.dtype)
        if cov.dtype == torch.bfloat16 and compute_dtype == torch.float32:
            y = _mm_bf16_f32(cov, v2)
        else:
            y = cov.to(compute_dtype) @ v2.to(compute_dtype)
        y = y.to(v.dtype)
        return y if v.dim() == 2 else y[:, 0]

    return Matvec(apply)


def chebyshev_sqrt_coeffs(
    lam_min: float, lam_max: float, degree: int
) -> np.ndarray:
    """Chebyshev expansion coefficients of sqrt on [lam_min, lam_max]
    (host numpy, f64)."""
    if lam_min <= 0:
        raise ValueError("lam_min must be > 0 (add a nugget/jitter floor)")
    n = degree + 1
    k = np.arange(n)
    nodes = np.cos(np.pi * (k + 0.5) / n)  # Chebyshev nodes in [-1, 1]
    x = 0.5 * (lam_max - lam_min) * nodes + 0.5 * (lam_max + lam_min)
    fvals = np.sqrt(x)
    j = k[:, None]
    coeffs = (2.0 / n) * np.cos(j * np.pi * (k[None, :] + 0.5) / n) @ fvals
    coeffs[0] *= 0.5
    return coeffs


def chebyshev_apply(matvec, z, coeffs, lam_min, lam_max):
    """p(C) z by the Chebyshev recurrence: one matvec per degree.

    `matvec` is a ``Matvec`` or any callable v -> C v on (M, k) tensors;
    `z` an (M, k) tensor; `coeffs` from ``chebyshev_sqrt_coeffs`` (or any
    function's expansion). The interval map and the coefficients are
    taken in z's dtype.
    """
    def scalar(v):
        return torch.as_tensor(v, dtype=z.dtype, device=z.device)

    lam_min, lam_max = scalar(lam_min), scalar(lam_max)
    coeffs = scalar(coeffs)
    alpha = 2.0 / (lam_max - lam_min)
    beta = -(lam_max + lam_min) / (lam_max - lam_min)

    def a_tilde(v):
        return alpha * matvec(v) + beta * v

    t_prev = z
    t_cur = a_tilde(z)
    y = coeffs[0] * t_prev + coeffs[1] * t_cur
    for c in coeffs[2:]:
        t_prev, t_cur = t_cur, 2.0 * a_tilde(t_cur) - t_prev
        y = y + c * t_cur
    return y


def kernel_matvec(kernel_fn, lats_rad, lons_rad, n_blocks: int = 16,
                  device=None) -> Matvec:
    """Streamed matvec: the covariance rebuilt from the kernel per row
    block on every application, never stored.

    ``y[block] = kernel_fn(block, all) @ v``: one tile and one product per
    block of ceil(M / n_blocks) rows, so the cost is one full kernel
    evaluation per application. `kernel_fn(la1, lo1, la2, lo2)` takes
    radian tensors (a ``VariogramKernel`` builds its tiles with K1 on the
    card). The coordinates go to `device`; with none, where they lie if
    they are tensors, else to the card.
    """
    device = resolve_device(device, lats_rad, lons_rad)
    la = torch.as_tensor(lats_rad, device=device)
    lo = torch.as_tensor(lons_rad, dtype=la.dtype, device=device)
    m = la.shape[0]
    block = -(-m // n_blocks)

    def apply(v):
        v = torch.as_tensor(v, device=la.device)
        return torch.cat([
            kernel_fn(la[s:s + block], lo[s:s + block], la, lo) @ v
            for s in range(0, m, block)
        ])

    return Matvec(apply)


def estimate_spectral_range(matvec, n: int, iters: int = 30,
                            dtype=torch.float32, *, generator=None,
                            noise=None, device=None):
    """(lam_min_floor, lam_max_bound) of an SPD operator by power
    iteration.

    lam_max is the last Rayleigh estimate times a 1.05 margin; lam_min is
    NOT resolved: a floor of 1e-3 lam_max is returned, which callers
    should max() with their known nugget. The start vector is drawn from
    `generator` or given as `noise` of shape (n, 1), on `device` (with
    none, `noise`'s if it is a tensor, else the card).
    """
    device = resolve_device(device, noise)
    v = _normal(noise, generator, (n, 1), dtype, device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = matvec(v)
        lam = torch.linalg.norm(w)
        v = w / lam
    lam_max = float(lam) * 1.05
    return 1e-3 * lam_max, lam_max


def sample_mvn_chebyshev(matvec, n: int, n_members: int, lam_min: float,
                         lam_max: float, degree: int = 100,
                         dtype=torch.float32, *, generator=None, noise=None,
                         device=None):
    """n_members draws of N(0, C) through the Chebyshev sqrt of a matvec.

    Returns (n_members, n). All members share every matvec (one batched
    product per degree). The standard normals come from `generator` or
    are given as `noise` of shape (n, n_members); they live on `device`
    (with none, `noise`'s if it is a tensor, else the card).
    """
    device = resolve_device(device, noise)
    coeffs = torch.as_tensor(chebyshev_sqrt_coeffs(lam_min, lam_max, degree),
                             dtype=dtype, device=device)
    z = _normal(noise, generator, (n, n_members), dtype, device)
    return chebyshev_apply(matvec, z, coeffs, lam_min, lam_max).T


def _normal(noise, generator, shape, dtype, device):
    """Standard normals of `shape`: from `generator`, or `noise` checked
    against the shape."""
    if noise is None:
        return torch.randn(shape, dtype=dtype, device=device,
                           generator=generator)
    z = torch.as_tensor(noise, dtype=dtype, device=device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(z.shape)}, expected "
                         f"{tuple(shape)}")
    return z
