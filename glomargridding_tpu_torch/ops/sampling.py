"""Matrix-free operators as plain callables.

Port of ``glomargridding_tpu/ops/sampling.py``: ``Matvec`` (``:44-70``)
and ``dense_matvec`` (``:121-141``). The JAX class splits a matvec into a
static function and array operands so that ``jit`` passes the operands
as arguments; PyTorch runs eagerly, so here a ``Matvec`` is just the
function, plus the work accounting (``band_stats``) that the stream
covariance operator reports. ``kernel_matvec`` and the Chebyshev sampler
are not ported yet.
"""

import torch

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
