"""Matrix-free operators as plain callables.

Port of ``glomargridding_tpu/ops/sampling.py:44-70`` (``Matvec`` only).
The JAX class splits a matvec into a static function and array operands
so that ``jit`` passes the operands as arguments; PyTorch runs eagerly,
so here a ``Matvec`` is just the function, plus the work accounting
(``band_stats``) that the stream covariance operator reports.
"""


class Matvec:
    """``y = fn(x)`` with optional ``band_stats`` (a dict of the pairs each
    path assembles per application, or None)."""

    def __init__(self, fn, band_stats=None):
        self.fn = fn
        self.band_stats = band_stats

    def __call__(self, x):
        return self.fn(x)
