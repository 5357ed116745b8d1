"""K2's share of its roofline (%): the least time of the window's bf16
stores (``accounting.k2_least_ms``: the n x n store written once in bf16;
bytes bound it) over the device time of ``ellipse_sym_kernel`` in the
traced window."""

from bench_torch import tracing


def read(ctx):
    least_ms = ctx.total("k2_least_ms")
    if ctx.trace is None or not least_ms:
        return None
    seconds = tracing.own_seconds(ctx.trace, "ellipse_sym_kernel")
    return 100.0 * least_ms * 1e-3 / seconds if seconds > 0 else None
