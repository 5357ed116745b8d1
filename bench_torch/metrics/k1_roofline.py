"""K1's share of its roofline (%): the least time of the window's K1
tiles (``accounting.k1_least_ms``: each point read once, each f32
covariance written once; bytes bound them) over the device time of
``pairwise_tile_kernel`` in the traced window."""

from bench_torch import tracing


def read(ctx):
    least_ms = ctx.total("k1_least_ms")
    if ctx.trace is None or not least_ms:
        return None
    seconds = tracing.own_seconds(ctx.trace, "pairwise_tile_kernel")
    return 100.0 * least_ms * 1e-3 / seconds if seconds > 0 else None
