"""K4's share of its roofline (%): the least time of the window's stream
tiles (``families.ellipse_stream.k4_least_ms``: each pair within the
cutoff written once in f32, each point read once, for every application
that builds tiles; bytes bound it) over the device time of
``ellipse_tile_kernel`` in the traced window. The pairs are those the
result needs, not those the program builds: a tile that holds pairs
beyond the cutoff spends time on exact zeros, and reads lower here."""

from bench_torch import tracing


def read(ctx):
    least_ms = ctx.total("k4_least_ms")
    if ctx.trace is None or not least_ms:
        return None
    seconds = tracing.own_seconds(ctx.trace, "ellipse_tile_kernel")
    return 100.0 * least_ms * 1e-3 / seconds if seconds > 0 else None
