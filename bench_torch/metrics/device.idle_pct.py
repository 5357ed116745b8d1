"""The share (%) of the traced window in which no operation ran on the
device: one minus the union of the device's operations over the
window."""

from bench_torch import tracing


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.window()
    return 100.0 * (1.0 - tracing.busy_seconds(ctx.trace) / (hi - lo))
