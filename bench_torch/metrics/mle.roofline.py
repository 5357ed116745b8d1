"""The fit's share of its roofline (%): the least time of the window's
fits (``families.ellipse_fit.fit_least_ms``: each fitted cell's training
data written once and its correlation at those columns read once, then
read once to start and once an iteration the cell is active in, at HBM's
rate or the f32 and special-function peaks, whichever binds) over the
time the device was busy inside the harness's ``fit`` spans. The count
follows the work the fit needs, not how it is done: a stopped lane and a
padding lane need nothing, and a stacked call reads a lane's data once
for all its points."""

from bench_torch.families.ellipse_fit import device_seconds_in


def read(ctx):
    least_ms = ctx.total("fit_least_ms")
    if ctx.trace is None or not least_ms:
        return None
    seconds = device_seconds_in(ctx.trace, "fit")
    return 100.0 * least_ms * 1e-3 / seconds if seconds > 0 else None
