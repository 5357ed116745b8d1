"""Milliseconds a simplex iteration: the harness's synchronised spans
around ``fit_cells`` over the window's ``nm.iterations`` (the training
build, about 1% of a fit, included)."""


def read(ctx):
    seconds = ctx.spans.get("fit")
    iterations = ctx.total("nm.iterations")
    if not seconds or not iterations:
        return None
    return 1e3 * sum(seconds) / iterations
