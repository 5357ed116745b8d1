"""Analyses completed over the whole window, per second: every analysis
that started in the window ended in it (the window closes at the first
completion at or after its length)."""


def read(ctx):
    return len(ctx.latencies) / ctx.elapsed
