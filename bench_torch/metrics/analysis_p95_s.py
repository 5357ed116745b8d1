"""The 95th percentile of the latencies of all the window's analyses,
each from its call to its outputs complete on the card."""

import statistics


def read(ctx):
    if len(ctx.latencies) < 2:
        return None
    return statistics.quantiles(ctx.latencies, n=100, method="inclusive")[94]
