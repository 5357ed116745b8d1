"""Mean milliseconds of the harness's synchronised span around
ellipse_covariance_operator (K2 into the bf16 store), in the traced window."""

from bench_torch.tracing import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.spans, "assembly")
