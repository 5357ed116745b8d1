"""Mean milliseconds of the harness's synchronised span around
lowrank_ensemble_step (the factored solve with its members), in the
traced window."""

from bench_torch.tracing import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.spans, "step")
