"""Mean milliseconds of the harness's synchronised span around
explained_variance_clip_lowrank (the partial eigensolver on the
store), in the traced window."""

from bench_torch.tracing import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.spans, "clip")
