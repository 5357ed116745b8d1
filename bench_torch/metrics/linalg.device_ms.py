"""Device milliseconds an analysis of every operation that is not one of
the port's own kernels: the dense linear algebra (cuBLAS and cuSOLVER
through ``torch.linalg`` and ``torch.matmul``) with the small PyTorch
kernels around it, from the traced window."""

from bench_torch import tracing


def read(ctx):
    if ctx.trace is None or not ctx.latencies:
        return None
    seconds = tracing.library_seconds(ctx.trace)
    return seconds * 1e3 / len(ctx.latencies) if seconds > 0 else None
