"""The whole analysis's share (%) of the card's peak: the least time of
the window's counted work, each precision at its own peak
(``accounting``: f32 flops at 67 TFLOP/s, the bf16 store's products at
989 TFLOP/s), over the traced window. It bounds every kernel's share
from above: a later change that takes a kernel off the path cannot raise
it without doing the analysis faster. It also reads
``step_mfu.variants``, the same share where it moves the rate."""

from bench_torch.accounting import share_of_peak


def read(ctx):
    return share_of_peak(ctx)
