"""Seconds from the process's start to the first timed call: imports,
the card's context, the kernels' build or load, the state and inputs
made from the seed, and the warm-up of every shape the mix uses."""


def read(ctx):
    return ctx.setup_s
