"""Applications of the operator a clip makes, counted by the harness's
wrapper around the operator it hands to the clip (the columns are
printed beside them)."""


def read(ctx):
    clips = ctx.total("clips")
    return ctx.total("sweeps") / clips if clips else None
