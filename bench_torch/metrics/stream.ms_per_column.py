"""Milliseconds a column of the stream operator's applications: the
harness's synchronised ``stream`` spans around each application the clip
makes, summed over the traced window, over the columns the program
counted (its ``stream.columns`` counter; a program without it reads
nothing)."""


def read(ctx):
    seconds = ctx.spans.get("stream")
    columns = ctx.total("stream.columns")
    if not seconds or not columns:
        return None
    return 1e3 * sum(seconds) / columns
