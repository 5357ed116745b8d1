"""Pairs the stream builds a pair the result needs: the program's
``stream.built_pairs`` (the pairs its tile kernel builds in each wide
application) over the pairs within the cutoff
(``families.ellipse_stream.needed_pairs``) times the wide applications,
over the window. 1.0 where nothing beyond the cutoff is built; lower is
better. A program without the counter reads nothing."""


def read(ctx):
    built = ctx.total("stream.built_pairs")
    needed = ctx.total("stream.needed_pairs")
    if not built or not needed:
        return None
    return built / needed
