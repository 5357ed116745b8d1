"""Loop trips of the batched simplex a fit, over the window's fits: the
program's ``nm.iterations`` counter, read around each ``fit_cells``
call. A change that stops the simplex early lowers it."""


def read(ctx):
    fits = [w["nm.iterations"] for w in ctx.works if w.get("nm.iterations")]
    return sum(fits) / len(fits) if fits else None
