"""Entry ``fit``: one selection of the grid's cells fitted by
``EllipseBuilder.fit_cells`` (Nelder-Mead, the configuration's fit
arguments) against the correlation built in set-up.

The pool's K selections are strided: selection k holds cells k, k + K,
k + 2K, ..., so that each carries every latitude; K of them make one
whole-grid fit, in another order than ``compute_params``' chunks. A fit
runs until its slowest lane stops, and with the cube fixed (the
configuration's ``cube_seed``) so is each selection's work, but not
alike: a selection holding a polar lane whose simplex stalls takes 3x
the others. So every run walks the same cycle of selections, whatever
the seed: pool index ``order[i]`` of the run's cycle fits selection
``bit_reversed(i)``, and a window fits selections 0, K/2, K/4, 3K/4, ...
The seed draws the ``lanes_compared`` lanes of each of the first
``compare`` selections of the window, which the entry keeps and compares
with the plain reference (a window reaches a few of the K, so the
harness's own draw of pool indices would miss most).
"""

import math

import numpy as np
import torch

from glomargridding_tpu_torch.utils import profiling

from ..families.ellipse_fit import build, fit_least_ms
from ..traffic import bit_reversed, plan

REFERENCE = "ellipse_fit"
__all__ = ["REFERENCE", "Entry", "build"]

# the program's counters an analysis's work reads (absent from a program
# without them: their deltas are then 0)
COUNTED = ("nm.iterations", "nm.points", "nm.shrinks", "mle.lanes")
# the reference's optimum is met within 1% on Lx and Ly and 0.02 rad on
# theta, the bounds the f32 simplex was held to against f64 (PERF.md)
LENGTH_RTOL, THETA_ATOL = 0.01, 0.02


def canonical(x):
    """(Lx, Ly, theta) with Lx >= Ly (the axes swapped and theta turned a
    quarter where they are not) and theta modulo pi, (L, 3) float64."""
    x = x.to(torch.float64).clone()
    swap = x[:, 1] > x[:, 0]
    x[swap, 0], x[swap, 1] = x[swap, 1].clone(), x[swap, 0].clone()
    x[swap, 2] += 0.5 * math.pi
    x[:, 2] = torch.remainder(x[:, 2], math.pi)
    return x


def misses(x, x_ref):
    """Lanes whose optimum is not within LENGTH_RTOL and THETA_ATOL of
    the reference's (theta compared modulo pi)."""
    a, b = canonical(x), canonical(x_ref)
    rel = torch.abs(a[:, :2] - b[:, :2]) / b[:, :2]
    dth = torch.remainder(a[:, 2] - b[:, 2] + 0.5 * math.pi, math.pi) \
        - 0.5 * math.pi
    return (rel > LENGTH_RTOL).any(dim=1) | (torch.abs(dth) > THETA_ATOL)


class Entry:
    """One selection's fit."""

    def __init__(self, state, cfg, mix, items, seed, spans):
        self.state, self.cfg, self.items, self.spans = (state, cfg, items,
                                                         spans)
        pool = len(items)
        _, order = plan(mix, seed)
        bits = pool.bit_length() - 1
        self.selections = {
            k: np.arange(bit_reversed(i, bits), state.n, pool)
            for i, k in enumerate(order)}
        self.chunk = int(cfg["chunk_size"])
        self.compared = order[:int(mix["compare"])]
        self.warm = order[-1]
        rng = np.random.default_rng([seed, 2])
        self.lanes = {k: np.sort(rng.choice(
            self.selections[k].size,
            min(int(mix["lanes_compared"]), self.selections[k].size),
            replace=False)) for k in self.compared}
        self.kept = {}

    def longest(self):
        # every selection is the same work: the window's first
        return self.compared[0]

    def warm_up(self):
        # the last of the cycle, which a window does not reach first
        return [self.warm]

    def __call__(self, k):
        s = self.state
        before = [profiling.COUNTS[c] for c in COUNTED]
        with self.spans("fit"):
            fits = s.builder.fit_cells(self.selections[k], s.model,
                                       chunk_size=self.chunk, **s.fit_kw)
        work = {c: profiling.COUNTS[c] - b for c, b in zip(COUNTED, before)}
        # the cells fitted and their iterations, padding left out: one
        # read, after the optimiser's last
        lanes, steps = torch.stack([
            fits.has_data.sum(),
            fits.nit[fits.has_data].sum()]).tolist()
        work["fit_least_ms"] = fit_least_ms(lanes, s.n, s.columns(), steps,
                                            fits.x.shape[1])
        if k in self.lanes and k not in self.kept and k != self.warm:
            self.kept[k] = fits
        return fits, work

    def info(self, works):
        its = [w["nm.iterations"] for w in works]
        kept = [int(self.selections[k][0]) for k in self.kept]
        lanes = sorted({v.size for v in self.lanes.values()})
        return {"rank": self.state.rank,
                "iterations": f"{min(its)}-{max(its)} a fit",
                "shrinks": f"{sum(w['nm.shrinks'] for w in works)}",
                "compared": f"selections {kept}, {lanes} lanes each"}

    def release(self, kept):
        pass

    def compare(self, kept, reference):
        """Each kept selection's compared lanes against the reference's
        fit of the same cells from the same cube:

        - ``nll_err``: the median of |f_program - f_ref(x_program)| /
          |f_ref|, the objective the program returned against the
          reference's at the program's optimum (0 inside the range any
          choice of tied columns gives). Not the maximum: that is set by
          the lanes within a few degrees of a pole, where cells a few km
          apart put the model's and the data's correlations within 1e-5
          of 1, which f32 cannot resolve and the Fisher transform
          magnifies (5e-6 there, against 2e-9 at the median, H100);
        - ``opt_gap``: the 95th percentile of f_ref(x_program) -
          f_ref(x_ref), the reference's own optimum x_ref (~2% of lanes
          have two optima, so not the maximum);
        - ``param_miss``: the share of lanes whose optimum misses the
          reference's (``misses``)."""
        s, fit = self.state, self.state.fit_kw
        rel, gap, miss = [], [], []
        for k in self.compared:
            if k not in self.kept:
                continue
            fits, lanes = self.kept[k], self.lanes[k]
            pick = torch.as_tensor(lanes, device=fits.x.device)
            centres = torch.as_tensor(self.selections[k][lanes],
                                      device=s.device)
            r = reference.fit(
                s.cube, s.lat, s.lon, centres, fits.x[pick],
                nu=float(s.cfg["fit_model"]["v"]), k=s.columns(),
                min_distance=fit["min_distance"],
                max_distance=fit["max_distance"],
                delta_x_method=fit["delta_x_method"],
                guesses=fit["guesses"], bounds=fit["bounds"],
                tol=fit["tol"], maxiter=int(self.cfg["maxiter"]))
            f = fits.fun[pick].to(torch.float64)
            off = torch.clamp(torch.maximum(r["low"] - f, f - r["high"]),
                              min=0.0)
            rel.append(off / torch.abs(r["f_program"]))
            gap.append(r["f_program"] - r["f"])
            miss.append(misses(fits.x[pick], r["x"]))
        if not rel:
            return {}
        gap = torch.cat(gap)
        return {"nll_err": float(torch.cat(rel).median()),
                "opt_gap": float(torch.quantile(gap, 0.95)),
                "param_miss": float(torch.cat(miss).double().mean())}
