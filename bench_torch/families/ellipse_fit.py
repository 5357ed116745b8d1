"""The ellipse fit's configuration: the maximum-likelihood ellipse of
every cell of a regular global grid from a training cube
(``EllipseBuilder.fit_cells``, Nelder-Mead on the Fisher-z likelihood),
and the counted work of a fit.

The cube is drawn in set-up from the covariance the ellipse
configurations assemble: the ellipse fields of ``fields.seed`` through
the configuration's store (K2's bf16 store), clipped as ``clip`` says,
``training_months`` draws of the clipped factors, the clip's start
blocks and the normals from ``cube_seed``. ``EllipseBuilder`` then holds
its empirical correlation (the dense (n, n) matrix on the card), and
each analysis fits one selection of cells against it.

The cube is the same in every run, as the ellipse fields are, because
it sets the work: a fit runs until its slowest lane stops, and a lane
near a pole whose f32 simplex stalls takes all 200 d iterations (8 of
the 32 selections of the 1-degree grid hold one and take 601 loop trips,
3x the others' ~200, on the H100).
"""

import numpy as np
import torch

from glomargridding_tpu_torch import (
    EllipseBuilder,
    EllipseModel,
    explained_variance_clip_lowrank,
)

from .. import accounting, tracing
from . import ellipse

# The least work of a fit, whatever implements it: a lane's training
# data is its columns' displacement (2 values), Fisher-z correlation and
# weight, 16 bytes of f32 a (lane, column), which the build writes once
# and each objective pass reads once. The build reads the lane's
# correlation at those columns alone (the window is chosen from the
# coordinates, so the rest of the row is never used) and the points'
# coordinates once, and computes a (lane, point) distance, the chord
# between two unit vectors (5 flops).
TRAIN_BYTES, COR_BYTES, DISTANCE_FLOPS = 16, 4, 5
# An objective point computes, a (lane, column): the rotation and the
# Mahalanobis length (11 flops), the Matern (1 + x) e^-x (3), the clip
# and arctanh's ratio (5), the weighted squared residual and its sum (4);
# a square root, an exponential and a logarithm.
OBJECTIVE_FLOPS, OBJECTIVE_TRANSCENDENTALS = 23, 3


class State:
    """The configuration on the card: the grid, the training cube and the
    ``EllipseBuilder`` holding its correlation."""

    def __init__(self, cfg, device, control):
        if not hasattr(EllipseBuilder, "fit_cells"):
            raise RuntimeError("this program has no EllipseBuilder.fit_cells")
        grid = ellipse.State(cfg, device, control)
        self.cfg, self.device = cfg, device
        self.lat, self.lon, self.n = grid.lat, grid.lon, grid.n
        self.model = EllipseModel(**cfg["fit_model"])
        fit = cfg["fit"]
        self.fit_kw = {**fit, "bounds": [tuple(b) for b in fit["bounds"]]}
        if int(cfg["maxiter"]) != 200 * len(fit["guesses"]):
            raise ValueError("the program's simplex takes 200 d iterations")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg["cube_seed"]))
        mv, n, trace = ellipse.operator(grid, grid.Lx, grid.Ly, grid.theta,
                                        None)
        psd = explained_variance_clip_lowrank(
            mv, n=n, trace=trace, generator=gen, **cfg["clip"])
        del mv
        T = int(cfg["training_months"])
        self.rank = psd.rank
        self.cube = psd.draw(T, generator=gen).contiguous()  # (T, n)
        del psd
        lat_axis = np.unique(grid.lat.cpu().numpy())
        lon_axis = np.unique(grid.lon.cpu().numpy())
        self.builder = EllipseBuilder(
            self.cube.reshape(T, lat_axis.size, lon_axis.size),
            {"time": np.arange(T), "latitude": lat_axis,
             "longitude": lon_axis})

    def columns(self):
        """Training columns a fit keeps."""
        k = self.fit_kw["max_train_cols"]
        return self.n if k is None else min(int(k), self.n)


def build(cfg, device, seed, control):
    return State(cfg, device, control)


def build_work(lanes, n, columns):
    """(bytes, flops, transcendentals) of the training build of `lanes`
    lanes of `columns` columns each among `n` points."""
    pairs = float(lanes) * columns
    return ((TRAIN_BYTES + COR_BYTES) * pairs + 8.0 * n,
            DISTANCE_FLOPS * float(lanes) * n, 0.0)


def objective_work(lanes, columns, steps, d):
    """(bytes, flops, transcendentals) of the simplex's objective over
    `lanes` lanes that took `steps` iterations in all (the sum of their
    ``nit``), in `d` parameters. A lane's data is read once to start (its
    d + 1 vertices) and once an iteration it is active in: that one pass
    can evaluate every point the iteration may need, since the shrunk
    vertices are known before the candidates. A lane that has stopped
    needs nothing. Each iteration computes its reflection at least; the
    expansion, contractions and shrinks that some need are left out, so
    this is a floor, and bytes bind it whatever of them is counted (7
    points a pass would be needed for the operations to)."""
    passes = float(lanes) + steps
    points = float(lanes) * (d + 1) + steps
    return (TRAIN_BYTES * columns * passes, OBJECTIVE_FLOPS * columns * points,
            OBJECTIVE_TRANSCENDENTALS * columns * points)


def fit_least_ms(lanes, n, columns, steps, d=3):
    """The least time of one fit of `lanes` cells (padding lanes are not
    work): its build and its objective passes, each at HBM's rate or the
    f32 and special-function peaks, whichever binds
    (``accounting.least_ms``). At 2,025 lanes x 4,096 columns of 64,800
    points: the build 0.050 ms, the objective 0.0396 ms a pass over every
    lane (so ~4.4 ms at the ~110 iterations a lane of the cell)."""
    return (accounting.least_ms(*build_work(lanes, n, columns))[0]
            + accounting.least_ms(*objective_work(lanes, columns, steps,
                                                  d))[0])


def device_seconds_in(trace, name):
    """Seconds in which some device operation ran inside the harness's
    spans called `name`, in the traced window."""
    lo, hi = trace.window()
    total = 0.0
    for s in trace.spans:
        if s.name == name:
            a, b = max(s.start, lo), min(s.end, hi)
            if b > a:
                total += sum(e - d for d, e in tracing.union(
                    tracing.clipped(trace.device, a, b)))
    return total
