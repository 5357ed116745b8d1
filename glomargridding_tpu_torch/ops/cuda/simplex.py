"""The batched Nelder-Mead loop paced by the card: a trip as kernels P and
D of ``csrc/simplex.cu`` around two K5 calls, replayed as a CUDA graph.

``ops.optim.batched_nelder_mead`` asks ``takes(device, d, stacked_fun)``
once its initial simplex has its values: a solve on a CUDA device with
d + 1 <= ``ellipse_nll.MAX_POINTS`` whose stacked objective is K5 (an
``ellipse_nll.FisherZ``, as ``EllipseBuilder._chunk_fitter`` binds it)
runs its trips here; everything else (the CPU, a vmapped ``fun``) runs
the eager loop, this path's twin, which gives the same bits on the card.

A trip is a fixed chain of four launches with no host decision in it:

1. P completes the previous trip's selection, tests convergence, sorts
   the vertices and writes the four clipped candidates and the clipped
   shrunk simplex of each active lane, and the `active` mask;
2. K5 on the candidates, masked to `active`;
3. D decides each active lane's move and writes the `shrinking` mask;
4. K5 on the shrunk simplex, masked to `shrinking` (a trip where no lane
   shrinks costs a few microseconds of empty blocks).

``TRIPS`` trips are captured once as a CUDA graph per (device, dtype, B,
N, d, the objective, the tolerances, maxiter): the first replay of a
shape runs the chain uncaptured, which loads the kernels, and then
captures it. Each solve copies its simplex and training data into the
graph's buffers, replays the graph and reads the tallies once a replay:
when the last trip of a replay found no lane active, the loop is over
(trips after the last lane froze change nothing). The buffers and graph
of the last shape run on each device are kept (``_LOOPS``), so a
whole-grid fit of equal chunks, or a benchmark's fits, capture once; they
hold a copy of the training data (X, z_y, w: 134 MB at 2,048 lanes of
4,096 f32 columns) until another shape replaces them. One lock
serialises the solves, so two threads may solve at once.

Counters (``utils/profiling``) keep the eager loop's meaning, read from
the card's tallies: ``nm.iterations`` (trips up to the first that finds
no lane active: max ``nit`` + 1), ``nm.points``, ``nm.shrinks`` (trips in
which some lane shrank), ``nm.lanes_offered`` and ``nm.lanes_evaluated``.
The kernels count their own launches on the card: ``k5.launches`` (K5
adds to a tally), ``p.launches`` and ``d.launches``. ``nm.graph_trips``
is the trips P ran and ``nm.spare_trips`` those after the loop's last
(fewer than ``TRIPS`` a solve). Spans: ``nm.replay`` around each replay,
``nm.read`` around its read.
"""

import ctypes
import functools
import threading
from contextlib import nullcontext

import numpy as np
import torch

from ...utils.profiling import count, span
from . import build, ellipse_nll

# Trips a replay. Fewer pay more replays (a graph launch and a host read,
# ~20 us each), more pay more trips replayed after the last lane froze
# (~20 us each: four launches whose blocks return at once). A fit at the
# 1-degree cell's shape (2,048 lanes x 4,096 columns, f32, 170 trips)
# took 21.08, 20.60, 19.41, 19.75 and 19.95 ms at 4, 8, 16, 32 and 64
# trips a replay on an H100 80GB HBM3 at 700 W (median of 5, PERF.md)
TRIPS = 16
CANDIDATES = 4
_TALLIES = 10
# the tallies (csrc/simplex.cu): [0], [1] the active lanes of the even and
# odd trips of the chain; P's launches (the trips run), the eager loop's
# trips, the shrink trips, the shrinking and the active lanes summed over
# trips, K5's launches, D's launches
(_TRIPS_RUN, _ITERATIONS, _SHRINK_TRIPS, _SHRUNK_LANES, _ACTIVE_LANES,
 _K5_LAUNCHES, _D_LAUNCHES) = 2, 3, 4, 6, 7, 8, 9
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

_LOOPS: dict = {}  # device -> _Loop, the last shape run there
_LOCK = threading.Lock()


def takes(device: torch.device, d: int, stacked_fun) -> bool:
    """Whether a Nelder-Mead solve of `d` parameters on `device` with the
    stacked objective `stacked_fun` runs its trips here."""
    return (device.type == "cuda" and d + 1 <= ellipse_nll.MAX_POINTS
            and isinstance(stacked_fun, ellipse_nll.FisherZ))


def trips(simplex, fvals, args, lo, hi, *, xatol, fatol, maxiter,
          stacked_fun):
    """The eager loop's trips from the (B, d + 1, d) `simplex` and its
    (B, d + 1) float64 values: (simplex, values, nit) where every lane
    has converged or spent `maxiter`, as ``batched_nelder_mead``'s loop
    leaves them. `args` is K5's training data (X, z_y, w); `lo`, `hi` the
    (d,) box; `stacked_fun` the ``ellipse_nll.FisherZ``."""
    X = args[0]
    B, _, d = simplex.shape
    key = (simplex.device, simplex.dtype, B, X.shape[1], d, stacked_fun,
           float(xatol), float(fatol), int(maxiter))
    with _LOCK:
        loop = _LOOPS.get(simplex.device)
        if loop is None or loop.key != key:
            _LOOPS.pop(simplex.device, None)  # the old shape's buffers first
            loop = _LOOPS[simplex.device] = _Loop(key)
        return loop.run(simplex, fvals, *args, lo, hi)


class _Loop:
    """One shape's buffers, and the graph of ``TRIPS`` trips over them."""

    def __init__(self, key):
        (device, dtype, B, N, d, self.objective, self.xatol, self.fatol,
         self.maxiter) = key
        self.key = key
        self.device, self.B, self.d, self.trips = device, B, d, TRIPS
        V = d + 1

        def empty(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        f64 = torch.float64
        self.X, self.z, self.w = empty((B, N, 2)), empty((B, N)), empty((B, N))
        self.x, self.f = empty((B, V, d)), empty((B, V), f64)
        self.nit = empty((B,), torch.int32)
        self.xs, self.fs = empty((B, V, d)), empty((B, V), f64)
        self.cand, self.fc = empty((CANDIDATES, B, d)), empty((CANDIDATES, B),
                                                              f64)
        self.shrunk, self.fsh = empty((V, B, d)), empty((V, B), f64)
        self.active = torch.zeros((B,), dtype=torch.bool, device=device)
        self.shrinking = torch.zeros_like(self.active)
        self.pick = torch.zeros((B,), dtype=torch.uint8, device=device)
        self.lo, self.hi = empty((d,)), empty((d,))
        self.tally = torch.zeros((_TALLIES,), dtype=torch.int64,
                                 device=device)
        self.k5_launches = self.tally[_K5_LAUNCHES:_K5_LAUNCHES + 1]
        # torch.mean's factor over the d best vertices, as its reduction
        # computes it in the working type: (B d) / (B d d)
        self.factor = float(np.float32(B * d) / np.float32(B * d * d)
                            if dtype == torch.float32 else B * d / (B * d * d))
        # P's buffers, in the order of csrc/simplex.cu's struct Trip
        self.ptrs = (ctypes.c_void_p * 14)(*(t.data_ptr() for t in (
            self.x, self.f, self.nit, self.xs, self.fs, self.cand, self.fc,
            self.shrunk, self.fsh, self.active, self.pick, self.lo, self.hi,
            self.tally)))
        self.graph = None

    def run(self, simplex, fvals, X, z_y, w, lo, hi):
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else nullcontext()):
            for dst, src in ((self.X, X), (self.z, z_y), (self.w, w),
                             (self.x, simplex), (self.f, fvals),
                             (self.lo, lo), (self.hi, hi)):
                dst.copy_(src)
            for t in (self.nit, self.pick, self.tally):
                t.zero_()
            while True:
                with span("nm.replay"):
                    self._replay()
                with span("nm.read"):
                    tally = self.tally.tolist()
                # the active lanes of the chain's last trip
                if not tally[(self.trips - 1) & 1]:
                    break
        iterations, shrinks = tally[_ITERATIONS], tally[_SHRINK_TRIPS]
        count("nm.iterations", iterations)
        count("nm.points", CANDIDATES * iterations + (self.d + 1) * shrinks)
        count("nm.shrinks", shrinks)
        count("nm.lanes_offered", self.B * (iterations + shrinks))
        count("nm.lanes_evaluated",
              tally[_ACTIVE_LANES] + tally[_SHRUNK_LANES])
        count("nm.graph_trips", tally[_TRIPS_RUN])
        count("nm.spare_trips", tally[_TRIPS_RUN] - iterations)
        count("k5.launches", tally[_K5_LAUNCHES])
        count("p.launches", tally[_TRIPS_RUN])
        count("d.launches", tally[_D_LAUNCHES])
        # copies: the buffers are the next solve's
        return self.x.clone(), self.f.clone(), self.nit.clone()

    def _replay(self):
        if self.graph is None:
            self._chain()
            self.graph = _capture(self._chain)
        else:
            self.graph.replay()

    def _chain(self):
        """The replay's trips: P, K5, D, K5 each."""
        for j in range(self.trips):
            _prepare(self, j & 1)
            self.objective(self.cand, self.X, self.z, self.w, self.active,
                           out=self.fc, launches=self.k5_launches)
            _decide(self, j & 1)
            self.objective(self.shrunk, self.X, self.z, self.w,
                           self.shrinking, out=self.fsh,
                           launches=self.k5_launches)


def _capture(chain):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    return graph


def _stream(loop):
    return torch._C._cuda_getCurrentRawStream(loop.device.index)


def _prepare(loop, slot):
    """Launch P on the current stream."""
    _check(_library().nm_prepare_launch(
        _DTYPE_CODES[loop.x.dtype], loop.d, loop.B, loop.ptrs, loop.xatol,
        loop.fatol, loop.maxiter, loop.factor, slot, _stream(loop)), "P", loop)


def _decide(loop, slot):
    """Launch D on the current stream."""
    _check(_library().nm_decide_launch(
        loop.d, loop.B, loop.fc.data_ptr(), loop.fs.data_ptr(),
        loop.active.data_ptr(), loop.pick.data_ptr(),
        loop.shrinking.data_ptr(), loop.tally.data_ptr(), slot,
        _stream(loop)), "D", loop)


def _check(status, name, loop):
    if status != 0:
        raise RuntimeError(
            f"the simplex's {name} launch failed with cudaError {status} "
            f"(B={loop.B}, d={loop.d}, dtype={loop.x.dtype})")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load_library("simplex")
    lib.nm_prepare_launch.restype = ctypes.c_int
    lib.nm_prepare_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    lib.nm_decide_launch.restype = ctypes.c_int
    lib.nm_decide_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p])
    lib.nm_tallies.restype = ctypes.c_int
    if lib.nm_tallies() != _TALLIES:
        raise RuntimeError("csrc/simplex.cu and the wrapper disagree on the "
                           "tallies")
    return lib


__all__ = ["TRIPS", "takes", "trips"]
