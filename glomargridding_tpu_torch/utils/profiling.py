"""Tracing and profiling: the port's one mechanism for each of three
things.

- A stage timer (``stage_timer``, the port of
  ``glomargridding_tpu/utils/profiling.py``'s) that waits for the card's
  work before it stops the clock, so timings are honest under
  asynchronous launches.
- Spans and counters inside the program. ``span(name)`` marks a phase
  of the work (``SPANS``: ``<layer>.<phase>``) on ``torch.profiler``'s
  timeline, the clock the device's operations are recorded on, so a
  profiler run puts every operation and every idle gap of the device
  down to the innermost span open when the host launched or waited.
  Spans are off by default, and then ``span`` is one flag test that
  returns a shared null context; ``spans_on()`` switches them on for its
  extent. A span never synchronises and never reads a clock of its own:
  it does not change what the device does. ``count(name, n)`` adds to
  ``COUNTS`` (names in ``COUNTERS``), always, at the cost of an integer
  add: kernel launches, solver branches, the eigensolver's applications
  and retained rank, the simplex's trips, points, shrinks and lanes, the
  stream's applications, columns and built pairs.
- An exporter: ``device_trace(log_dir)`` profiles its extent with spans
  on and writes a Chrome trace; ``span_device_seconds`` reads the device
  time each span launched from the profiler it yields.

Beside them, ``hbm_estimate`` / ``hbm_budget_check`` size a large matrix
before it is materialised.
"""

import collections
import logging
import os
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from .arrays import sizeof_fmt

logger = logging.getLogger(__name__)

# Every span, by layer: a layer's entry point opens one span over its
# whole call (``kriging.call``, ``lowrank.call``, ``eigsh.clip``,
# ``assembly.operator``) and its phases nest in it.
SPANS = (
    # models/kernel_kriging: kriging_from_kernel, ensemble_from_kernel
    "kriging.call", "kriging.inputs", "kriging.factor", "kriging.inverse",
    "kriging.members", "kriging.columns",
    # models/lowrank: the entry points on _lowrank_solve, and pad_rank
    "lowrank.call", "lowrank.inputs", "lowrank.states", "lowrank.solve",
    "lowrank.rows", "lowrank.members", "lowrank.pad",
    # ops/covariance_tools' low-rank clips -> ops/eigsh
    "eigsh.clip", "eigsh.sweep", "eigsh.cholqr", "eigsh.ritz", "eigsh.gate",
    "eigsh.lock",
    # models/ellipse/covariance.ellipse_covariance_operator; its
    # zero-storage stream: the build's plan (band, block rule, longitude
    # certificate) and each application, whose wide path gathers the
    # active column chunks, builds tiles (K4) and multiplies them (GEMM),
    # and whose narrow path is K3
    "assembly.operator", "assembly.store", "stream.plan", "stream.apply",
    "stream.gather", "stream.tile", "stream.gemm", "stream.fused",
    # models/ellipse/estimate.EllipseBuilder.fit_cells: the training data
    # and the batched optimiser; ops/optim.batched_nelder_mead's objective
    # calls and its host read of an iteration's two flags, or, on the
    # card (ops/cuda/simplex), each replay of the captured trips and its
    # read of the tallies
    "mle.fit", "mle.build", "mle.solve", "nm.evaluate", "nm.read",
    "nm.replay",
)
_SPAN_SET = frozenset(SPANS)

COUNTERS = (
    # launches of the kernels K1-K5 (ops/cuda), and K1's tiles on the
    # plain route (a Matern order without a kernel instantiation); those
    # of the simplex's P and D (ops/cuda/simplex), counted on the card
    "k1.launches", "k1.plain_tiles", "k2.launches", "k3.launches",
    "k4.launches", "k5.launches", "p.launches", "d.launches",
    # the dense kriging classes' solve (models/kriging._solve_sym)
    "kriging.solve.cholesky", "kriging.solve.lu",
    # models/kernel_kriging's grid column blocks, and the row panels of
    # L^-1 that the blocks with diagnostics multiply (_tri_colsq)
    "kriging.column_blocks", "kriging.tri_panels",
    # ops/eigsh: operator applications and the columns they carry, the
    # widenings and the retained rank at each return of the adaptive solve
    "eigsh.applications", "eigsh.columns", "eigsh.widenings", "eigsh.kept",
    # ops/optim.batched_nelder_mead: loop trips, the points of every
    # (K, B, d) objective call (K each), the shrink passes, the lanes each
    # call is offered (B) and those of its mask, whose values the loop
    # reads; the trips ops/cuda/simplex runs on the card, and those of
    # them after the loop's last; and the lanes EllipseBuilder.fit_cells
    # hands the optimiser, padding included
    "nm.iterations", "nm.points", "nm.shrinks", "nm.lanes_offered",
    "nm.lanes_evaluated", "nm.graph_trips", "nm.spare_trips", "mle.lanes",
    # the zero-storage stream's applications, the columns they carry and
    # the pairs each wide application builds (band_stats' kept pairs, or
    # every window's pairs without a certificate)
    "stream.applications", "stream.columns", "stream.built_pairs",
)
_COUNTER_SET = frozenset(COUNTERS)

COUNTS: collections.Counter = collections.Counter()

_NULL = nullcontext()
_spans_on = False


def span(name: str):
    """The phase `name` (declared in ``SPANS``) as a context manager: a
    ``torch.profiler.record_function`` while spans are on, else a shared
    null context."""
    if not _spans_on:
        return _NULL
    if name not in _SPAN_SET:
        raise ValueError(f"undeclared span {name!r}: add it to SPANS")
    return torch.profiler.record_function(name)


@contextmanager
def spans_on():
    """Spans on for the extent of the block (restored after it)."""
    global _spans_on
    before, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = before


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` (declared in ``COUNTERS``)."""
    if name not in _COUNTER_SET:
        raise ValueError(f"undeclared counter {name!r}: add it to COUNTERS")
    COUNTS[name] += n


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


@contextmanager
def stage_timer(name: str, result_holder: dict | None = None):
    """Time a pipeline stage; the clock stops after the card has finished
    the tensors registered via ``holder['out'] = tensors``
    (``torch.cuda.synchronize`` on each of their devices).

    >>> with stage_timer("solve") as h:
    ...     h["out"] = kriging_step(...)
    """
    holder: dict = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if "out" in holder:
            for device in _cuda_devices(holder["out"], set()):
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        logger.info("[%s] %.3fs", name, dt)
        if result_holder is not None:
            result_holder[name] = dt


@contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` context over the CPU and, when there is one, the
    card, with spans on; on exit writes a Chrome trace (``trace.json``,
    viewable in Perfetto or chrome://tracing) into `log_dir` and yields
    the profiler. In the trace each device operation's launch sits under
    the spans the host had open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with spans_on(), torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _innermost(spans, launched):
    """(name of the innermost of `spans`, (start, end, name), open at t,
    or None; ns) for each (t, ns) of `launched`: one sweep over both,
    sorted, for spans that nest."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, j = [], 0
    for t, ns in sorted(launched):
        while j < len(spans) and spans[j][0] <= t:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        yield (stack[-1][2] if stack else None), ns


def span_device_seconds(prof) -> dict:
    """{span: device seconds} of a stopped profiler run with spans on (as
    ``device_trace`` yields it): each device operation put down to the
    innermost span open when the host launched it; ``None`` holds the
    operations launched outside every span. The launch is the PyTorch
    operation or span the device event is linked to, else (a kernel
    launched through ``ctypes``) the runtime call that shares its
    correlation id."""
    host, runtime, spans, ops = {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in _SPAN_SET:  # not the device's copy of a span
                ops.append((e.duration_ns(), e.linked_correlation_id(),
                            e.correlation_id()))
        elif name.startswith("cu"):  # the runtime's, on its own ids
            runtime[e.correlation_id()] = start
        else:
            host[e.correlation_id()] = start
            if name in _SPAN_SET:
                spans.append((start, start + e.duration_ns(), name))
    out: dict = collections.defaultdict(float)
    launched = []
    for ns, linked, own in ops:
        t = host[linked] if linked and linked in host else runtime.get(own)
        if t is None:
            out[None] += ns * 1e-9
        else:
            launched.append((t, ns))
    for name, ns in _innermost(spans, launched):
        out[name] += ns * 1e-9
    return dict(out)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def hbm_estimate(*shapes_dtypes) -> int:
    """Total bytes for a set of (shape, dtype) pairs; torch or numpy
    dtypes.

    Use before materialising covariance matrices:
    ``hbm_estimate(((65000, 65000), torch.float32))`` -> ~16.9 GB.
    """
    total = 0
    for shape, dtype in shapes_dtypes:
        total += int(np.prod(shape)) * _itemsize(dtype)
    return total


def hbm_budget_check(
    *shapes_dtypes, limit_bytes: int | None = None, label: str = ""
) -> bool:
    """Log (and return) whether the given allocations fit the budget.

    Without an explicit `limit_bytes` the budget is the current card's
    free memory (``torch.cuda.mem_get_info``); without a card the caller
    must give `limit_bytes`.
    """
    need = hbm_estimate(*shapes_dtypes)
    if limit_bytes is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: give limit_bytes for a budget without a "
                "card"
            )
        limit_bytes = int(torch.cuda.mem_get_info()[0])
    fits = need <= limit_bytes
    logger.log(
        logging.INFO if fits else logging.WARNING,
        "%s needs %s of %s device memory (%s)",
        label or "allocation",
        sizeof_fmt(need),
        sizeof_fmt(limit_bytes),
        "ok" if fits else "DOES NOT FIT",
    )
    return fits
