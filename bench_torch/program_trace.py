"""Reading the program's own spans in a traced window: each device
operation put down to the innermost program span the host had open when
it launched the operation, each idle gap split at the spans' edges, and
the runtime's synchronising calls counted by span.

The program marks its phases with ``torch.profiler.record_function``
while its spans are on (``glomargridding_tpu_torch.utils.profiling``:
``spans_on()``, the names in ``SPANS``); a window run without them, as
the program before it had spans, holds none, and every reader here then
returns None. Times are seconds on the profiler's clock, the time base of
``tracing``. The spans of one host thread nest as the host opened them.

The runtime calls that wait for the device (``SYNC_CALLS``): on an H100
under CUDA 12.8 and torch 2.11, every copy of a device value to the host
(``.item()``, ``.cpu()``, ``bool()``, the error checks of
``torch.linalg``) is a ``cudaMemcpyAsync`` followed by a
``cudaStreamSynchronize``, and ``torch.cuda.synchronize`` is a
``cudaDeviceSynchronize``; ``cudaEventSynchronize`` and the synchronous
``cudaMemcpy`` did not appear in the benchmark's cells.
"""

from collections import defaultdict
from dataclasses import dataclass, field
import bisect

import torch

from .tracing import WINDOW, Event, clipped, label_gaps, union

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def program_span_names():
    """The program's declared span names, or none where the program has
    no spans."""
    from glomargridding_tpu_torch.utils import profiling

    return frozenset(getattr(profiling, "SPANS", ()))


@dataclass
class Op:
    """A device operation and the start of the host event that launched
    it (None where the trace holds none)."""

    name: str
    start: float
    end: float
    launch: float | None


@dataclass
class Program:
    """What a traced window holds of the program: its spans, the device's
    operations with their launches, and the synchronising runtime
    calls."""

    spans: list = field(default_factory=list)
    ops: list = field(default_factory=list)
    syncs: list = field(default_factory=list)


def from_kineto(result, names=None, annotations=()):
    """A ``Program`` from a stopped profiler's raw results
    (``prof.profiler.kineto_results``): the host's events named in
    `names` (default: ``program_span_names()``); each device operation
    with the start of the host event that launched it; and the runtime
    calls (``cuda*``, ``cu*``) in ``SYNC_CALLS``. The launching event is
    the PyTorch operation or annotation whose ``correlation_id`` the
    device event carries as ``linked_correlation_id``, else (a kernel
    launched outside PyTorch, as the port's own through ``ctypes``) the
    runtime call that shares the device event's ``correlation_id``. The
    device's copies of annotations, those of `names` and of
    `annotations` (the harness's spans), are no operations and are left
    out."""
    names = program_span_names() if names is None else frozenset(names)
    skip = names | frozenset(annotations)
    t0 = result.trace_start_ns()
    out, host, runtime, device = Program(), {}, {}, []
    for e in result.events():
        kind, name = e.device_type(), e.name()
        start = (e.start_ns() - t0) * 1e-9
        end = start + e.duration_ns() * 1e-9
        if kind == torch.autograd.DeviceType.CUDA:
            if name not in skip:
                device.append((name, start, end, e.linked_correlation_id(),
                               e.correlation_id()))
        elif name.startswith("cu"):  # the runtime's, on its own ids
            runtime[e.correlation_id()] = start
            if name in SYNC_CALLS:
                out.syncs.append(Event(name, start, end))
        else:
            host[e.correlation_id()] = start
            if name in names:
                out.spans.append(Event(name, start, end))
    out.ops = [Op(n, a, b, host[linked] if linked in host and linked
                  else runtime.get(own))
               for n, a, b, linked, own in device]
    return out


def innermost(spans, times):
    """The name of the innermost span (or None) open at each of `times`:
    ``tracing.label_gaps`` at each time, taken in sorted order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    for i, label in zip(order, label_gaps(spans, [(times[i], None)
                                                  for i in order])):
        out[i] = None if label == WINDOW else label
    return out


def device_seconds_by_span(program, lo, hi):
    """{span name: device seconds} of the operations in [lo, hi], each
    put down to the innermost program span open when the host event that
    launched it began; None holds the operations launched outside every
    program span, or by no event the trace holds."""
    ops = [o for o in program.ops if o.end > lo and o.start < hi]
    where = innermost(program.spans,
                      [o.start if o.launch is None else o.launch
                       for o in ops])
    out = defaultdict(float)
    for o, s in zip(ops, where):
        out[None if o.launch is None else s] += (
            min(o.end, hi) - max(o.start, lo))
    return dict(out)


def idle_gaps(program, lo, hi):
    """The (start, end) gaps of [lo, hi] in which no operation ran."""
    gaps, t = [], lo
    for a, b in union(clipped(program.ops, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_span(program, harness_spans, lo, hi):
    """{label: idle seconds} of [lo, hi]: each gap cut at every span's
    start and end, each piece put down to the innermost program span open
    over it, else to the innermost of `harness_spans` (other than the
    window), else to the window."""
    harness_spans = [s for s in harness_spans if s.name != WINDOW]
    edges = sorted({t for s in (*program.spans, *harness_spans)
                    for t in (s.start, s.end)})
    pieces = []
    for a, b in idle_gaps(program, lo, hi):
        cuts = edges[bisect.bisect_right(edges, a):bisect.bisect_left(
            edges, b)]
        bounds = [a, *cuts, b]
        pieces += list(zip(bounds[:-1], bounds[1:]))
    mids = [(a + b) / 2 for a, b in pieces]
    own = innermost(program.spans, mids)
    outer = innermost(harness_spans, mids)
    out = defaultdict(float)
    for (a, b), p, h in zip(pieces, own, outer):
        out[p or h or WINDOW] += b - a
    return dict(out)


def syncs_by_span(program, lo, hi):
    """{span name: count} of the synchronising runtime calls that began
    in [lo, hi], by the innermost program span open at the call; None
    holds those outside every program span."""
    calls = [c for c in program.syncs if lo <= c.start < hi]
    out = defaultdict(int)
    for s in innermost(program.spans, [c.start for c in calls]):
        out[s] += 1
    return dict(out)


def layer_total(by_span, layer):
    """The sum of `by_span` over the spans of `layer` (``<layer>.*``), or
    None where none of them is there."""
    values = [v for k, v in by_span.items()
              if k is not None and k.split(".", 1)[0] == layer]
    return sum(values) if values else None
