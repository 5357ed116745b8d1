"""Reading a traced run: the harness's spans and the device's operations
from ``torch.profiler``, reduced to busy and idle time, device time by
kernel and idle gaps labelled by what the host was doing.

Every time here is in seconds on the profiler's clock, on which the
host's annotations and the device's operations share one time base.
"""

from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
import time

import torch

# The port's own kernels (glomargridding_tpu_torch/ops/cuda/csrc/*.cu);
# every other device operation is a library's (cuBLAS, cuSOLVER, the
# PyTorch elementwise kernels) or a copy.
OWN_KERNELS = ("pairwise_tile_kernel", "ellipse_sym_kernel",
               "ellipse_tile_kernel", "ellipse_matvec_kernel")
WINDOW = "window"


def own_kernel(name):
    """The port's kernel that `name` instantiates, or None."""
    for k in OWN_KERNELS:
        if k in name:
            return k
    return None


@dataclass
class Event:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    """What a traced window leaves: the device's operations and the
    harness's spans (host intervals, the window among them)."""

    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    def window(self):
        """(start, end) of the measured window."""
        for s in self.spans:
            if s.name == WINDOW:
                return s.start, s.end
        raise ValueError("the trace holds no window span")


def union(intervals):
    """Merged, sorted (start, end) pairs of possibly overlapping ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clipped(events, lo, hi):
    """(start, end) of `events` cut to [lo, hi], empty ones dropped."""
    return [(max(e.start, lo), min(e.end, hi)) for e in events
            if e.end > lo and e.start < hi]


def busy_seconds(trace):
    """Seconds of the window in which some operation ran on the
    device."""
    lo, hi = trace.window()
    return sum(b - a for a, b in union(clipped(trace.device, lo, hi)))


def device_seconds_by_name(trace):
    """{name: seconds} of device operations inside the window."""
    lo, hi = trace.window()
    out = defaultdict(float)
    for e in trace.device:
        a, b = max(e.start, lo), min(e.end, hi)
        if b > a:
            out[e.name] += b - a
    return dict(out)


def own_seconds(trace, kernel):
    """Device seconds of the port's kernel `kernel` in the window."""
    return sum(s for n, s in device_seconds_by_name(trace).items()
               if own_kernel(n) == kernel)


def library_seconds(trace):
    """Device seconds in the window of every operation that is not one
    of the port's kernels."""
    return sum(s for n, s in device_seconds_by_name(trace).items()
               if own_kernel(n) is None)


def label_gaps(spans, gaps):
    """The name of the innermost span (other than the window) open at the
    start of each gap, or the window's: one sweep over the spans, which
    nest as the host opened them."""
    inner = sorted((s for s in spans if s.name != WINDOW),
                   key=lambda s: (s.start, -s.end))
    stack, j, labels = [], 0, []
    for a, _ in gaps:
        while j < len(inner) and inner[j].start <= a:
            stack.append(inner[j])
            j += 1
        while stack and stack[-1].end <= a:
            stack.pop()
        labels.append(stack[-1].name if stack else WINDOW)
    return labels


def idle_gaps(trace):
    """[(label, seconds)] of the window's idle time summed by the span
    the host had open when each gap began, largest first."""
    lo, hi = trace.window()
    gaps, t = [], lo
    for a, b in union(clipped(trace.device, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    out = defaultdict(float)
    for (a, b), label in zip(gaps, label_gaps(trace.spans, gaps)):
        out[label] += b - a
    return sorted(out.items(), key=lambda kv: -kv[1])


def breakdown(trace, top=10):
    """The ``breakdown`` of a result line: the device operations that
    took most time and the idle time by what the host was doing."""
    ops = sorted(device_seconds_by_name(trace).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle_gaps(trace)[:top]]}


def from_kineto(result, span_names):
    """A ``Trace`` from a stopped profiler's raw results
    (``prof.profiler.kineto_results``): the device's operations, and the
    host's annotations named in `span_names` (the harness's spans; the
    device's copies of them, which are no operations, are left out)."""
    t0 = result.trace_start_ns()
    trace = Trace()
    for e in result.events():
        kind, name = e.device_type(), e.name()
        start = (e.start_ns() - t0) * 1e-9
        end = start + e.duration_ns() * 1e-9
        if name in span_names:
            if kind == torch.autograd.DeviceType.CPU:
                trace.spans.append(Event(name, start, end))
        elif kind == torch.autograd.DeviceType.CUDA:
            trace.device.append(Event(name, start, end))
    return trace


class Spans:
    """The harness's spans around the calls it makes into the program.

    Untraced, a span costs nothing. Traced, it synchronises the device at
    both ends, so that its host-clock length covers the device work
    inside it, and it marks the profiler's timeline under its name.
    ``seconds[name]`` collects the lengths of every span of that name."""

    def __init__(self, traced, sync):
        self.traced = traced
        self.sync = sync
        self.seconds = defaultdict(list)

    @contextmanager
    def __call__(self, name):
        if not self.traced:
            yield
            return
        self.sync()
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.seconds[name].append(time.perf_counter() - t0)


def span_mean_ms(spans, name):
    """Mean length (ms) of the synchronised spans called `name`, or None
    where there is none."""
    values = spans.get(name)
    return 1e3 * sum(values) / len(values) if values else None
