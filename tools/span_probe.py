"""Read the port's own spans and counters in one traced window of a
benchmark cell, the way the per-layer metrics that read them would.

    python3 tools/span_probe.py --workload <cell> --seed <n> \
        --seconds <s> [--spans 0|1] [--out <file.jsonl>]

It sets the cell up as ``bench_torch/run.py`` does (``harness.set_up``),
runs the window under ``torch.profiler`` with the program's spans on
(``profiling.spans_on()``; ``--spans 0`` leaves them off, for the cost of
spans against a window without them), and prints one JSON object: the
window's rate, the deltas of ``profiling.COUNTS`` over it, the device
milliseconds, idle milliseconds and synchronising calls by program span,
the analyses' latencies, and the readings below. Nothing is compared
with the reference. Each reading is computed from
``bench_torch/program_trace`` over the window [lo, hi] of the harness's
``window`` span, with n the window's analyses and c its ``eigsh.clip``
spans:

- ``kriging.factor_ms``, ``kriging.columns_ms``, and for the ellipse
  fit ``mle.build_ms``, ``nm.evaluate_ms``, ``nm.read_ms``, ``nm.replay_ms``:
  ``device_seconds_by_span`` of that span, x 1e3 / n;
- ``kriging.host_idle_ms``, ``lowrank.host_idle_ms``, ``mle.host_idle_ms``,
  ``nm.host_idle_ms``: ``layer_total`` of ``idle_by_span`` (the harness's
  spans the fallback) over the layer's spans, x 1e3 / n;
- ``host.syncs_per_analysis``: the calls of ``syncs_by_span`` inside some
  program span, / n;
- ``eigsh.sweep_ms``, ``eigsh.cholqr_ms``, ``eigsh.ritz_ms``:
  ``device_seconds_by_span`` of that span, x 1e3 / c;
- for the ellipse fit's simplex, with t the window's ``nm.iterations``
  (the eager loop's trips, whichever loop ran them), g its
  ``nm.graph_trips`` (the trips the card's loop ran, as P counts them
  on the card) and c its
  objective calls (``nm.lanes_offered`` over the lanes a fit,
  ``mle.lanes`` / n): ``nm.skip_share``, 1 - ``nm.lanes_evaluated`` /
  ``nm.lanes_offered``; ``nm.calls_per_analysis``, c / n;
  ``k5.launches_per_call``, ``k5.launches`` / c (1 where the eager loop
  runs every call on K5; the card's loop launches K5 at the start and
  twice a replayed trip, spare trips and empty shrink passes included,
  and K5 counts those launches on the card, so (n + 2 g) / c there);
  ``nm.evaluate_us_per_call``, the
  ``nm.evaluate`` device time / c; ``nm.graph_trips_per_trip``, g / t
  (0 on the eager loop, 1 + the spare share on the card's);
  ``nm.spare_trips_per_fit``, ``nm.spare_trips`` / n; and the per-trip
  split, ``<span>.device_us_per_trip`` and ``<span>.idle_us_per_trip``
  of ``nm.evaluate``, ``nm.replay`` (the replayed trips' kernels),
  ``nm.read`` (the eager loop's read a trip, or the card's loop's read
  of its tallies a replay) and ``mle.solve`` (its own, outside the
  others), x 1e6 / t;
- ``eigsh.columns_per_rank``: ``COUNTS`` ``eigsh.columns`` / ``eigsh.kept``;
- ``eigsh.applications_per_clip``: ``eigsh.applications`` / c, beside the
  harness's ``eigsh.sweeps_per_clip``;
- ``launched_in_spans``: the share of device time launched inside some
  program span;
- ``idle_s`` (the sum of ``idle_by_span``) beside ``harness_idle_s`` (the
  sum of ``tracing.idle_gaps``), and the harness's ``eigsh.clip_ms``,
  ``linalg.device_ms`` and ``busy_s``, read from a trace without the
  device's copies of the program's spans (``tracing.from_kineto`` keeps
  them, and would count their lengths as device time).
"""

import argparse
from contextlib import nullcontext
import json
from pathlib import Path
import sys
import time

T0 = time.perf_counter()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import harness, program_trace, tracing  # noqa: E402
from glomargridding_tpu_torch.utils import profiling  # noqa: E402

PER_ANALYSIS = {"kriging.factor_ms": "kriging.factor",
                "kriging.columns_ms": "kriging.columns",
                "mle.build_ms": "mle.build", "nm.evaluate_ms": "nm.evaluate",
                "nm.read_ms": "nm.read", "nm.replay_ms": "nm.replay"}
PER_CLIP = {"eigsh.sweep_ms": "eigsh.sweep", "eigsh.cholqr_ms": "eigsh.cholqr",
            "eigsh.ritz_ms": "eigsh.ritz"}
PER_TRIP = ("nm.evaluate", "nm.replay", "nm.read", "mle.solve")
HARNESS_METRICS = ("eigsh.clip_ms", "eigsh.sweeps_per_clip",
                   "linalg.device_ms")


def ratio(a, b, scale=1.0):
    return None if a is None or not b else a * scale / b


def window_trace(cell, seed, seconds, spans, device, t0):
    """The cell set up from `seed` and one profiled window: (latencies,
    works, elapsed, setup seconds, the harness's spans, the profiler's raw
    results, the counters' deltas)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    harness.set_precision(False)
    hspans = tracing.Spans(True, sync)
    entry, order, _ = harness.set_up(cell, seed, device, False, hspans,
                                     sync)
    setup_s = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = profiling.COUNTS.copy()
    with (profiling.spans_on() if spans else nullcontext()), \
            torch.profiler.profile(activities=activities) as prof:
        latencies, works, _, elapsed = harness.window(
            entry, order, set(), seconds, hspans, sync)
    counts = {k: v - before[k] for k, v in profiling.COUNTS.items()
              if v != before[k]}
    return (latencies, works, elapsed, setup_s, hspans,
            prof.profiler.kineto_results, counts)


def program_metrics(program, device, idle, syncs, n, clips, counts):
    """The readings of the module's docstring, by name."""
    metrics = {k: ratio(device.get(v), n, 1e3)
               for k, v in PER_ANALYSIS.items()}
    for layer in ("kriging", "lowrank", "mle", "nm"):
        metrics[f"{layer}.host_idle_ms"] = ratio(
            program_trace.layer_total(idle, layer), n, 1e3)
    inside = sum(v for k, v in syncs.items() if k is not None)
    metrics["host.syncs_per_analysis"] = inside / n if program.spans else None
    metrics.update({k: ratio(device.get(v), clips, 1e3)
                    for k, v in PER_CLIP.items()})
    metrics.update(simplex_metrics(device, idle, n, counts))
    metrics["eigsh.columns_per_rank"] = ratio(counts.get("eigsh.columns"),
                                              counts.get("eigsh.kept"))
    metrics["eigsh.applications_per_clip"] = ratio(
        counts.get("eigsh.applications"), clips)
    return metrics


def simplex_metrics(device, idle, n, counts):
    """The ellipse fit's simplex readings of the module's docstring."""
    offered = counts.get("nm.lanes_offered")
    calls = ratio(offered, counts.get("mle.lanes"), n)
    trips = counts.get("nm.iterations")
    metrics = {
        "nm.skip_share": None if not offered else
        1.0 - counts.get("nm.lanes_evaluated", 0) / offered,
        "nm.calls_per_analysis": ratio(calls, n),
        "k5.launches_per_call": ratio(counts.get("k5.launches", 0), calls),
        "nm.evaluate_us_per_call": ratio(device.get("nm.evaluate"), calls,
                                         1e6),
        "nm.graph_trips_per_trip": ratio(counts.get("nm.graph_trips", 0),
                                         trips),
        "nm.spare_trips_per_fit": ratio(counts.get("nm.spare_trips", 0), n)}
    for name in PER_TRIP:
        metrics[f"{name}.device_us_per_trip"] = ratio(device.get(name),
                                                      trips, 1e6)
        metrics[f"{name}.idle_us_per_trip"] = ratio(idle.get(name), trips,
                                                    1e6)
    return metrics


def readings(result, hspans, latencies, works, elapsed, setup_s, counts):
    """The probe's JSON object from a window's raw results."""
    names = {tracing.WINDOW, *hspans.seconds}
    program = program_trace.from_kineto(result, annotations=names)
    trace = tracing.from_kineto(result, names)
    own = program_trace.program_span_names()
    trace.device = [e for e in trace.device if e.name not in own]
    lo, hi = trace.window()
    n = len(latencies)
    clips = sum(s.name == "eigsh.clip" and lo <= s.start < hi
                for s in program.spans)
    device = program_trace.device_seconds_by_span(program, lo, hi)
    idle = program_trace.idle_by_span(program, trace.spans, lo, hi)
    syncs = program_trace.syncs_by_span(program, lo, hi)
    total = sum(device.values())
    ordered = sorted(latencies)
    out = {"n": n, "rate": n / elapsed, "setup_s": setup_s,
           "latency_s": {"median": ordered[n // 2],
                         "p95": ordered[min(n - 1, (95 * n) // 100)],
                         "max": ordered[-1]},
           "window_s": hi - lo, "clips": clips, "counts": counts,
           "device_ms_by_span": {str(k): v * 1e3 / n
                                 for k, v in device.items()},
           "idle_ms_by_span": {k: v * 1e3 / n for k, v in idle.items()},
           "syncs_by_span": {str(k): v / n for k, v in syncs.items()},
           "launched_in_spans": ratio(total - device.get(None, 0.0), total),
           "idle_s": sum(idle.values()),
           "harness_idle_s": sum(s for _, s in tracing.idle_gaps(trace)),
           "busy_s": tracing.busy_seconds(trace)}
    out["metrics"] = program_metrics(program, device, idle, syncs, n, clips,
                                     counts)
    ctx = harness.Context(latencies, works, elapsed, setup_s, trace,
                          dict(hspans.seconds))
    for name in HARNESS_METRICS:
        out["metrics"][name] = harness.reader(name).read(ctx)
    return out


def probe(cell, seed, seconds, spans=True, device="cuda", t0=None):
    """The probe's JSON object for one window of `cell`."""
    t0 = time.perf_counter() if t0 is None else t0
    latencies, works, elapsed, setup_s, hspans, result, counts = (
        window_trace(cell, seed, seconds, spans, device, t0))
    out = {"cell": cell.name, "seed": seed, "spans": bool(spans)}
    out.update(readings(result, hspans, latencies, works, elapsed, setup_s,
                        counts))
    if torch.device(device).type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
        out["power_limit"] = harness.power_limit()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", help="a JSON-lines file to append the object to")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_probe: no CUDA device", file=sys.stderr)
        return 3
    out = probe(harness.find_cell(args.workload), args.seed, args.seconds,
                bool(args.spans), "cuda", T0)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
