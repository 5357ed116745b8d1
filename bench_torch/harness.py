"""The benchmark's general part: find a cell's pieces by the names in
``BENCHMARK.json``, set it up, measure its window, read its metrics and
compare what the window produced with the plain reference.

A cell's pieces, each found by name and none named in this file:

- ``configs/<config>.json``: the configuration as it runs;
- ``traffic/<mix>.json``: the mix, read by ``traffic.plan``; its
  ``entry`` names the unit of work, ``entries/<entry>.py``, which builds
  the configuration's state, drives the port and names its plain
  reference, ``reference/<name>.py``;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``, which
  returns None where it finds nothing to read. A metric split by the
  end-to-end metric it moves, ``<metric>.<suffix>``, is read by
  ``<metric>.py`` where it has no file of its own;
- ``limits/<cell>.json``: the limit of each number the cell compares.
"""

from dataclasses import dataclass, field
import importlib
import importlib.util
import json
import math
from pathlib import Path
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import tracing
from .traffic import plan

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


class NoCard(RuntimeError):
    """The run needs more CUDA devices than this machine has."""


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def entry(self):
        return importlib.import_module(
            f"bench_torch.entries.{self.mix['entry']}")

    @property
    def reference(self):
        return importlib.import_module(
            f"bench_torch.reference.{self.entry.REFERENCE}")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def merged(base, override):
    """`base` with `override`'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (override or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def find_cell(name, bench=None, root=BENCH, overrides=None):
    """The ``Cell`` of workload `name` in `bench` (``BENCHMARK.json`` at
    the checkout's root by default); `overrides` replaces keys of its
    ``config``, ``mix`` and ``limits`` (the CPU tests cut the sizes)."""
    if bench is None:
        bench = read_json(root.parent / "BENCHMARK.json")
    overrides = overrides or {}
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = merged(read_json(root.parent / configs[w["config"]]["file"]),
                    overrides.get("config"))
    mix = merged(read_json(root / "traffic" / f"{w['traffic']}.json"),
                 overrides.get("mix"))
    limits_path = root / "limits" / f"{name}.json"
    limits = read_json(limits_path) if limits_path.exists() else {}
    limits = merged(limits, overrides.get("limits"))

    def listed(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if listed(m)
                 and ("workloads" in m or m["moves"] in reported)]
    return Cell(name, config, mix, int(w["chips"]), e2e, per_layer, limits)


def reader(metric, root=BENCH):
    """The module that reads `metric`: ``metrics/<metric>.py``, or for a
    metric split by what it moves, that of the name before its last
    ``.``."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader(metric.rsplit(".", 1)[0], root)
    spec = importlib.util.spec_from_file_location(
        "bench_torch_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Context:
    """What a metric's reader reads: the window's analyses, their
    latencies and counted work, set-up, and in a traced run the trace and
    the harness's spans."""

    latencies: list
    works: list
    elapsed: float
    setup_s: float
    trace: tracing.Trace | None = None
    spans: dict = field(default_factory=dict)

    def total(self, key):
        """The sum of `key` over the window's analyses that count it, or
        None where none does."""
        values = [w[key] for w in self.works if key in w]
        return sum(values) if values else None


def card_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def power_limit():
    """The card's power limit as nvidia-smi reports it, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def keep_set(entry, mix, seed):
    """Pool indices whose first analysis in the window is compared: the
    longest and others drawn from the seed."""
    longest = entry.longest()
    others = [k for k in range(len(entry.items)) if k != longest]
    rng = np.random.default_rng([seed, 1])
    n = min(len(others), max(0, int(mix["compare"]) - 1))
    return {longest, *(int(k) for k in rng.choice(others, n, replace=False))}


def window(entry, order, keep, seconds, spans, sync):
    """The measured window: analyses one after another from the cycle
    `order`, each ending in `sync`, until the first completion at or
    after `seconds`. Returns (latencies, works, kept outputs by pool
    index, elapsed seconds)."""
    latencies, works, kept = [], [], {}
    i = 0
    with torch.profiler.record_function(tracing.WINDOW):
        w0 = time.perf_counter()
        while True:
            k = order[i % len(order)]
            a = time.perf_counter()
            with spans("analysis"):
                out, work = entry(k)
            sync()
            b = time.perf_counter()
            latencies.append(b - a)
            works.append(work)
            if k in keep and k not in kept:
                kept[k] = out
            del out
            i += 1
            if b - w0 >= seconds:
                return latencies, works, kept, b - w0


def set_precision(control):
    """The configuration's precision: true f32 products, TF32 off. The
    control turns TF32 on (the step that would tempt a later change)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(control)
    torch.backends.cudnn.allow_tf32 = bool(control)
    torch.set_float32_matmul_precision("high" if control else "highest")


def cards():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def set_up(cell, seed, device, control, spans, sync):
    """(entry, order, keep): the cell's state and inputs made from the
    seed, every shape the mix uses warmed up."""
    unit = cell.entry
    state = unit.build(cell.config, device, seed, control)
    items, order = plan(cell.mix, seed)
    entry = unit.Entry(state, cell.config, cell.mix, items, seed, spans)
    for k in entry.warm_up():
        entry(k)
        sync()
    spans.seconds.clear()  # the window's spans only
    return entry, order, keep_set(entry, cell.mix, seed)


def measure(entry, order, keep, seconds, spans, sync, traced, cuda):
    """The window, under ``torch.profiler`` when `traced`: (latencies,
    works, kept, elapsed, trace or None)."""
    if not traced:
        return (*window(entry, order, keep, seconds, spans, sync), None)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profiler:
        out = window(entry, order, keep, seconds, spans, sync)
    trace = tracing.from_kineto(profiler.profiler.kineto_results,
                                {tracing.WINDOW, *spans.seconds})
    return (*out, trace)


def judge(numbers, limits, log):
    """(correct, checks): each compared number beside its limit, printed
    last on standard error; a number without a limit, or a limit without
    its number, is not correct."""
    checks, correct = {}, bool(numbers)
    for name in [*numbers, *(k for k in limits if k not in numbers)]:
        value, limit = numbers.get(name), limits.get(name)
        correct = correct and (limit is not None and value is not None
                               and math.isfinite(value) and value <= limit)
        checks[name] = {"value": value, "limit": limit}
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}",
            file=sys.stderr)
    return correct, checks


def report(cell, ctx, device, peak):
    """The result line's metrics (the cell's end-to-end ones untraced,
    its per-layer ones traced), device and, traced, breakdown."""
    cuda = device.type == "cuda"
    metrics = {}
    for m in cell.end_to_end if ctx.trace is None else cell.per_layer:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card_name(device),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"attempted": len(ctx.latencies), "failed": 0,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        lo, hi = ctx.trace.window()
        dev["busy_s"] = tracing.busy_seconds(ctx.trace)
        dev["window_s"] = hi - lo
        result["breakdown"] = tracing.breakdown(ctx.trace)
    return result


def run(cell, seed, seconds, traced, device, t0, control=False,
        log=print, need_card=True):
    """One run of `cell`; returns the result line's dict. `t0` is the
    host clock at the process's start."""
    if need_card and cards() < cell.chips:
        raise NoCard(f"{cell.name} needs {cell.chips} CUDA device(s); "
                     f"this machine has {cards()}")
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tag = (f"[{card_name(device)} x{cards() if cuda else 0} "
           f"{power_limit() if cuda else 'no card'}]")

    def say(*parts):
        log(tag, *parts)

    set_precision(control)
    say(f"cell {cell.name} seed {seed} seconds {seconds} trace {int(traced)}"
        f"{' control' if control else ''} torch {torch.__version__}")
    spans = tracing.Spans(traced, sync)
    entry, order, keep = set_up(cell, seed, device, control, spans, sync)
    setup_s = time.perf_counter() - t0
    say(f"setup_s {setup_s:.4f}")

    latencies, works, kept, elapsed, trace = measure(
        entry, order, keep, seconds, spans, sync, traced, cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    say(f"window {elapsed:.4f} s, {len(latencies)} analyses, latency "
        f"median {statistics.median(latencies):.6f} p95 "
        f"{p95(latencies) if len(latencies) > 1 else latencies[0]:.6f} "
        f"max {max(latencies):.6f} s")
    say(f"memory_peak_bytes {peak}")
    for key, value in entry.info(works).items():
        say(f"{key} {value}")

    result = report(cell, Context(latencies, works, elapsed, setup_s, trace,
                                  dict(spans.seconds)), device, peak)
    if traced:
        dev = result["device"]
        if need_card and dev["busy_s"] <= 0.0:
            raise RuntimeError("the profiler saw no device time in the window")
        say(f"busy_s {dev['busy_s']:.6f} window_s {dev['window_s']:.6f}")

    # the comparison, once the window has closed and the peak is read
    set_precision(False)
    entry.release(set(kept))
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    numbers = entry.compare(kept, cell.reference)
    say(f"compared {len(kept)} analyses (pool {sorted(kept)}) in "
        f"{time.perf_counter() - r0:.2f} s")
    correct, checks = judge(numbers, cell.limits, log)
    return {"correct": correct, **result, "checks": checks}
