"""The program's spans in a traced window, on recorded event lists:
device time put down to the innermost span open at each operation's
launch, idle gaps cut at the spans' edges, synchronising calls counted
inside spans only; and a CPU profiler run read the same way."""

import pytest
import torch

from bench_torch import program_trace as pt
from bench_torch.tracing import WINDOW, Event


def recorded():
    # the window is [0, 10]; one analysis (the harness's span) holds a
    # kriging call with a factor and a column loop
    spans = [
        Event("kriging.call", 1.0, 9.0),
        Event("kriging.factor", 1.5, 3.0),
        Event("kriging.columns", 4.0, 8.0),
    ]
    ops = [
        pt.Op("potrf", 1.8, 2.6, 1.6),  # launched in the factor
        pt.Op("trsm", 3.2, 3.6, 2.9),  # queued in the factor, runs after it
        pt.Op("gemm", 4.5, 7.0, 4.1),  # in the columns
        pt.Op("copy", 8.2, 8.5, 8.1),  # in the call, after the columns
        pt.Op("fill", 9.5, 11.0, 9.4),  # the harness's own, cut at 10
        pt.Op("Memset", 0.2, 0.4, None),  # no launch in the trace
    ]
    syncs = [Event("cudaStreamSynchronize", 2.6, 2.65),
             Event("cudaStreamSynchronize", 8.55, 8.6),
             Event("cudaDeviceSynchronize", 9.2, 9.3),  # the harness's
             Event("cudaStreamSynchronize", 10.5, 10.6)]  # after the window
    harness = [Event(WINDOW, 0.0, 10.0), Event("analysis", 0.5, 9.3)]
    return pt.Program(spans, ops, syncs), harness


def test_device_time_goes_to_the_innermost_span_at_launch():
    program, _ = recorded()
    by = pt.device_seconds_by_span(program, 0.0, 10.0)
    assert by == pytest.approx({"kriging.factor": 0.8 + 0.4,
                                "kriging.columns": 2.5,
                                "kriging.call": 0.3,
                                None: 0.5 + 0.2})
    assert pt.layer_total(by, "kriging") == pytest.approx(4.0)
    assert pt.layer_total(by, "eigsh") is None


def test_idle_gaps_are_cut_at_span_edges():
    program, harness = recorded()
    idle = pt.idle_by_span(program, harness, 0.0, 10.0)
    # gaps [0, 0.2] [0.4, 1.8] [2.6, 3.2] [3.6, 4.5] [7.0, 8.2] [8.5, 9.5]
    assert idle == pytest.approx({
        WINDOW: 0.2 + 0.1 + 0.2,  # [0, 0.2], [0.4, 0.5], [9.3, 9.5]
        "analysis": 0.5 + 0.3,  # [0.5, 1.0], [9.0, 9.3]
        # [1.0, 1.5] [3.0, 3.2] [3.6, 4.0] [8.0, 8.2] [8.5, 9.0]
        "kriging.call": 0.5 + 0.2 + 0.4 + 0.2 + 0.5,
        "kriging.factor": 0.3 + 0.4,  # [1.5, 1.8], [2.6, 3.0]
        "kriging.columns": 0.5 + 1.0,  # [4.0, 4.5], [7.0, 8.0]
    })
    gaps = pt.idle_gaps(program, 0.0, 10.0)
    assert sum(idle.values()) == pytest.approx(sum(b - a for a, b in gaps))


def test_syncs_are_counted_by_span_inside_the_window():
    program, _ = recorded()
    assert pt.syncs_by_span(program, 0.0, 10.0) == {
        "kriging.factor": 1, "kriging.call": 1, None: 1}


def test_nothing_to_read_without_program_spans():
    program, harness = recorded()
    bare = pt.Program([], program.ops, program.syncs)
    assert pt.device_seconds_by_span(bare, 0.0, 10.0) == pytest.approx(
        {None: 0.8 + 0.4 + 2.5 + 0.3 + 0.5 + 0.2})
    assert pt.layer_total(pt.device_seconds_by_span(bare, 0.0, 10.0),
                          "kriging") is None
    assert pt.layer_total(pt.idle_by_span(bare, harness, 0.0, 10.0),
                          "kriging") is None
    assert pt.syncs_by_span(bare, 0.0, 10.0) == {None: 3}


def test_innermost_handles_siblings_and_unsorted_times():
    spans = [Event("a", 0, 10), Event("b", 1, 2), Event("c", 3, 4)]
    got = pt.innermost(spans, [3.5, 1.5, 2.5, 11.0, 0.5])
    assert got == ["c", "b", "a", None, "a"]


def test_a_cpu_profiler_run_keeps_program_spans_only():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("analysis"):
            with torch.profiler.record_function("kriging.call"):
                torch.ones(8).sum()
    program = pt.from_kineto(prof.profiler.kineto_results,
                             names={"kriging.call"})
    assert [s.name for s in program.spans] == ["kriging.call"]
    assert program.ops == [] and program.syncs == []


class Fake:
    """A kineto event as ``from_kineto`` reads it (times in ns)."""

    def __init__(self, name, cuda, start, end, corr, linked=0):
        self._name, self._cuda = name, cuda
        self._start, self._end, self._corr, self._linked = (start, end, corr,
                                                            linked)

    def name(self):
        return self._name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


class FakeResult:
    def __init__(self, events):
        self._events = events

    def trace_start_ns(self):
        return 0

    def events(self):
        return self._events


def test_launches_are_found_through_pytorch_then_the_runtime():
    s = 1_000_000_000  # ns a second
    events = [
        Fake("analysis", False, 0, 9 * s, 1),
        Fake("kriging.factor", False, 1 * s, 4 * s, 2),
        Fake("aten::mm", False, 2 * s, 3 * s, 3),
        Fake("cudaLaunchKernel", False, 2 * s, 2 * s + 10, 3),  # mm's
        Fake("cudaLaunchKernel", False, 3 * s + 5, 3 * s + 9, 77),  # ctypes
        Fake("cudaStreamSynchronize", False, 3 * s + 10, 4 * s - 10, 78),
        Fake("gemm", True, 5 * s, 6 * s, 77, linked=3),
        Fake("pairwise_tile_kernel", True, 6 * s, 7 * s, 77, linked=0),
        Fake("orphan", True, 7 * s, 8 * s, 99, linked=0),
        Fake("kriging.factor", True, 1 * s, 7 * s, 0),  # the device's copy
        Fake("analysis", True, 0, 9 * s, 0),
    ]
    program = pt.from_kineto(FakeResult(events), names={"kriging.factor"},
                             annotations={"analysis"})
    assert [s_.name for s_ in program.spans] == ["kriging.factor"]
    assert [(o.name, o.launch) for o in program.ops] == [
        ("gemm", 2.0), ("pairwise_tile_kernel", 3.000000005),
        ("orphan", None)]
    assert [c.name for c in program.syncs] == ["cudaStreamSynchronize"]
    by = pt.device_seconds_by_span(program, 0.0, 9.0)
    assert by == pytest.approx({"kriging.factor": 2.0, None: 1.0})


def _span_probe():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "tools" / "span_probe.py"
    spec = importlib.util.spec_from_file_location("span_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["st1deg.analysis", "ell1deg.variants"])
def test_span_probe_reads_a_small_cell_on_the_cpu(name):
    from bench_torch import harness
    from bench_torch.tests.small import SECONDS, SMALL

    probe = _span_probe()
    cell = harness.find_cell(name, overrides=SMALL[name])
    on = probe.probe(cell, 20240101, SECONDS.get(name, 0.2), device="cpu")
    off = probe.probe(cell, 20240101, SECONDS.get(name, 0.2), spans=False,
                      device="cpu")
    m = on["metrics"]
    # the CPU has no device operations: no device or idle time to read
    assert m["kriging.factor_ms"] is None and on["launched_in_spans"] is None
    if name == "st1deg.analysis":
        assert on["counts"]["kriging.column_blocks"] > 0 and on["clips"] == 0
        assert m["host.syncs_per_analysis"] == 0
    else:
        assert on["clips"] == on["n"] > 0
        assert m["eigsh.applications_per_clip"] == m["eigsh.sweeps_per_clip"]
        assert m["eigsh.columns_per_rank"] > 1
    # without spans the window holds none of them
    assert off["metrics"]["host.syncs_per_analysis"] is None
    assert off["clips"] == 0
