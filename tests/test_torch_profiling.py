"""The port's spans and counters (``utils/profiling``) on the CPU, small
grids: off, a span is the shared null context and a profiler sees none;
on, each entry point records its spans nested as its layers are; the
outputs are the same bit for bit either way; the counters count what the
code does."""

import json

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch import (
    LowRankPSD,
    ellipse_covariance_operator,
    ensemble_from_kernel,
    explained_variance_clip_lowrank,
    kriging_from_kernel,
    lowrank_ensemble_step,
)
from glomargridding_tpu_torch.models import kernel_kriging as tkk
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat
from glomargridding_tpu_torch.ops.variogram import MaternVariogram
from glomargridding_tpu_torch.utils import profiling
from glomargridding_tpu_torch.utils.profiling import COUNTS, span, spans_on

torch.set_num_threads(2)

N_BLOCKS = 5
CLIP = {"target_variance_fraction": 0.9, "k0": 16, "max_rank": 256,
        "n_iter": 2}


def _grid():
    lat = np.repeat(np.arange(-80.0, 90.0, 10.0), 36)  # 17 x 36 cells
    lon = np.tile(np.arange(-175.0, 180.0, 10.0), 17)
    return lat, lon


def _month(m=40, seed=0):
    g = np.random.default_rng(seed)
    lat, _ = _grid()
    idx = np.sort(g.choice(lat.size, m, replace=False))
    return idx, g.normal(size=m), np.diag(0.1 + 0.05 * g.random(m))


def _kernel():
    return tkk.variogram_kernel(MaternVariogram(psill=1.2, range=1500.0))


def run_kriging():
    idx, y, e = _month()
    return tuple(kriging_from_kernel(_kernel(), *_grid(), idx, y, e,
                                     variance=1.2, n_blocks=N_BLOCKS,
                                     device="cpu"))


def run_ensemble():
    idx, y, e = _month()
    noise = np.random.default_rng(1).normal(size=(6, idx.size))
    return ensemble_from_kernel(_kernel(), *_grid(), idx, y, e, n_members=6,
                                n_blocks=N_BLOCKS, noise=noise, device="cpu")


def _operator():
    """The bf16-stored ellipse covariance of 300 points (K2's plain twin
    on the CPU)."""
    g = np.random.default_rng(2)
    n = 300
    lat = torch.as_tensor(np.sort(g.uniform(-60, 60, n)), dtype=torch.float32)
    lon = torch.as_tensor(g.uniform(-180, 180, n), dtype=torch.float32)
    Lx, Ly, theta, sd = (torch.as_tensor(a, dtype=torch.float32) for a in (
        g.uniform(800, 2000, n), g.uniform(400, 800, n),
        g.uniform(-np.pi, np.pi, n), g.uniform(0.5, 1.5, n)))
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, theta)
    return ellipse_covariance_operator(
        torch.deg2rad(lat), torch.deg2rad(lon),
        torch.stack([s00, s01, s11], dim=-1), torch.sqrt(s00 * s11 - s01**2),
        sd, v=1.5, store="bf16")


def run_clip(op=None):
    mv, n, trace = _operator()
    gen = torch.Generator().manual_seed(3)
    psd = explained_variance_clip_lowrank(op(mv) if op else mv, n=n,
                                          trace=trace, generator=gen, **CLIP)
    return psd.vectors, psd.gains, psd.floor


def run_step():
    vectors, gains, floor = run_clip()
    psd = LowRankPSD(vectors, gains, floor).pad_rank(32)
    g = np.random.default_rng(4)
    idx = torch.as_tensor(np.sort(g.choice(psd.n, 30, replace=False)))
    y = torch.as_tensor(g.normal(size=30), dtype=torch.float32)
    e = torch.full((30,), 0.1)
    noise = tuple(torch.as_tensor(g.normal(size=s), dtype=torch.float32)
                  for s in ((psd.n, 4), (psd.rank, 4), (30, 4)))
    res, members = lowrank_ensemble_step(psd, idx, y, e, n_members=4,
                                         noise=noise)
    return (*res, members)


ENTRIES = {"kriging": run_kriging, "ensemble": run_ensemble,
           "clip": run_clip, "step": run_step}

# each entry's spans: (child, parent) pairs, the parent the innermost
# span that holds the child
NESTING = {
    "kriging": [("kriging.inputs", "kriging.call"),
                ("kriging.factor", "kriging.call"),
                ("kriging.inverse", "kriging.call"),
                ("kriging.columns", "kriging.call")],
    "ensemble": [("kriging.inputs", "kriging.call"),
                 ("kriging.factor", "kriging.call"),
                 ("kriging.members", "kriging.call"),
                 ("kriging.columns", "kriging.call")],
    "clip": [("assembly.store", "assembly.operator"),
             ("eigsh.sweep", "eigsh.clip"), ("eigsh.cholqr", "eigsh.clip"),
             ("eigsh.ritz", "eigsh.clip"), ("eigsh.lock", "eigsh.clip")],
    "step": [("lowrank.inputs", "lowrank.call"),
             ("lowrank.states", "lowrank.call"),
             ("lowrank.solve", "lowrank.call"),
             ("lowrank.rows", "lowrank.call"),
             ("lowrank.members", "lowrank.call"), ("lowrank.pad", None)],
}


def recorded(fn):
    """(fn's output, [(name, start, end)] of the program's spans that a
    ``torch.profiler`` run of it records)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    result = prof.profiler.kineto_results
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in result.events()
             if e.name() in profiling.SPANS]
    return out, spans


def parent(spans, child):
    """The innermost recorded span that holds `child`, or None."""
    name, a, b = child
    holders = [s for s in spans if s is not child and s[1] <= a
               and b <= s[2] and (s[2] - s[1]) > (b - a)]
    return min(holders, key=lambda s: s[2] - s[1], default=None)


def test_span_is_the_shared_null_context_when_off():
    assert not profiling._spans_on
    for name in ("kriging.call", "eigsh.sweep", "not.declared"):
        assert span(name) is profiling._NULL
    with spans_on():
        assert span("kriging.call") is not profiling._NULL
    assert span("kriging.call") is profiling._NULL


def test_spans_off_record_nothing():
    _, spans = recorded(run_kriging)
    assert spans == []


def test_an_undeclared_span_raises_when_on():
    with spans_on(), pytest.raises(ValueError, match="undeclared span"):
        span("kriging.nothing")


def test_spans_on_restores_what_it_found():
    with spans_on():
        with spans_on():
            pass
        assert profiling._spans_on
    assert not profiling._spans_on


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_on_nest_as_the_layers(entry):
    with spans_on():
        _, spans = recorded(ENTRIES[entry])
    names = {s[0] for s in spans}
    for child, outer in NESTING[entry]:
        assert child in names, child
        for s in spans:
            if s[0] == child:
                p = parent(spans, s)
                assert (p[0] if p else None) == outer, (child, p)
    assert all(n.split(".")[0] in ("kriging", "lowrank", "eigsh",
                                   "assembly") for n in names)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_are_the_same_bit_for_bit_with_spans_on(entry):
    off = ENTRIES[entry]()
    with spans_on():
        on = ENTRIES[entry]()
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_kriging_spans_come_in_order():
    with spans_on():
        _, spans = recorded(run_kriging)
    first = {}
    for name, a, _ in spans:
        first.setdefault(name, a)
    order = ["kriging.call", "kriging.inputs", "kriging.factor",
             "kriging.inverse", "kriging.columns"]
    assert sorted(order, key=first.get) == order
    # one span around the whole column loop, not one a block
    assert sum(n == "kriging.columns" for n, _, _ in spans) == 1


def test_sweeps_are_the_applications_and_the_operator_calls():
    calls, widths = [], []

    def counted(mv):
        def op(x):
            calls.append(1)
            widths.append(x.shape[1])
            return mv(x)
        return op

    before = COUNTS.copy()
    with spans_on():
        (vectors, gains, _), spans = recorded(lambda: run_clip(counted))
    sweeps = sum(n == "eigsh.sweep" for n, _, _ in spans)
    applied = COUNTS["eigsh.applications"] - before["eigsh.applications"]
    assert sweeps == applied == len(calls) > 0
    assert COUNTS["eigsh.columns"] - before["eigsh.columns"] == sum(widths)
    kept = COUNTS["eigsh.kept"] - before["eigsh.kept"]
    assert kept == int(torch.count_nonzero(gains)) > 0
    widened = COUNTS["eigsh.widenings"] - before["eigsh.widenings"]
    assert widened == sum(n == "eigsh.lock" for n, _, _ in spans) > 0


def test_column_blocks_are_counted():
    lat, _ = _grid()
    want = len(tkk._blocks(lat.size, N_BLOCKS))
    before = COUNTS["kriging.column_blocks"]
    run_kriging()
    assert COUNTS["kriging.column_blocks"] - before == want
    run_ensemble()
    assert COUNTS["kriging.column_blocks"] - before == 2 * want


def test_tri_panels_are_counted(monkeypatch):
    """ceil(n / h) panels of L^-1 a column block with diagnostics: one at
    the default height for 40 observations, three at 16 rows; none for
    the ensemble or the fields-only months."""
    lat, lon = _grid()
    blocks = len(tkk._blocks(lat.size, N_BLOCKS))
    idx, y, e = _month()
    before = COUNTS["kriging.tri_panels"]
    run_kriging()
    assert COUNTS["kriging.tri_panels"] - before == blocks
    monkeypatch.setattr(tkk, "_TRI_PANEL_ROWS", 16)
    run_kriging()
    assert COUNTS["kriging.tri_panels"] - before == blocks * (1 + 3)
    before = COUNTS["kriging.tri_panels"]
    run_ensemble()
    tkk.months_scan_kriging(_kernel(), lat, lon, idx[None], y[None],
                            e[None], variance=1.2, diagnostics=False,
                            device="cpu")
    assert COUNTS["kriging.tri_panels"] == before
    tkk.months_scan_kriging(_kernel(), lat, lon, idx[None], y[None],
                            e[None], variance=1.2, n_blocks=N_BLOCKS,
                            device="cpu")
    assert COUNTS["kriging.tri_panels"] - before == blocks * 3


def test_counters_are_declared():
    assert set(COUNTS) <= set(profiling.COUNTERS)
    with pytest.raises(ValueError, match="undeclared counter"):
        profiling.count("k9.launches")
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert len(set(profiling.COUNTERS)) == len(profiling.COUNTERS)
    assert "kriging.tri_panels" in profiling.COUNTERS


def test_device_trace_turns_spans_on_for_its_extent(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        assert profiling._spans_on
        run_kriging()
    assert not profiling._spans_on
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"kriging.call", "kriging.factor", "kriging.columns"} <= names


class _Event:
    """A kineto event as ``span_device_seconds`` reads it (times in ns)."""

    def __init__(self, name, cuda, start, end, corr, linked=0):
        self._name, self._cuda = name, cuda
        self._start, self._end = start, end
        self._corr, self._linked = corr, linked

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


def _profiler(events):
    """A stopped profiler whose kineto results hold `events`."""
    result = type("Result", (), {"events": lambda self: events})()
    return type("Prof", (), {"profiler": type("P", (), {
        "kineto_results": result})()})()


def test_span_device_seconds_goes_to_the_innermost_span_at_launch():
    s = 1_000_000_000  # ns a second
    events = [
        _Event("eigsh.clip", False, 0, 9 * s, 1),
        _Event("eigsh.sweep", False, 1 * s, 2 * s, 2),
        _Event("aten::mm", False, 1 * s + 5, 2 * s - 5, 3),
        _Event("cudaLaunchKernel", False, 1 * s + 6, 1 * s + 9, 3),
        _Event("eigsh.cholqr", False, 3 * s, 4 * s, 4),
        _Event("cudaLaunchKernel", False, 3 * s + 1, 3 * s + 2, 50),  # ctypes
        _Event("aten::sum", False, 5 * s, 5 * s + 9, 5),  # in the clip only
        _Event("aten::add", False, 10 * s, 10 * s + 9, 6),  # outside
        _Event("gemm", True, 2 * s, 4 * s, 77, linked=3),
        _Event("tile_kernel", True, 4 * s, 5 * s, 50, linked=0),
        _Event("reduce", True, 5 * s, 6 * s + s // 2, 78, linked=5),
        _Event("add", True, 10 * s, 10 * s + s // 4, 79, linked=6),
        _Event("Memset", True, 11 * s, 12 * s, 99, linked=0),  # no launch
        _Event("eigsh.sweep", True, 1 * s, 2 * s, 0),  # the device's copy
    ]
    got = profiling.span_device_seconds(_profiler(events))
    assert got == pytest.approx({"eigsh.sweep": 2.0, "eigsh.cholqr": 1.0,
                                 "eigsh.clip": 1.5, None: 1.25})


def test_span_device_seconds_of_a_cpu_run_is_empty(tmp_path):
    # the kriging runs on the CPU: no device operation to put down
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        run_kriging()
    assert profiling.span_device_seconds(prof) == {}
