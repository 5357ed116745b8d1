"""The zero-storage ellipse stream of the benchmark's 0.5-degree cell, at a
small size on the CPU: a 6-degree grid (1,800 cells) with row blocks of
64 (``n_blocks`` 30), so that at 3,000 km both the latitude band and the
longitude certificate engage.

- The port's stream operator against the plain float64 reference
  (``bench_torch/reference/ellipse_stream.py``), in float64 and float32,
  through the wide path (tiles and a GEMM) and the narrow one (the fused
  kernel's twin); the operator built at 2,700 km is read over the
  tolerance.
- The stream's spans open with spans on, and its counters count what the
  caller handed over and what ``band_stats`` says a wide application
  builds.
- The yardstick's count of the pairs within the cutoff against a
  brute-force count over every pair.
- The cell's entry, end to end, against its reference under its limits.
"""

import json
from pathlib import Path
import time

import pytest
import torch

from bench_torch import harness
from bench_torch.families import ellipse, ellipse_stream
from bench_torch.reference import ellipse_stream as reference
from glomargridding_tpu_torch import ellipse_covariance_operator
from glomargridding_tpu_torch.ops.distances import sigma_rot_flat
from glomargridding_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CELL = "ell05deg.variants"
STEP, N_BLOCKS, CUTOFF = 6.0, 30, 3000.0
# the clip's first block holds the rank it keeps with room, as at full
# size (614 in 768 here, 830 in 1,024 there), so that its pairs converge,
# or fail to, as they do there
SMALL = {
    "config": {"grid": {"step_deg": STEP}, "n_blocks": N_BLOCKS,
               "members": 8, "pad_rank": 32,
               "clip": {"k0": 768, "max_rank": 1024, "rank_multiple": 16}},
    "mix": {"observations": 60}}
# float64: the same pair function in the same precision, summed in
# another order. float32: each tile value and each of a row's ~600
# products rounds at ~6e-8 relative, so the image of unit normals is off
# by ~1e-6 of its largest entry; 1e-5 leaves 10x of room. A pair whose
# float32 haversine falls across the cutoff from the float64 one would
# move a row by ~1e-3 of its largest entry and fail it: at this size none
# does (the 2,700 km fault, below, moves the image by ~1e-1).
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def config():
    cfg = json.loads(
        (REPO / "bench_torch/configs/glomar_05deg_ellipse_stream.json")
        .read_text())
    return harness.merged(cfg, SMALL["config"])


@pytest.fixture(scope="module")
def state():
    return ellipse.State(config(), torch.device("cpu"), False)


def stream(state, dtype, max_dist=CUTOFF):
    """(matvec, n, trace) of the configuration's covariance as the stream
    in `dtype`, its radians computed in `dtype` (a pair exactly 180
    degrees apart in longitude then wraps as the reference's does)."""
    f = [t.to(dtype) for t in (state.Lx, state.Ly, state.theta)]
    s00, s01, _, s11 = sigma_rot_flat(*f)
    return ellipse_covariance_operator(
        torch.deg2rad(state.lat.to(dtype)), torch.deg2rad(state.lon.to(dtype)),
        torch.stack([s00, s01, s11], dim=-1),
        torch.sqrt(s00 * s11 - s01 * s01), state.stdev.to(dtype),
        v=float(state.cfg["nu"]), max_dist=max_dist, n_blocks=N_BLOCKS,
        store="stream", device="cpu")


def fields(state):
    return ellipse.reference_fields(state, reference, state.Lx, state.Ly,
                                    state.theta)


def columns(n, k, seed=7):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, k), generator=gen, dtype=torch.float64)


@pytest.fixture(scope="module")
def want(state):
    """C X of the reference, 24 columns (the first 8 the narrow path's)."""
    X = columns(state.n, 24)
    return X, reference.product(fields(state), X, float(state.cfg["nu"]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("width", [8, 24], ids=["narrow", "wide"])
def test_the_stream_is_the_reference(state, want, dtype, width):
    mv, n, _ = stream(state, dtype)
    stats = mv.band_stats
    assert stats["banded"] and stats["kept_pairs"] < stats["wide_pairs"]
    X, CX = want
    y = mv(X[:, :width].to(dtype))
    assert y.dtype == dtype
    err = float((y.double() - CX[:, :width]).abs().max()
                / CX[:, :width].abs().max())
    assert err < TOL[dtype], err


def test_a_shorter_cutoff_is_read_over_the_tolerance(state, want):
    mv, _, _ = stream(state, torch.float32, max_dist=2700.0)
    X, CX = want
    err = float((mv(X.float()).double() - CX).abs().max() / CX.abs().max())
    assert err > 100 * TOL[torch.float32], err


def recorded(fn):
    """The names of the program's spans a profiled run of `fn` opens, in
    order, with their (start, end)."""
    with profiling.spans_on(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("stream.")]


def test_the_stream_opens_its_spans(state):
    X = columns(state.n, 16).float()
    out = {}

    def run():
        mv, _, _ = stream(state, torch.float32)
        out["mv"] = mv
        mv(X)
        mv(X[:, :4])

    spans = recorded(run)
    names = {s[0] for s in spans}
    assert names == {"stream.plan", "stream.apply", "stream.gather",
                     "stream.tile", "stream.gemm", "stream.fused"}
    applies = [s for s in spans if s[0] == "stream.apply"]
    assert len(applies) == 2
    for name, a, b in spans:
        if name in ("stream.gather", "stream.tile", "stream.gemm",
                    "stream.fused"):
            assert any(a0 <= a and b <= b0 for _, a0, b0 in applies), name
    # off, a span is the shared null context: nothing recorded
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out["mv"](X)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("stream.")]


@pytest.mark.parametrize("max_dist", [CUTOFF, None],
                         ids=["certificate", "no-cutoff"])
def test_the_stream_counts_what_it_builds(state, max_dist):
    mv, n, _ = stream(state, torch.float32, max_dist=max_dist)
    stats = mv.band_stats
    built = stats["kept_pairs"] if max_dist else stats["wide_pairs"]
    assert stats["kept_pairs"] == built
    before = {c: profiling.COUNTS[c] for c in (
        "stream.applications", "stream.columns", "stream.built_pairs")}
    widths = [16, 9, 8, 1]
    for w in widths:
        mv(columns(n, w).float())
    delta = {c: profiling.COUNTS[c] - b for c, b in before.items()}
    wide = sum(w > 8 for w in widths)
    assert delta == {"stream.applications": len(widths),
                     "stream.columns": sum(widths),
                     "stream.built_pairs": wide * built}


@pytest.mark.parametrize("step,max_dist", [(6.0, 3000.0), (9.0, 1500.0),
                                           (12.0, 20000.0)])
def test_the_yardstick_counts_the_needed_pairs(step, max_dist):
    cfg = harness.merged(config(), {"grid": {"step_deg": step},
                                    "max_dist_km": max_dist})
    s = ellipse.State(cfg, torch.device("cpu"), False)
    f = ellipse.reference_fields(s, reference, s.Lx, s.Ly, s.theta)
    C = f.rows(0, s.n, float(cfg["nu"]))
    brute = int(torch.count_nonzero(C)) - s.n  # C's diagonal is nonzero
    assert ellipse_stream.needed_pairs(step, max_dist) == brute


def test_the_cell_runs_against_its_reference():
    cell = harness.find_cell(CELL, overrides=SMALL)
    result = harness.run(cell, 2**31 + 11, 1.0, False, "cpu",
                         time.perf_counter(), need_card=False,
                         log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {
        "stream_err", "ritz_err", "eig_res", "field_err",
        "uncertainty_err", "mask_err", "members_err"}
    assert set(result["metrics"]) == {"analyses_per_s", "setup_s"}
