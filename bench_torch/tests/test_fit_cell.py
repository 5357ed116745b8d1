"""The ellipse fit's cell, ``ell1deg.fit``, cut to a size the CPU runs in
seconds (a 6-degree grid, 4 strided selections of 450 cells in 464
lanes, 64 training columns a fit, 32 lanes of each compared selection),
with the cell's own code, reference and limits: the plain reference is
the port's fit in float64; a sound run is correct; the control and a
loose simplex are not; the cell's per-layer metrics are found by name
and read what the entry counts. The control and the loose simplex at the
cell's own size need the card, and skip without one; run them there with

    python3 -m pytest -q bench_torch/tests/test_fit_cell.py
"""

import time

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch import EllipseBuilder
from glomargridding_tpu_torch.models.ellipse import estimate

from bench_torch import harness, tracing
from bench_torch.entries import fit as entry
from bench_torch.families import ellipse_fit
from bench_torch.reference import ellipse_fit as reference

from .small import CLIP

NAME = "ell1deg.fit"
SMALL = {"config": {"grid": {"step_deg": 6.0}, "clip": CLIP,
                    "chunk_size": 464, "fit": {"max_train_cols": 64}},
         "mix": {"pool": 4, "lanes_compared": 32}}
# long enough for the window to reach the 3 compared selections (a fit
# takes ~1 s here)
SECONDS = 4.0
SEED = 2718281828
CARD_SEEDS = (3141592653, 2718281828, 1414213562)


def small_run(seed=SEED, control=False):
    cell = harness.find_cell(NAME, overrides=SMALL)
    return harness.run(cell, seed, SECONDS, False, "cpu", time.perf_counter(),
                       control=control, need_card=False,
                       log=lambda *a, **k: None)


def tf32(x):
    """x rounded to TF32's 10-bit mantissa, as the card's TF32 GEMM
    rounds its operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def loose(fit_cells, tol):
    """``fit_cells`` with the simplex's tolerance set to `tol` (the
    program's alone: the reference keeps the configuration's)."""
    return lambda self, *a, **k: fit_cells(self, *a, **{**k, "tol": tol})


def test_the_reference_is_the_port_in_f64():
    """The port's fit of the same cube in float64 against the reference:
    the objective at the port's optimum to 1e-12 relative of the range
    the tied columns' choices give (the same f64 terms, summed in another
    order: ~1e-16; where a lane's k-th nearest column is one of a tied
    pair the port keeps either, and the objective moves by ~1e-4); the
    optimum itself, on the lanes without such a tie (another column is
    another objective), on at least 95% of them: its objective to 1e-9
    and its parameters to 1e-5 (km over km; radians), since the two
    simplexes take the same path until a comparison of two values within
    rounding of each other falls the other way, and then close within
    `tol` (1e-3 km on lengths of 300 km and more) of each other; ~2% of
    lanes have two optima."""
    cell = harness.find_cell(NAME, overrides=SMALL)
    state = ellipse_fit.build(cell.config, torch.device("cpu"), SEED, False)
    T = state.cube.shape[0]
    lat = np.unique(state.lat.numpy()).astype(np.float64)
    lon = np.unique(state.lon.numpy()).astype(np.float64)
    b64 = EllipseBuilder(state.cube.double().reshape(T, lat.size, lon.size),
                         {"time": np.arange(T), "latitude": lat,
                          "longitude": lon})
    centres = np.arange(1, state.n, 9)
    fits = b64.fit_cells(centres, state.model, chunk_size=224,
                         **state.fit_kw)
    fit = state.fit_kw
    r = reference.fit(state.cube, state.lat, state.lon,
                      torch.as_tensor(centres), fits.x, nu=1.5,
                      k=state.columns(), min_distance=fit["min_distance"],
                      max_distance=fit["max_distance"],
                      delta_x_method=fit["delta_x_method"],
                      guesses=fit["guesses"], bounds=fit["bounds"],
                      tol=fit["tol"], maxiter=600)
    off = torch.clamp(torch.maximum(r["low"] - fits.fun,
                                    fits.fun - r["high"]), min=0.0)
    assert float((off / torch.abs(r["f_program"])).max()) <= 1e-12
    assert bool((r["high"] > r["low"]).any())  # ties are on the path
    untied = r["high"] == r["low"]
    same = torch.all(torch.abs(fits.x - r["x"])
                     <= 1e-5 * torch.abs(r["x"]).clamp(min=1.0), dim=1) & (
        torch.abs(r["f_program"] - r["f"]) <= 1e-9)
    assert int(untied.sum()) >= 50
    assert float(same[untied].double().mean()) >= 0.95


def test_a_sound_run_is_correct():
    result = small_run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"nll_err", "opt_gap", "param_miss"}


def test_the_control_is_not_correct(monkeypatch):
    """TF32 does nothing on the CPU, so the control's product is rounded
    here as the card rounds it."""
    normalised = estimate._normalised_samples

    def cor_matmul(x):
        xn = tf32(normalised(x))
        return xn.T @ xn
    monkeypatch.setattr(estimate, "_cor_matmul", cor_matmul)
    result = small_run(control=True)
    assert not result["correct"], result["checks"]
    nll = result["checks"]["nll_err"]
    assert nll["value"] > nll["limit"]


def test_a_loose_simplex_is_not_correct(monkeypatch):
    """`tol` 1 on the program's simplex. Not 1e-1: its `xatol` is in km
    (and radians), so at 1e-1 the simplex has already closed in f, and
    the optima it gives are the sound run's, within the spread of the
    lanes drawn (on the H100: `opt_gap` 2.23-2.83, `param_miss`
    0.44-0.45, against sound 2.54-3.99 and 0.42-0.46)."""
    monkeypatch.setattr(EllipseBuilder, "fit_cells",
                        loose(EllipseBuilder.fit_cells, 1.0))
    result = small_run()
    assert not result["correct"], result["checks"]


def test_the_per_layer_metrics_are_found_by_name():
    cell = harness.find_cell(NAME)
    assert [m["name"] for m in cell.end_to_end] == ["analyses_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_pct", "nm.iterations_per_fit", "mle.ms_per_iteration",
        "mle.roofline"}
    works = [{"nm.iterations": 300, "nm.points": 1212, "mle.lanes": 2048,
              "fit_least_ms": 50.0},
             {"nm.iterations": 200, "nm.points": 812, "mle.lanes": 2048,
              "fit_least_ms": 35.0}]
    trace = tracing.Trace(
        device=[tracing.Event("kernel", 0.5, 2.0),
                tracing.Event("kernel", 3.0, 3.5)],
        spans=[tracing.Event(tracing.WINDOW, 0.0, 4.0),
               tracing.Event("fit", 0.0, 2.5),
               tracing.Event("fit", 2.5, 4.0)])
    ctx = harness.Context([2.5, 1.5], works, 4.0, 9.0, trace,
                          {"fit": [2.5, 1.5]})
    read = {m: harness.reader(m).read(ctx) for m in (
        "nm.iterations_per_fit", "mle.ms_per_iteration", "mle.roofline")}
    assert read == pytest.approx({"nm.iterations_per_fit": 250.0,
                                  "mle.ms_per_iteration": 8.0,
                                  "mle.roofline": 100 * 85e-3 / 2.0})
    # a program without the counters leaves nothing to read
    bare = harness.Context([2.5], [{"nm.iterations": 0, "mle.lanes": 0}],
                           2.5, 9.0, trace, {"fit": [2.5]})
    for m in read:
        assert harness.reader(m).read(bare) is None


def test_the_span_probe_reads_the_fit():
    """``tools/span_probe.py`` on the small cell: the fit's counters over
    the window, and its layers' idle time (the CPU has no device time)."""
    from .test_program_spans import _span_probe

    cell = harness.find_cell(NAME, overrides=SMALL)
    out = _span_probe().probe(cell, SEED, 1.0, device="cpu")
    c = out["counts"]
    assert c["mle.lanes"] == 464 * out["n"]
    assert c["nm.points"] == 4 * (1 + c["nm.shrinks"]) + 4 * c[
        "nm.iterations"]
    assert out["metrics"]["nm.host_idle_ms"] > 0
    assert out["metrics"]["nm.evaluate_ms"] is None


def test_a_fits_least_time():
    """Bytes bind: 2,025 x 4,096 x 16 B over 3.35 TB/s a pass over every
    lane's data, once to start and once a lane-iteration; the build writes
    that data and reads 4 B of correlation a (lane, column) and the
    coordinates, 0.0497 ms. The extra points an iteration may need move
    nothing, and neither does a lane's count of points."""
    a_pass = 2025 * 4096 * 16 / 3.35e12 * 1e3
    build = (2025 * 4096 * 20 + 8 * 64800) / 3.35e12 * 1e3
    assert ellipse_fit.fit_least_ms(2025, 64800, 4096, 0) == pytest.approx(
        build + a_pass, rel=1e-9)
    steps = 2025 * 110
    assert ellipse_fit.fit_least_ms(2025, 64800, 4096, steps) == \
        pytest.approx(build + (1 + 110) * a_pass, rel=1e-9)
    assert ellipse_fit.fit_least_ms(2025, 64800, 4096, steps, d=5) == \
        pytest.approx(build + (1 + 110) * a_pass, rel=1e-9)
    assert entry.misses(torch.tensor([[1000.0, 2000.0, 0.1]]),
                        torch.tensor([[2005.0, 1000.0, 0.1 + np.pi / 2
                                       + np.pi]])).tolist() == [False]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control and the fault run at the cell's own size, "
                    "on the card")
    return "cuda"


@pytest.mark.parametrize("kind", ["control", "loose"])
def test_on_the_card_the_control_and_a_loose_simplex_are_not_correct(
        card, monkeypatch, kind):
    if kind == "loose":
        monkeypatch.setattr(EllipseBuilder, "fit_cells",
                            loose(EllipseBuilder.fit_cells, 1.0))
    c = harness.find_cell(NAME)
    for seed in CARD_SEEDS:
        result = harness.run(c, seed, 15.0, False, card, time.perf_counter(),
                             control=kind == "control",
                             log=lambda *a, **k: None)
        print("reading", kind, seed,
              {k: v["value"] for k, v in result["checks"].items()})
        assert not result["correct"], (seed, result["checks"])
