"""The cell ``ell05deg.variants``: the 0.5-degree ellipse covariance as the
zero-storage stream, run by its own entry against its own reference.

On the CPU, cut to a 6-degree grid whose row blocks (``n_blocks`` 30)
engage the band and the longitude certificate at 3,000 km: the harness
finds every piece of the cell by name; a sound run is correct; the clip
under-converged and the program's cutoff cut short are not; the new
metrics read what the entry counts; ``tools/span_probe.py`` reads the
stream's counters. On the card, at the cell's own size, the control (TF32
on) and both faults are not correct on three seeds each; run it there
with

    python3 -m pytest -q -s bench_torch/tests/test_stream_cell.py -k card
"""

import copy
from pathlib import Path
import sys
import time

import pytest
import torch

from bench_torch import harness, tracing
from bench_torch.entries import stream_variant

REPO = Path(__file__).resolve().parents[2]
CELL = "ell05deg.variants"
# the clip's first block holds the rank it keeps with room, as at full
# size (614 in 768 here, 830 in 1,024 there), so that its pairs converge,
# or fail to, as they do there
SMALL = {
    "config": {"grid": {"step_deg": 6.0}, "n_blocks": 30, "members": 8,
               "pad_rank": 32,
               "clip": {"k0": 768, "max_rank": 1024, "rank_multiple": 16}},
    "mix": {"observations": 60}}
SEEDS = (3141592653, 2718281828, 1414213562)
NEW_METRICS = ("k4_roofline", "stream.ms_per_column",
               "stream.built_per_needed", "step_mfu.stream")


def run(seed=2**31 + 5, seconds=1.0, device="cpu", control=False,
        traced=False, overrides=SMALL):
    cell = harness.find_cell(CELL, overrides=overrides)
    return harness.run(cell, seed, seconds, traced, device,
                       time.perf_counter(), control=control,
                       need_card=device != "cpu", log=lambda *a, **k: None)


def under_converged(fn):
    """The clip with one sweep and its residual gate opened."""
    return lambda *a, **k: fn(*a, **{**k, "n_iter": 1, "tol": 10.0})


def cut_short(fn):
    """The program's operator cut at 2,700 km; the reference keeps the
    configuration's 3,000."""
    def wrapped(state, *a):
        short = copy.copy(state)
        short.cfg = {**state.cfg, "max_dist_km": 2700.0}
        return fn(short, *a)
    return wrapped


FAULTS = {"under_converged": ("explained_variance_clip_lowrank",
                              under_converged),
          "cut_short": ("operator", cut_short)}


def test_the_harness_finds_every_piece_by_name():
    cell = harness.find_cell(CELL)
    assert cell.entry is stream_variant
    assert Path(cell.reference.__file__).name == "ellipse_stream.py"
    assert cell.config["store"] == "stream"
    assert cell.config["max_dist_km"] == 3000.0
    assert "n_blocks" not in cell.config
    assert cell.mix["entry"] == "stream_variant"
    assert [m["name"] for m in cell.end_to_end] == ["analyses_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_pct", "eigsh.sweeps_per_clip", *NEW_METRICS}
    assert set(cell.limits) == {"stream_err", "ritz_err", "eig_res",
                                "field_err", "uncertainty_err", "mask_err",
                                "members_err"}
    files = {m: Path(harness.reader(m).__file__).name for m in NEW_METRICS}
    assert files == {"k4_roofline": "k4_roofline.py",
                     "stream.ms_per_column": "stream.ms_per_column.py",
                     "stream.built_per_needed": "stream.built_per_needed.py",
                     "step_mfu.stream": "step_mfu.py"}


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(monkeypatch, fault):
    name, wrap = FAULTS[fault]
    monkeypatch.setattr(stream_variant, name,
                        wrap(getattr(stream_variant, name)))
    result = run()
    assert not result["correct"], result["checks"]


def test_the_new_metrics_read_what_the_entry_counts():
    works = [{"k4_least_ms": 6.0, "stream.columns": 2064,
              "stream.built_pairs": 8e9, "stream.needed_pairs": 2e9,
              "f32_flops": 6.7e12}] * 2
    trace = tracing.Trace(
        device=[tracing.Event("void ellipse_tile_kernel<float, 1, true>",
                              1.0, 1.1)],
        spans=[tracing.Event(tracing.WINDOW, 0.0, 2.0)])
    ctx = harness.Context([1.0, 1.0], works, 2.0, 9.0, trace,
                          {"stream": [0.5, 1.5]})
    read = {m: harness.reader(m).read(ctx) for m in NEW_METRICS}
    assert read == pytest.approx({"k4_roofline": 100.0 * 12e-3 / 0.1,
                                  "stream.ms_per_column": 2e3 / 4128,
                                  "stream.built_per_needed": 4.0,
                                  "step_mfu.stream": 100.0 * 0.2 / 2.0})
    silent = harness.Context([1.0], [{"stream.columns": 0,
                                      "stream.built_pairs": 0,
                                      "stream.needed_pairs": 2e9}], 1.0, 9.0,
                             None, {"stream": [0.5]})
    assert {m: harness.reader(m).read(silent) for m in NEW_METRICS} == \
        dict.fromkeys(NEW_METRICS)


def test_the_span_probe_reads_the_stream():
    sys.path.insert(0, str(REPO / "tools"))
    import span_probe

    cell = harness.find_cell(CELL, overrides=SMALL)
    out = span_probe.probe(cell, 2**31 + 5, 0.5, spans=True, device="cpu")
    counts, metrics = out["counts"], out["metrics"]
    assert counts["stream.applications"] > 0
    assert counts["stream.built_pairs"] > 0
    assert metrics["stream.built_per_needed"] > 1.0
    # device readings are None without a card
    for name in ("stream.apply_ms", "stream.plan_ms", "stream.gather_ms",
                 "stream.tile_ms", "stream.gemm_ms", "stream.fused_ms",
                 "stream.share_of_sweep", "stream.ms_per_column",
                 "k4_roofline"):
        assert name in metrics


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control and the faults run at the cell's own size, "
                    "on the card")
    return "cuda"


@pytest.mark.parametrize("kind", ["control", *sorted(FAULTS)])
def test_on_the_card_the_control_and_the_faults_are_not_correct(
        card, monkeypatch, kind):
    if kind in FAULTS:
        name, wrap = FAULTS[kind]
        monkeypatch.setattr(stream_variant, name,
                            wrap(getattr(stream_variant, name)))
    for seed in SEEDS:
        result = run(seed, 15.0, card, control=kind == "control",
                     overrides=None)
        print("reading", kind, CELL, seed,
              {k: v["value"] for k, v in result["checks"].items()},
              flush=True)
        assert not result["correct"], (seed, result["checks"])
