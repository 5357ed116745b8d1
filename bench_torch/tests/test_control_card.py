"""The control, kept as a test: each cell run at its own size on the
card with the precision below the configuration's (TF32 on for every
f32 product, and for the ellipse variants the store in fp8 instead of
bf16) must come out not correct, on three seeds; and so must the
ellipse cells with their clip under-converged (one sweep, the residual
gate opened), the fault that a faster clip would tempt. It needs the
card and skips without one; run it there with

    python3 -m pytest -q bench_torch/tests/test_control_card.py
"""

import time

import pytest
import torch

from bench_torch import harness
from bench_torch.entries import month, variant

SECONDS = {"st1deg.analysis": 3.0, "st1deg.ensemble": 1.0,
           "ell1deg.months": 1.0, "ell1deg.variants": 20.0}
SEEDS = (3141592653, 2718281828, 1414213562)
CLIPPED = {"ell1deg.months": (month, 1.0), "ell1deg.variants": (variant, 3.0)}


def reading(kind, cell, seed, result):
    """Each compared number of a run, printed (``pytest -s`` shows them)."""
    print("reading", kind, cell, seed,
          {k: v["value"] for k, v in result["checks"].items()})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cells' own size, on the card")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_the_control_is_not_correct(card, cell):
    c = harness.find_cell(cell)
    for seed in SEEDS:
        result = harness.run(c, seed, SECONDS[cell], False, card,
                             time.perf_counter(), control=True,
                             log=lambda *a, **k: None)
        reading("control", cell, seed, result)
        assert not result["correct"], (seed, result["checks"])


@pytest.mark.parametrize("cell", sorted(CLIPPED))
def test_an_under_converged_clip_is_not_correct(card, cell, monkeypatch):
    module, seconds = CLIPPED[cell]
    clip = module.explained_variance_clip_lowrank
    monkeypatch.setattr(module, "explained_variance_clip_lowrank",
                        lambda *a, **k: clip(*a, **{**k, "n_iter": 1,
                                                    "tol": 10.0}))
    c = harness.find_cell(cell)
    for seed in SEEDS:
        result = harness.run(c, seed, seconds, False, card,
                             time.perf_counter(), log=lambda *a, **k: None)
        reading("under-converged", cell, seed, result)
        assert not result["correct"], (seed, result["checks"])
        assert result["checks"]["eig_res"]["value"] > \
            result["checks"]["eig_res"]["limit"], (seed, result["checks"])
