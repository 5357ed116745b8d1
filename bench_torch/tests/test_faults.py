"""A run with its timed path broken underneath must come out not
correct: the harness's look for a card is skipped and the rest of a run
is driven on the CPU at a small size, against each cell's own limits,
once for each fault the cell can have (an answer altered where it is
produced; a loop that hands back its first answer again, which is this
mix's form of a step that leaves its state unchanged)."""

import pytest

from bench_torch import harness
from bench_torch.entries import ensemble, kriging, month, variant
from bench_torch.families import ellipse

from .small import SMALL, run_small


def altered(result):
    """`result` with one value of its first tensor moved by 1% of the
    tensor's largest magnitude."""
    def bump(t):
        t = t.clone()
        t.view(-1)[t.numel() // 2] += 0.01 * float(t.abs().max())
        return t
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return type(result)(bump(result[0]), *result[1:])
    first, *rest = result
    if hasattr(first, "_fields"):
        return (type(first)(bump(first[0]), *first[1:]), *rest)
    return (bump(first), *rest)


def stale(fn):
    """`fn` that computes once and returns its first answer ever
    after."""
    memo = []

    def wrapped(*a, **k):
        if not memo:
            memo.append(fn(*a, **k))
        return memo[0]
    return wrapped


def answer_altered(fn):
    return lambda *a, **k: altered(fn(*a, **k))


def members_altered(fn):
    def wrapped(*a, **k):
        first, members = fn(*a, **k)
        members = members.clone()
        members[-1, 0] += 0.01 * float(members.abs().max())
        return first, members
    return wrapped


def store_altered(fn):
    def wrapped(*a, **k):
        mv, n, trace = fn(*a, **k)

        def bad(x):
            y = mv(x).clone()
            y[n // 2] += 0.05 * y.abs().max()
            return y
        return bad, n, trace
    return wrapped


def gain_altered(fn):
    def wrapped(*a, **k):
        psd = fn(*a, **k)
        psd.gains[0] *= 1.01
        return psd
    return wrapped


def under_converged(fn):
    """The clip with one sweep and its residual gate opened: it returns
    whatever subspace the first sweep leaves (the loss of accuracy that a
    faster clip would tempt)."""
    def wrapped(*a, **k):
        return fn(*a, **{**k, "n_iter": 1, "tol": 10.0})
    return wrapped


FAULTS = [
    ("st1deg.analysis", kriging, "kriging_from_kernel", answer_altered),
    ("st1deg.analysis", kriging, "kriging_from_kernel", stale),
    ("st1deg.ensemble", ensemble, "ensemble_from_kernel", answer_altered),
    ("st1deg.ensemble", ensemble, "ensemble_from_kernel", members_altered),
    ("st1deg.ensemble", ensemble, "ensemble_from_kernel", stale),
    ("ell1deg.months", month, "explained_variance_clip_lowrank",
     under_converged),
    ("ell1deg.months", month, "lowrank_ensemble_step", answer_altered),
    ("ell1deg.months", month, "lowrank_ensemble_step", members_altered),
    ("ell1deg.months", month, "lowrank_ensemble_step", stale),
    ("ell1deg.variants", ellipse, "ellipse_covariance_operator",
     store_altered),
    ("ell1deg.variants", variant, "explained_variance_clip_lowrank",
     gain_altered),
    ("ell1deg.variants", variant, "explained_variance_clip_lowrank",
     under_converged),
    ("ell1deg.variants", variant, "lowrank_ensemble_step", answer_altered),
    ("ell1deg.variants", variant, "lowrank_ensemble_step", stale),
]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    result = run_small(harness, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize(
    "cell,module,name,fault", FAULTS,
    ids=[f"{c}-{n}-{f.__name__}" for c, _, n, f in FAULTS])
def test_a_broken_path_is_not_correct(monkeypatch, cell, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    result = run_small(harness, cell)
    assert not result["correct"], result["checks"]
