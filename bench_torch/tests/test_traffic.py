"""The general generator: every seed gets the same set of analyses, in
an order that spreads any run of them over the whole law."""

import numpy as np
import pytest

from bench_torch.traffic import bit_reversed, plan, quantile

MIX = {"pool": 32, "laws": {
    "m": {"law": "loguniform", "low": 1000, "high": 8000, "integer": True}}}


def test_every_seed_gets_the_same_sizes():
    sizes = {tuple(sorted(it["m"] for it in plan(MIX, s)[0]))
             for s in (0, 1, 2**31 + 7, 12345678901)}
    assert len(sizes) == 1
    ms = next(iter(sizes))
    assert 1000 <= ms[0] and ms[-1] <= 8000 and len(set(ms)) == 32


def test_the_seed_moves_the_start_of_the_cycle():
    orders = {tuple(plan(MIX, s)[1]) for s in range(20)}
    assert len(orders) > 1
    for order in orders:
        assert sorted(order) == list(range(32))


def test_runs_of_the_cycle_spread_over_the_law():
    items, order = plan(MIX, 3)
    logm = np.log([it["m"] for it in items])
    whole = logm.mean()
    for start in range(32):
        run = [order[(start + p) % 32] for p in range(8)]
        # eight consecutive analyses hold one from each eighth of the law
        assert sorted(k // 4 for k in run) == list(range(8))
        assert abs(logm[run].mean() - whole) < 0.1


def test_laws_and_pairing():
    assert quantile({"law": "uniform", "low": -0.2, "high": 0.2}, 0.5) == 0.0
    assert quantile({"law": "loguniform", "low": 1, "high": 100}, 0.5) \
        == pytest.approx(10.0)
    items, _ = plan({"pool": 8, "laws": {
        "a": {"law": "uniform", "low": 0, "high": 8},
        "b": {"law": "uniform", "low": 0, "high": 8}}}, 0)
    assert sorted(it["b"] for it in items) == sorted(it["a"] for it in items)
    assert [it["a"] for it in items] != [it["b"] for it in items]
    assert [bit_reversed(k, 3) for k in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]
    with pytest.raises(ValueError):
        plan({"pool": 12, "laws": {}}, 0)
