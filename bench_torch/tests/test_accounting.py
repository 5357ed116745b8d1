"""The yardstick's counts against bounds worked out by hand."""

import pytest

from bench_torch import accounting


def test_k1_bound_at_5000_by_4096():
    # 20,480,000 f32 covariances written (81.92 MB) and 9,096 points of
    # two f32 coordinates read (72,768 B): 81,992,768 B / 3.35e12 B/s
    ms, by = accounting.k1_least_ms(5000, 4096)
    assert by == "bytes"
    assert ms == pytest.approx(81_992_768 / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0245, abs=5e-5)
    # its operations would take 43 x 20.48e6 / 67e12 = 0.0131 ms and its
    # transcendentals (3 a pair, 5 a point) 0.0147 ms: both below
    _, flops, trans = accounting.k1_work(5000, 4096)
    assert flops / accounting.F32_FLOPS_S * 1e3 == pytest.approx(0.013145,
                                                                 rel=1e-3)
    assert trans / accounting.TRANSCENDENTALS_S * 1e3 < ms


def test_k2_bound_at_the_1_degree_grid():
    # the 64,800^2 bf16 store, 8,398,080,000 B, and 64 B a point read
    # (4,147,200 B)
    n = 64800
    ms, by = accounting.k2_least_ms(n)
    assert by == "bytes"
    assert ms == pytest.approx((2 * n * n + 64 * n) / 3.35e12 * 1e3)
    assert ms == pytest.approx(2.5081, abs=1e-4)
    # 31 flops and 3 transcendentals for each of the n (n - 1) / 2 pairs
    _, flops, trans = accounting.k2_work(n)
    assert flops == pytest.approx(31 * n * (n - 1) / 2)
    assert trans / accounting.TRANSCENDENTALS_S * 1e3 == pytest.approx(
        1.5071, rel=1e-3)


def test_dense_counts():
    m, n = 5000, 64800
    assert accounting.gemm_flops(m, n, m) == 2 * m * m * n
    assert accounting.cholesky_flops(m) == pytest.approx(m**3 / 3)
    assert accounting.operator_flops(n, 8) == 2 * n * n * 8


def test_lowrank_step_grows_with_each_size():
    base = accounting.lowrank_step_flops(64800, 896, 5000, 100)
    for args in ((129600, 896, 5000, 100), (64800, 1792, 5000, 100),
                 (64800, 896, 8000, 100), (64800, 896, 5000, 200)):
        assert accounting.lowrank_step_flops(*args) > base
    # the Gram form 2 n r^2 is its largest term at these sizes
    assert base > 2 * 64800 * 896**2


def test_kriging_count_by_hand():
    # one ordinary kriging at m = 5,000 onto n = 64,800, term by term:
    m, n = 5000, 64800
    hand = (m**3 / 3  # the Cholesky factor
            + 2 * 2 * m**2  # u and w: two solves of two right-hand sides
            + m**3 / 3  # the triangular inverse
            + 2 * 2 * n * m  # the (2, m) x (m, n) product
            + m**2 * n  # L^-1 (m, m), triangular, times the (m, n) cross
            + 2 * m * n)  # the column sums of squares
    assert accounting.kriging_flops(m, n) == pytest.approx(hand, rel=1e-12)
    # the triangular product, 1.62 TFLOP, is half a dense GEMM's count
    assert accounting.tri_product_flops(m, n) == pytest.approx(1.62e12)
    assert 1.62e12 < accounting.kriging_flops(m, n) < 1.62e12 + m**3


def test_ensemble_count_by_hand():
    m, n, M = 5000, 64800, 100
    hand = (m**3 / 3 + 2 * 2 * m**2  # the factor, u and w
            + m**2 * M  # the members' simulated observations L z
            + 2 * m**2 * M  # their two triangular solves
            + 2 * (2 + M) * n * m)  # the (2 + M, m) x (m, n) product
    assert accounting.ensemble_flops(m, n, M) == pytest.approx(hand,
                                                               rel=1e-12)
