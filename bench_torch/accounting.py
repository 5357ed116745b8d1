"""The benchmark's yardstick: the H100's published peaks and the work of
each counted piece of an analysis, computed from its shapes.

The per-pair counts are those of the port's kernel sources as they stood
when the benchmark was defined (``glomargridding_tpu_torch/utils/
roofline.py``, which read them from ``ops/cuda/csrc/*.cu``). They are
copied here so that a later change to a kernel cannot move its own
yardstick. The dense counts are the least work of each algorithm
(a Cholesky m^3/3, a triangular inverse m^3/3, a GEMM 2mnk), not the
work a library happens to do: a product with a triangular factor
counts its triangle alone (m^2 a column).
"""

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at 700 W.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12  # outside the tensor cores: a true-f32 GEMM, TF32 off
BF16_FLOPS_S = 989e12  # tensor cores, dense
# 16 special-function results per clock per SM, 132 SMs, 1.98 GHz
TRANSCENDENTALS_S = 4.18e12
PEAK_FLOPS_S = {"f32": F32_FLOPS_S, "bf16": BF16_FLOPS_S}

# K1 (haversine, Matern nu = 0.5): 43 flops and 3 transcendentals a pair,
# 5 transcendentals a point (its half-angle trig, read once).
K1_FLOPS, K1_TRANSCENDENTALS, K1_POINT_TRANSCENDENTALS = 43, 3, 5
# The ellipse pair (K2): its value 31 flops and 3 transcendentals at
# nu = 1.5; with no cutoff no pair pays the 11-flop cutoff test.
PAIR_FLOPS, PAIR_TRANSCENDENTALS = 31, 3


def least_ms(bytes_moved, flops, transcendentals=0.0):
    """(ms, by): the least time the card could take, the larger of the
    bytes over HBM's rate and the operations over their peak rates."""
    bytes_ms = bytes_moved / HBM_BYTES_S * 1e3
    ops_ms = max(flops / F32_FLOPS_S,
                 transcendentals / TRANSCENDENTALS_S) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def k1_work(rows, cols):
    """(bytes, flops, transcendentals) of one K1 tile of rows x cols f32
    covariances: each point's (lat, lon) read once, the tile written
    once."""
    pairs = rows * cols
    points = rows + cols
    return (4.0 * pairs + 8.0 * points, float(K1_FLOPS) * pairs,
            float(K1_TRANSCENDENTALS) * pairs
            + float(K1_POINT_TRANSCENDENTALS) * points)


def k1_least_ms(rows, cols):
    """Least time of one K1 tile (5,000 x 4,096: 0.0245 ms, bytes)."""
    return least_ms(*k1_work(rows, cols))


def k2_work(n):
    """(bytes, flops, transcendentals) of K2 into the bf16 store of n
    points: the n x n store written once in bf16 (2 bytes an entry), the
    n points' 16 f32 values read once, each of the n (n - 1) / 2 pairs'
    values computed once."""
    pairs = n * (n - 1) / 2.0
    return (2.0 * n * n + 64.0 * n, PAIR_FLOPS * pairs,
            PAIR_TRANSCENDENTALS * pairs)


def k2_least_ms(n):
    """Least time of one K2 bf16 store (64,800 points: 2.508 ms, bytes)."""
    return least_ms(*k2_work(n))


def cholesky_flops(m):
    return m**3 / 3.0


def tri_inverse_flops(m):
    """L^-1 of a lower-triangular m x m L."""
    return m**3 / 3.0


def tri_solve_flops(m, rhs):
    """One triangular solve against `rhs` columns."""
    return float(m) * m * rhs


def gemm_flops(m, n, k):
    return 2.0 * m * n * k


def tri_product_flops(m, cols):
    """A lower-triangular m x m factor times `cols` columns: m^2 a
    column, as a triangular solve."""
    return float(m) * m * cols


def kriging_flops(m, n):
    """f32 flops of one ordinary kriging of n cells from m observations
    with its diagnostics: the factor, u and w (two right-hand sides), the
    triangular inverse, the (2, m) x (m, n) product, the triangular
    inverse times the (m, n) cross-covariance and the column sums of
    squares. The K1 tiles are counted apart."""
    return (cholesky_flops(m) + 2 * tri_solve_flops(m, 2)
            + tri_inverse_flops(m) + gemm_flops(2, n, m)
            + tri_product_flops(m, n) + 2.0 * m * n)


def ensemble_flops(m, n, members):
    """f32 flops of one observation-perturbation ensemble: the factor, u
    and w, the members' simulated observations L z (a triangular product),
    their solves and the (2 + members, m) x (m, n) product."""
    return (cholesky_flops(m) + 2 * tri_solve_flops(m, 2)
            + tri_product_flops(m, members)
            + 2 * tri_solve_flops(m, members)
            + gemm_flops(2 + members, n, m))


def lowrank_step_flops(n, r, m, members):
    """f32 flops of one factored step on rank-r factors (r the columns
    with gain): the states, one Woodbury solve (W = I + U'D^-1U, its
    factor, 2 + members right-hand sides and the r columns of K^-1 V_o),
    the Gram form of the diagnostics, the field and the members."""
    k = 2 + members
    return (gemm_flops(n, members, r)  # states V (g^1/2 z2)
            + gemm_flops(r, r, m) + cholesky_flops(r)  # W and its factor
            + 2 * gemm_flops(m, k, r) + 2 * tri_solve_flops(r, k)
            + 2 * gemm_flops(m, r, r) + 2 * tri_solve_flops(r, r)
            + tri_solve_flops(r, m)  # diag(K^-1)
            + gemm_flops(r, r, m) + 2.0 * n * r * r + 2.0 * n * r
            + gemm_flops(n, 2, r)  # field: V (g V_o'[u w])
            + gemm_flops(r, members, m) + gemm_flops(n, members, r))


def operator_flops(n, columns):
    """bf16 flops of applying the n x n bf16 store to `columns`
    columns."""
    return gemm_flops(n, columns, n)


def share_of_peak(ctx):
    """The window's counted work, each precision at its own peak, over
    the traced window (%); None without a trace or any counted work."""
    if ctx.trace is None:
        return None
    least = sum((ctx.total(f"{precision}_flops") or 0.0) / peak
                for precision, peak in PEAK_FLOPS_S.items())
    lo, hi = ctx.trace.window()
    return 100.0 * least / (hi - lo) if least > 0 else None
