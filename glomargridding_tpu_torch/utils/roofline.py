"""Analytic work accounting, achieved rates and kernel bounds.

Port of the accounting of ``glomargridding_tpu/utils/roofline.py:68-136``
(the dense-linear-algebra flop counts and the achieved-rate records), with
the peaks of the card the port runs on in place of the reference's TPU
peaks, and the bound of a kernel call that ``chip_smoke.py`` reports for
each kernel: the least time the card could take for the same work.
"""

from dataclasses import dataclass

# Peaks of one NVIDIA H100 SXM (80 GB HBM3) at 700 W, from NVIDIA's data
# sheet: HBM bytes/s; f32 flop/s outside the tensor cores (an FMA counts
# two; a true-f32 GEMM runs there, TF32 being off); transcendentals/s
# (16 per clock per SM x 132 SMs x 1.98 GHz).
HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM
F32_FLOPS_S = 67e12  # NVIDIA H100 SXM
TRANSCENDENTALS_S = 4.18e12  # NVIDIA H100 SXM
# Work per pair, counted from the kernel sources (ops/cuda/csrc/*.cu).
# K1 (haversine, Matern nu = 0.5): 43 flops and 3 transcendentals (2 sqrt,
# exp) a pair, from each point's half-angle trig (sin and cos of lat/2 and
# lon/2, cos lat: 5 transcendentals a point, counted once per point). The
# ellipse pair (K2-K4): its cutoff test 11 flops; its value 31 flops and 3
# transcendentals (rsqrt, sqrt, exp) at nu = 1.5, needed only for a pair
# within the cutoff; K3 adds 32 flops per such pair (two 8-wide
# contractions).
K1_FLOPS, K1_TRANSCENDENTALS, K1_POINT_TRANSCENDENTALS = 43, 3, 5
CUT_FLOPS, PAIR_FLOPS, PAIR_TRANSCENDENTALS = 11, 31, 3
K3_CONTRACT_FLOPS = 32
# K5 (the ellipse fit's Fisher-z objective), an (element, point): the
# quadratic form and its argument (11 flops), the Matern (1 + x) e^-x (3),
# the clip and atanh's ratio (5), the weighted square and its sum (4); a
# sqrt, an exp and a log. Its bytes: each live lane's X, z and w once.
K5_FLOPS, K5_TRANSCENDENTALS = 23, 3

# The pair-evaluation ceiling (G pairs/s) of ``achieved_pairs``: none
# until a measurement on the card installs one with ``set_pairs_peak``.
_PAIRS_PEAK_GS: float | None = None
_PAIRS_PEAK_SRC = "not measured"


def bound(bytes_moved, flops, transcendentals):
    """(bound_ms, bound_by) of a kernel call: the larger of the bytes it
    must move (each input read once, each output written once) over HBM's
    rate and its operations over their peak rates."""
    bytes_ms = bytes_moved / HBM_BYTES_S * 1e3
    ops_ms = max(flops / F32_FLOPS_S,
                 transcendentals / TRANSCENDENTALS_S) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                             "operations")


def k5_bound(points, lanes, columns, itemsize=4):
    """K5's bound for `points` points on `lanes` live lanes of `columns`
    columns: their data read once (4 values an element), every
    (element, point) computed once."""
    elements = float(lanes) * columns
    return bound(4 * itemsize * elements, K5_FLOPS * points * elements,
                 K5_TRANSCENDENTALS * points * elements)


def ellipse_bound(bytes_moved, pairs, kept, extra_flops=0):
    """The ellipse kernels' bound: every pair's cutoff test (when
    `pairs` is nonzero) and the value of the `kept` pairs."""
    return bound(bytes_moved,
                 pairs * CUT_FLOPS + kept * (PAIR_FLOPS + extra_flops),
                 kept * PAIR_TRANSCENDENTALS)


def set_pairs_peak(gpairs: float, provenance: str) -> None:
    """Install a measured pair-evaluation ceiling (G pairs/s) and where it
    came from."""
    global _PAIRS_PEAK_GS, _PAIRS_PEAK_SRC
    if gpairs > 0:
        _PAIRS_PEAK_GS = float(gpairs)
        _PAIRS_PEAK_SRC = str(provenance)


def pairs_peak() -> tuple[float | None, str]:
    """Current pair ceiling (G pairs/s, None before one is installed) and
    where it came from."""
    return _PAIRS_PEAK_GS, _PAIRS_PEAK_SRC


def matmul_flops(m: int, n: int, k: int) -> float:
    """2 m n k — one dense (m, k) @ (k, n)."""
    return 2.0 * m * n * k


def cholesky_flops(n: int) -> float:
    """n^3 / 3 — dense SPD factorisation."""
    return n**3 / 3.0


def trsm_flops(n: int, n_rhs: int) -> float:
    """n^2 * n_rhs — one triangular solve against n_rhs columns."""
    return float(n) * n * n_rhs


def cho_solve_flops(n: int, n_rhs: int) -> float:
    """Two triangular solves: 2 n^2 rhs."""
    return 2.0 * trsm_flops(n, n_rhs)


@dataclass
class Achieved:
    """Achieved rate + roofline fraction of one measured section."""

    tflops: float | None = None
    pct_roofline: float | None = None
    gpairs_per_s: float | None = None
    hbm_gbs: float | None = None

    def as_dict(self) -> dict:
        out = {}
        if self.tflops is not None:
            out["tflops"] = round(self.tflops, 1)
        if self.pct_roofline is not None:
            out["pct_roofline"] = round(self.pct_roofline, 1)
        if self.gpairs_per_s is not None:
            out["gpairs_per_s"] = round(self.gpairs_per_s, 1)
        if self.hbm_gbs is not None:
            out["hbm_gbs"] = round(self.hbm_gbs, 1)
        return out


def achieved_matmul(flops: float, wall_s: float,
                    peak_tflops: float = F32_FLOPS_S / 1e12) -> Achieved:
    """Achieved TFLOP/s and % of the given peak (by default the card's
    true-f32 rate)."""
    tf = flops / wall_s / 1e12
    return Achieved(tflops=tf, pct_roofline=100.0 * tf / peak_tflops)


def achieved_pairs(n_pairs: float, wall_s: float,
                   peak_gpairs: float | None = None) -> Achieved:
    """Achieved pair-evaluation rate and % of the pair ceiling
    (`peak_gpairs`, else the installed one; no percentage without
    either)."""
    if peak_gpairs is None:
        peak_gpairs = _PAIRS_PEAK_GS
    gp = n_pairs / wall_s / 1e9
    return Achieved(
        gpairs_per_s=gp,
        pct_roofline=None if peak_gpairs is None else 100.0 * gp / peak_gpairs,
    )


def achieved_bandwidth(bytes_moved: float, wall_s: float) -> Achieved:
    """Achieved HBM GB/s and % of the card's bandwidth."""
    gbs = bytes_moved / wall_s / 1e9
    return Achieved(hbm_gbs=gbs,
                    pct_roofline=100.0 * gbs / (HBM_BYTES_S / 1e9))
