"""Time the banded stream's wide path by row-block height, on the card.

At 0.5 degree (259,200 cells, ``chip_smoke.py`` phases 11-12's fields)
every application runs with each row block against its whole window and
against the certificate's active column chunks (``_apply_wide`` with and
without ``chunks``), at 96 and 1,024 columns. At 0.1 degree (6,480,000
cells, the twin's fields) the certificate's K4, GEMM and gather are
timed apart over ``chip_smoke.TD_SAMPLE_BLOCKS`` row blocks at several
heights (``chip_smoke.td_split``), and one W = 64 application is timed
whole at 64 and 256 rows.

Run: python3 tools/stream_block_sweep.py   (one card; ~3 min)
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke as cs  # noqa: E402
from glomargridding_tpu_torch.models.ellipse import (  # noqa: E402
    covariance as tcov,
)
from glomargridding_tpu_torch.ops.cuda import build  # noqa: E402
from glomargridding_tpu_torch.ops.cuda import ellipse as te  # noqa: E402

MAX_DIST_KM = 3000.0
HALF_DEGREE_ROWS = (1088, 3456, 6784)
TENTH_DEGREE_ROWS = (64, 128, 192, 256, 384)


def apply(P, x, windows, chunks=None):
    return tcov._apply_wide(P, x, windows, 1.5, "Modified_Met_Office",
                            MAX_DIST_KM, chunks=chunks)


def half_degree(dev, gen):
    """Whole applications at 0.5 degree: window against gather."""
    q_lat, q_lon = cs.grid_linspace(*cs.STREAM_GRID)
    P = te.pack_points(*cs.ellipse_args(
        q_lat, q_lon, cs.realistic_ellipse_params(q_lat, q_lon),
        torch.float32, dev))
    lat = P[:, 0].double().cpu().numpy()
    X = torch.randn((P.shape[0], 1024), generator=gen, device=dev)
    for rows in HALF_DEGREE_ROWS:
        windows, _, bw = tcov.stream_plan(lat, lat, rows, MAX_DIST_KM)
        chunks = tcov._active_chunks(P, windows, bw, MAX_DIST_KM)
        kept = (tcov._kept_pairs(windows, chunks)
                / tcov._kept_pairs(windows, None))
        out = {}
        for w in (96, 1024):
            x = X[:, :w]
            err = cs.max_rel(apply(P, x, windows, chunks),
                             apply(P, x, windows))
            window_ms = cs.cuda_time_ms(lambda: apply(P, x, windows),
                                        iters=3)
            gather_ms = cs.cuda_time_ms(
                lambda: apply(P, x, windows, chunks), iters=3)
            out[w] = (f"window:{window_ms:.1f}ms,gather:{gather_ms:.1f}ms,"
                      f"err:{err:.2e}")
        print("half_degree", f"rows={rows}", f"blocks={len(windows)}",
              f"bw={bw}", f"kept_share={kept:.4f}", out, flush=True)


def tenth_degree(dev, gen):
    """The certificate's split by row height at 0.1 degree, and whole
    W = 64 applications."""
    tt = cs.examples_module("torch_nonstationary_tenth_degree")
    glat, glon = tt.grid()
    fields = tt.heterogeneous_ellipse_fields(glat, glon)
    P = te.pack_points(*tt.operator_inputs(glat, glon, fields, device=dev))
    n = P.shape[0]
    lat = P[:, 0].double().cpu().numpy()
    X = torch.randn((n, 64), generator=gen, device=dev)
    for rows in TENTH_DEGREE_ROWS:
        windows, _, bw = tcov.stream_plan(lat, lat, rows, MAX_DIST_KM)
        chunks = tcov._active_chunks(P, windows, bw, MAX_DIST_KM)
        kept = (tcov._kept_pairs(windows, chunks)
                / tcov._kept_pairs(windows, None))
        scale = len(windows) / cs.TD_SAMPLE_BLOCKS / 1e3
        vals = {}
        for w, (g, k4, gemm, pairs) in cs.td_split(P, X, windows,
                                                   chunks).items():
            vals[w] = (f"gather:{g * scale:.2f}s,K4:{k4 * scale:.2f}s,"
                       f"GEMM:{gemm * scale:.2f}s,"
                       f"sum:{(g + k4 + gemm) * scale:.2f}s,"
                       f"{pairs / k4 / 1e6:.0f}Gpairs/s,"
                       f"{2 * pairs * w / gemm / 1e9:.1f}TFLOP/s")
        print("tenth_degree", f"rows={rows}", f"blocks={len(windows)}",
              f"kept_share={kept:.4f}", vals, flush=True)
    for rows in (64, 256):
        mv = tt.stream_operator(glat, glon, fields, -(-n // rows),
                                device=dev)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv(X)
        torch.cuda.synchronize()
        print("tenth_degree_application_w64",
              f"rows={mv.band_stats['block']}",
              f"s={time.perf_counter() - t0:.2f}", flush=True)
        del mv
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stream_block_sweep: no CUDA device visible")
    dev = torch.device("cuda")
    for lib in ("pairwise_tile", "ellipse_tile"):
        build.load_library(lib)
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    half_degree(dev, gen)
    tenth_degree(dev, gen)


if __name__ == "__main__":
    main()
