"""Time the kriging uncertainty's L^-1 C_cross product by panel height,
on the card.

One column block of ``models/kernel_kriging._grid_columns`` (b = 4,096
columns, the 1-degree grid's 64,800 cells in 16 blocks rounded to K1's
column tile) against n observations: ``_tri_colsq`` with one panel (the
dense (n, n) product, the path before row panels) and with row panels of
each height in ``HEIGHTS``, in turns dense, panels, panels reversed,
dense. Each reading is CUDA events around ``ITERS`` calls after a
warm-up; TFLOP/s count the triangular product's n^2 b. Beside them, for
the record: cuBLAS's triangular solve L^-1 C_cross (``trsm``), and the
kernels each height launches at the largest n (profiler).

Run: python3 tools/tri_panel_sweep.py [out.json]   (one card; ~1 min)
Prints one line a reading and, with a path, writes them all there.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from glomargridding_tpu_torch.models.kernel_kriging import (  # noqa: E402
    _tri_colsq,
)

N_OBS = (1574, 3000, 5000)
HEIGHTS = (256, 384, 512, 768, 1024, 1536)
COLS = 4096
ITERS = 20


def system(n, gen, dev):
    """L^-1 of a well-conditioned SPD (n, n) matrix, its L, and an
    (n, COLS) right-hand side, in f32 on `dev`."""
    A = torch.randn((n, n), generator=gen, device=dev) / n**0.5
    K = A @ A.T + torch.eye(n, device=dev)
    L = torch.linalg.cholesky(K)
    eye = torch.eye(n, device=dev)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Cc = torch.randn((n, COLS), generator=gen, device=dev)
    return L, Linv, Cc


def event_ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / ITERS


def kernels(fn):
    """Device kernels of one call: name -> (launches, total ms)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            out[e.key[:90]] = (e.count, round(e.device_time_total / 1e3, 4))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tri_panel_sweep needs a CUDA card")
    if torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("f32 products must run in full f32")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    rows = []
    for n in N_OBS:
        L, Linv, Cc = system(n, gen, dev)
        flops = float(n) * n * COLS
        dense = _tri_colsq(Linv, Cc, n)
        scale = float(dense.abs().max())
        turns = ([n] + list(HEIGHTS) + list(reversed(HEIGHTS)) + [n])
        times = {}
        for h in turns:
            times.setdefault(h, []).append(
                event_ms(lambda h=h: _tri_colsq(Linv, Cc, h)))
        trsm_ms = event_ms(lambda: torch.sum(torch.linalg.solve_triangular(
            L, Cc, upper=False).square_(), dim=0))
        dense_ms = sum(times[n]) / 2
        for h in HEIGHTS:
            if h >= n:
                continue
            err = float((_tri_colsq(Linv, Cc, h) - dense).abs().max()) / scale
            ms = sum(times[h]) / 2
            row = {"n": n, "h": h, "panels": -(-n // h), "cols": COLS,
                   "dense_ms": round(dense_ms, 4),
                   "dense_turns_ms": [round(t, 4) for t in times[n]],
                   "panel_ms": round(ms, 4),
                   "panel_turns_ms": [round(t, 4) for t in times[h]],
                   "dense_tflops": round(flops / dense_ms / 1e9, 2),
                   "panel_tflops": round(flops / ms / 1e9, 2),
                   "panel_over_dense": round(ms / dense_ms, 4),
                   "trsm_ms": round(trsm_ms, 4),
                   "max_rel_diff": err}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del L, Linv, Cc
    n = N_OBS[-1]
    L, Linv, Cc = system(n, gen, dev)
    launched = {str(h): kernels(lambda h=h: _tri_colsq(Linv, Cc, h))
                for h in (n,) + HEIGHTS}
    for h, ks in launched.items():
        print(f"kernels n={n} h={h}: {json.dumps(ks)}", flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "rows": rows, "kernels": launched}, f, indent=1)


if __name__ == "__main__":
    main()
