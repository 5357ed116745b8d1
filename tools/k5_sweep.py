"""Time K5 (``ops/cuda/ellipse_nll.fisher_z_nll``) at the 1-degree fit's
shapes over block widths and shares of live lanes, beside its bound and
its plain twin (the vmapped ``EllipseModel._nll_fit_z``).

    python3 tools/k5_sweep.py [--out <file.jsonl>]

The cell's stacked call: K = 4 points on B = 2,048 lanes of N = 4,096
columns in f32, the rotated unit-sigma form at nu = 1.5, and the widest
form (K = 5, sigma fitted) beside it. For each block width in
``THREADS`` and each share of lanes in the mask, the milliseconds a call
by CUDA events over ``CALLS`` calls after a warm-up, and the bound
(``utils.roofline.k5_bound``: the live lanes' bytes, or their operations)
over it; then the twin's milliseconds a call (it evaluates every lane,
whatever the mask). The inputs and the timer are ``chip_smoke.py``'s
phase 32's. One JSON object a line; the card's name and power limit in
each.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from chip_smoke import cuda_time_ms, fisher_z_inputs  # noqa: E402
from glomargridding_tpu_torch.models.ellipse.model import (  # noqa: E402
    EllipseModel,
)
from glomargridding_tpu_torch.ops import optim  # noqa: E402
from glomargridding_tpu_torch.ops.cuda import ellipse_nll  # noqa: E402
from glomargridding_tpu_torch.utils.roofline import k5_bound  # noqa: E402

B, N = 2048, 4096
THREADS = (128, 256, 512)
LIVE = (1.0, 0.3, 0.03, 1.0 / B)
CALLS = 50


def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        torch.cuda.get_device_name(0))


def sweep():
    """The sweep's records, one a (form, width, share), then the twin's."""
    name = card()
    records = []
    default = ellipse_nll.THREADS
    try:
        for K, fit_sigma in ((4, False), (5, True)):
            for live in LIVE:
                args = fisher_z_inputs(K, B, N, live, "cuda", fit_sigma)
                lanes = int(args[-1].sum())
                bound_ms, by = k5_bound(K, lanes, N)
                for threads in THREADS:
                    ellipse_nll.THREADS = threads
                    ms = cuda_time_ms(lambda: ellipse_nll.fisher_z_nll(
                        *args, v=1.5, fit_sigma=fit_sigma), CALLS)
                    records.append({
                        "K": K, "fit_sigma": fit_sigma, "lanes": lanes,
                        "threads": threads, "ms": ms, "bound_ms": bound_ms,
                        "bound_by": by, "share_of_bound": bound_ms / ms,
                        "card": name})
    finally:
        ellipse_nll.THREADS = default
    model = EllipseModel(anisotropic=True, rotated=True,
                         physical_distance=True, v=1.5, unit_sigma=True)
    twin = optim.stacked_objective(model._nll_fit_z, 3)
    args = fisher_z_inputs(4, B, N, 1.0, "cuda")
    records.append({"twin": "vmapped _nll_fit_z", "K": 4, "lanes": B,
                    "ms": cuda_time_ms(lambda: twin(*args), CALLS),
                    "card": name})
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="a JSON-lines file to append the records to")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_sweep: no CUDA device", file=sys.stderr)
        return 3
    records = sweep()
    lines = [json.dumps(r) for r in records]
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
