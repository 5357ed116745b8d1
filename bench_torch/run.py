"""Run one cell of the port's benchmark once on this machine's card.

    python3 bench_torch/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

It sets up the cell named in ``BENCHMARK.json`` (state and inputs made on
the card from the seed, every shape warmed up), measures a window of at
least ``--seconds``, compares what the window produced with the plain
reference, and prints one JSON object as its last line of output: the
end-to-end metrics with ``--trace 0``, the per-layer ones read from a
``torch.profiler`` trace of the window with ``--trace 1``. Earlier lines
name the card; the last lines on standard error give each compared number
beside its limit. ``--control`` runs the program with TF32 on (and the
ellipse store in fp8) to read the control that each limit must reject; it
is never part of a measured run. Without a CUDA device the run exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T0, control=args.control,
                             log=lambda *a, **k: print(*a, **k, flush=True))
    except harness.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
