#!/usr/bin/env python3
"""Count the SASS instructions of the innermost loops of the port's CUDA
kernels, from the libraries built in ``glomargridding_tpu_torch/ops/cuda/
_build`` (built first if they are not there).

Usage, on a machine with the CUDA toolkit, from the repository root:

    python3 tools/sass_loops.py [--library ellipse_tile] [--kernel NAME]
                                [--min-size 20] [--dump DIR]

For every function whose (mangled) name contains ``--kernel``, it finds
the loops (a branch back to an earlier label), keeps the innermost ones
of at least ``--min-size`` instructions, and prints one line per loop:
its length and its instructions by opcode (modifiers dropped), with the
classes that bound a pair function: the FP32/FP64 pipes, MUFU (sqrt,
rsqrt, exp2, sin/cos), the LSU (shared and global loads and stores) and
the rest. ``--dump`` writes each library's full SASS there as well.
"""

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from glomargridding_tpu_torch.ops.cuda import build  # noqa: E402

LIBRARIES = ("pairwise_tile", "ellipse_tile")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch's target: a label, or an address (cuobjdump prints either)
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\s*$")
CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK", "FSET"),
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"),
    "mufu": ("MUFU",),
    "lsu": ("LDS", "STS", "LDG", "STG", "LDGSTS", "LD", "ST", "LDC", "ATOM",
            "RED", "SHFL"),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
               "VOTE", "BAR"),
}


def functions(sass: str):
    """{function name: [(label or None, address, instruction text)]}."""
    out, name, pending = {}, None, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name, pending = m.group(1), None
            out[name] = []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending = m.group(1)
            continue
        m = _INSN.search(line)
        if m:
            out[name].append((pending, int(m.group(1), 16), m.group(2)))
            pending = None
    return out


def opcode(insn: str) -> str:
    words = insn.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def innermost_loops(body):
    """[(start, end)] of the loops (branch back to an earlier label) that
    contain no other loop."""
    where = {label: i for i, (label, _, _) in enumerate(body) if label}
    where.update({addr: i for i, (_, addr, _) in enumerate(body)})
    loops = []
    for i, (_, _, insn) in enumerate(body):
        if opcode(insn) != "BRA":
            continue
        m = _TARGET.search(insn)
        if not m:
            continue
        start = where.get(m.group(1) or int(m.group(2), 16))
        if start is not None and start <= i:
            loops.append((start, i))
    return [a for a in loops
            if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]


def classify(ops):
    counts = collections.Counter()
    for op in ops:
        counts[next((c for c, names in CLASSES.items() if op in names),
                    "other")] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", choices=LIBRARIES, action="append")
    ap.add_argument("--kernel", default="kernel")
    ap.add_argument("--min-size", type=int, default=20)
    ap.add_argument("--dump", type=Path)
    ap.add_argument("--sass", type=Path,
                    help="read this SASS dump instead of building")
    args = ap.parse_args(argv)
    if not args.sass:
        cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    for lib in args.library or LIBRARIES:
        if args.sass:
            sass = args.sass.read_text()
        else:
            build.load_library(lib)
            sass = subprocess.run(
                [str(cuobjdump), "-sass", str(build.library_path(lib))],
                capture_output=True, text=True, check=True).stdout
        if args.dump:
            args.dump.mkdir(parents=True, exist_ok=True)
            (args.dump / f"{lib}.sass").write_text(sass)
        for name, body in sorted(functions(sass).items()):
            if args.kernel not in name:
                continue
            for start, end in innermost_loops(body):
                if end - start + 1 < args.min_size:
                    continue
                ops = [opcode(insn) for _, _, insn in body[start:end + 1]]
                cls = classify(ops)
                top = collections.Counter(ops).most_common(12)
                print(f"{lib} {name} loop@{start} insns={len(ops)} "
                      + " ".join(f"{k}={cls[k]}" for k in
                                 (*CLASSES, "other"))
                      + " | " + " ".join(f"{k}:{v}" for k, v in top),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
