"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
its own into ``_build/lib<name>-<key>.so`` beside this file (a directory
that ``.gitignore`` lists), then loaded with ``ctypes``. ``key`` hashes
the source and the flags, so an edit rebuilds. A file lock keeps two
processes from building the same library at once. A failed compile
raises with nvcc's stderr attached; there is no fallback.

This route (nvcc + ctypes) was chosen over
``torch.utils.cpp_extension.load``: a source that includes PyTorch's
headers takes minutes to compile, and ``load`` needs ninja.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# No --use_fast_math: __sinf/__expf would break parity with the plain
# PyTorch twins (see csrc/pairwise_tile.cu).
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-Xptxas",
    "-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from source at first use"
        )
    return found


def cache_key(source: Path, flags=NVCC_FLAGS) -> str:
    """Hash of the source text and the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str, flags=NVCC_FLAGS) -> Path:
    key = cache_key(CSRC_DIR / f"{name}.cu", flags)
    return BUILD_DIR / f"lib{name}-{key}.so"


def compile_library(
    source: Path, target: Path, nvcc: str | None = None, flags=NVCC_FLAGS
) -> None:
    """Compile `source` into the shared library `target` under a file lock,
    unless another process already has. Raises ``RuntimeError`` with
    nvcc's stderr if the compile fails.
    """
    target.parent.mkdir(parents=True, exist_ok=True)
    lock_path = target.parent / f"{target.name}.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return
        tmp = target.parent / f"{target.name}.tmp{os.getpid()}"
        cmd = [nvcc or nvcc_path(), *flags, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = target.with_suffix(".log")
        log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {source.name}:"
                f"\n{proc.stderr}"
            )
        os.replace(tmp, target)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    target = library_path(name)
    if not target.exists():
        compile_library(CSRC_DIR / f"{name}.cu", target)
    return ctypes.CDLL(str(target))
