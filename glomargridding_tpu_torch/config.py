"""Global numeric configuration.

Port of ``glomargridding_tpu/config.py:17-37``: the default floating
dtype for newly created tensors, float32 unless the caller opts in to
float64 (as the parity tests do for ill-conditioned solves). Every
entry point follows its inputs' dtype; this module only supplies the
default. It takes torch dtypes (``torch.float32``) and the names numpy
gives them (``np.float64``, ``"float32"``).
"""

from contextlib import contextmanager

import numpy as np
import torch

_DEFAULT_DTYPE = torch.float32


def _as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def default_dtype() -> torch.dtype:
    """Default floating dtype for newly created tensors."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Set the default floating dtype (e.g. torch.float32 or
    torch.float64)."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = _as_torch_dtype(dtype)


@contextmanager
def default_dtype_ctx(dtype):
    """Temporarily override the default floating dtype."""
    global _DEFAULT_DTYPE
    prev = _DEFAULT_DTYPE
    _DEFAULT_DTYPE = _as_torch_dtype(dtype)
    try:
        yield
    finally:
        _DEFAULT_DTYPE = prev
