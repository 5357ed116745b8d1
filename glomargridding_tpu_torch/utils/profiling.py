"""Tracing / profiling helpers.

Port of ``glomargridding_tpu/utils/profiling.py``: a stage timer that
waits for the card's work before it stops the clock (so timings are
honest under asynchronous launches), a ``torch.profiler`` context that
writes a Chrome trace, and memory budget estimates before a large matrix
is materialised.
"""

import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from .arrays import sizeof_fmt

logger = logging.getLogger(__name__)


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


@contextmanager
def stage_timer(name: str, result_holder: dict | None = None):
    """Time a pipeline stage; the clock stops after the card has finished
    the tensors registered via ``holder['out'] = tensors``
    (``torch.cuda.synchronize`` on each of their devices).

    >>> with stage_timer("solve") as h:
    ...     h["out"] = kriging_step(...)
    """
    holder: dict = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if "out" in holder:
            for device in _cuda_devices(holder["out"], set()):
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        logger.info("[%s] %.3fs", name, dt)
        if result_holder is not None:
            result_holder[name] = dt


@contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` context over the CPU and, when there is one, the
    card; on exit writes a Chrome trace (``trace.json``, viewable in
    Perfetto or chrome://tracing) into `log_dir` and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def hbm_estimate(*shapes_dtypes) -> int:
    """Total bytes for a set of (shape, dtype) pairs; torch or numpy
    dtypes.

    Use before materialising covariance matrices:
    ``hbm_estimate(((65000, 65000), torch.float32))`` -> ~16.9 GB.
    """
    total = 0
    for shape, dtype in shapes_dtypes:
        total += int(np.prod(shape)) * _itemsize(dtype)
    return total


def hbm_budget_check(
    *shapes_dtypes, limit_bytes: int | None = None, label: str = ""
) -> bool:
    """Log (and return) whether the given allocations fit the budget.

    Without an explicit `limit_bytes` the budget is the current card's
    free memory (``torch.cuda.mem_get_info``); without a card the caller
    must give `limit_bytes`.
    """
    need = hbm_estimate(*shapes_dtypes)
    if limit_bytes is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: give limit_bytes for a budget without a "
                "card"
            )
        limit_bytes = int(torch.cuda.mem_get_info()[0])
    fits = need <= limit_bytes
    logger.log(
        logging.INFO if fits else logging.WARNING,
        "%s needs %s of %s device memory (%s)",
        label or "allocation",
        sizeof_fmt(need),
        sizeof_fmt(limit_bytes),
        "ok" if fits else "DOES NOT FIT",
    )
    return fits
