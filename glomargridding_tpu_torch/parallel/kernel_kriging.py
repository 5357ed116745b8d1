r"""Kernel-functional kriging with the grid columns sharded over a mesh
axis.

Port of ``glomargridding_tpu/parallel/kernel_kriging.py``. The streamed
column-block solver (``models.kernel_kriging``) is embarrassingly
parallel over grid columns: the observation system K = C_obs + E is
small, factored once and placed on every slot; each slot builds the
C_cross tiles of ITS slice of the grid straight from the kernel (on the
card, the tile kernel K1), multiplies them by L^-1 in true f32, and
reduces its slice of the field, uncertainty and constraint mask. There
is no communication after the system's broadcast.
"""

from ..models.kernel_kriging import (
    _grid,
    _grid_columns,
    _index,
    _like,
    _obs_system,
)
from .mesh import Sharded, move

_GRID_BLOCKS = 16  # column blocks over the whole grid


def sharded_kriging_from_kernel(
    mesh,
    kernel_fn,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov,
    variance: float = 1.0,
    axis: str = "grid",
):
    """Ordinary kriging with grid columns sharded over a mesh axis.

    `grid_lats`/`grid_lons` (degrees, length M divisible by the axis
    size) are split across the slots; each slot computes its field,
    uncertainty^2 and constraint-mask slice against the observation
    system, factored once on the first slot and broadcast, in column
    blocks as wide as ``kriging_from_kernel``'s default 16 over the
    grid. Returns three ``Sharded`` vectors.
    """
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    m = len(grid_lats)
    if m % n_dev != 0:
        raise ValueError(f"M={m} must be divisible by axis size {n_dev}")
    la, lo = _grid(grid_lats, grid_lons, devices[0])
    idx = _index(idx, la)
    la_o, lo_o, system = _obs_system(kernel_fn, la, lo, idx, _like(obs, la),
                                     _like(error_cov, la))
    rows = m // n_dev
    blocks = max(1, _GRID_BLOCKS // n_dev)
    parts = []
    for s, d in enumerate(devices):
        sys_d = type(system)(*(None if t is None else move(t, d)
                               for t in system))
        parts.append(_grid_columns(
            kernel_fn, sys_d, move(la_o, d), move(lo_o, d),
            move(la[s * rows:(s + 1) * rows], d),
            move(lo[s * rows:(s + 1) * rows], d),
            float(variance), 0.0, "ordinary", blocks,
        ))
    return tuple(Sharded([p[k] for p in parts]) for k in range(3))

