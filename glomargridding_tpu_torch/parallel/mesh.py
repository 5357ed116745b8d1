"""The (grid x ens) mesh of device slots and its collectives.

The workload's two parallel axes are:

- ``grid``: the output-grid dimension M of C_cross, kriged fields,
  uncertainty diagonals and simulated states (every grid column is
  independent given the shared observation factorisation);
- ``ens``: ensemble members.

A ``Mesh`` is a (n_grid, n_ens) array of ``torch.device`` slots. A device
may fill several slots: ``["cpu"] * 8`` is an eight-slot mesh on the CPU,
``["cuda:0"] * 4`` four slots on one card, and one slot per card spreads
the mesh over a multi-GPU host. One process drives every slot, in turn.

A sharded value is a ``Sharded``: its blocks, each on its own slot. The
collectives are plain functions of the per-slot tensors: ``psum``, the
owner's ``broadcast``, the ring shift and the row gathers. A block moves with
``Tensor.to`` and does not move at all between two slots of one device.
"""

import numpy as np
import torch


class Mesh:
    """A (n_grid, n_ens) array of device slots with named axes."""

    def __init__(self, devices, axis_names=("grid", "ens")):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("one axis name per dimension of the slots")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The slots along `axis`, at index 0 of the other axis: where a
        value sharded over `axis` alone lives (replicas over the other
        axis would repeat the same work in one process)."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in the mesh's "
                             f"{self.axis_names}")
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    n_grid: int | None = None,
    n_ens: int | None = None,
    devices=None,
    axis_names: tuple[str, str] = ("grid", "ens"),
) -> Mesh:
    """Build a (grid x ens) mesh over device slots.

    `devices` is a list of devices (a device may repeat); by default
    every visible card, one slot each. Without a card the default raises
    ``RuntimeError``: the mesh never falls back to the CPU. With no sizes
    given, every slot goes to the grid axis. Sizes must multiply to the
    slot count.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "asks for the CPU (make_mesh(devices=['cpu'] * n))"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n_grid is None and n_ens is None:
        n_grid, n_ens = n, 1
    elif n_grid is None:
        n_grid = n // n_ens
    elif n_ens is None:
        n_ens = n // n_grid
    if n_grid * n_ens != n:
        raise ValueError(f"mesh {n_grid}x{n_ens} does not match {n} devices")
    slots = np.empty((n_grid, n_ens), dtype=object)
    for k, d in enumerate(devices):
        slots[k // n_ens, k % n_ens] = d
    return Mesh(slots, axis_names)


class Sharded:
    """A tensor held as a grid of blocks, each block on its own slot.

    ``parts`` lists the blocks row-major over ``blocks`` = (row blocks,
    column blocks): a vector or a row-sharded matrix is (k, 1), a matrix
    sharded over its columns (1, k), the members of an ensemble step
    (n_ens, n_grid). ``gather`` puts the whole tensor on one device.
    """

    def __init__(self, parts, blocks=None):
        self.parts = list(parts)
        self.blocks = (len(self.parts), 1) if blocks is None else tuple(blocks)
        if self.blocks[0] * self.blocks[1] != len(self.parts):
            raise ValueError("blocks must match the number of parts")

    def _rows(self):
        c = self.blocks[1]
        return [self.parts[i * c:(i + 1) * c] for i in range(self.blocks[0])]

    @property
    def shape(self) -> tuple:
        first = self.parts[0]
        rows = sum(row[0].shape[0] for row in self._rows())
        if first.dim() == 1:
            return (rows,)
        cols = sum(p.shape[1] for p in self._rows()[0])
        return (rows, cols, *first.shape[2:])

    @property
    def dtype(self):
        return self.parts[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first block's)."""
        device = self.parts[0].device if device is None else _device(device)
        rows = [
            torch.cat([move(p, device) for p in row], dim=1)
            if len(row) > 1 else move(row[0], device)
            for row in self._rows()
        ]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0].clone()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.gather("cpu").numpy(), dtype=dtype)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, blocks={self.blocks}, "
                f"dtype={self.dtype})")


# ---------------------------------------------------------------------------
# Collectives over the per-slot tensors of one axis
# ---------------------------------------------------------------------------
def move(x: torch.Tensor, device, copy: bool = False) -> torch.Tensor:
    """`x` on `device`; the same tensor when it is there already (unless
    `copy`). Copies to the card are asynchronous."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda", copy=copy)


def broadcast(x: torch.Tensor, devices) -> list:
    """`x`, the block of the slot that owns it, placed on every slot: the
    reference's one-hot psum, to which only the owner contributes."""
    return [move(x, d) for d in devices]


def psum(parts, devices) -> list:
    """The sum of the per-slot tensors, placed on every slot."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += move(p, total.device)
    return broadcast(total, devices)


def ring_shift(parts, devices) -> list:
    """One step around the ring: slot j's tensor moves to slot j + 1 (mod
    n), as ``ppermute`` with the pairs (j, j + 1)."""
    n = len(parts)
    return [move(parts[(k - 1) % n], devices[k]) for k in range(n)]


def shard_rows(x, devices, copy: bool = False) -> list:
    """Equal row blocks of `x` (numpy, tensor or ``Sharded``), one on each
    slot. Rows must divide by the slot count. `copy` gives every slot a
    tensor of its own, never a view of the caller's."""
    n_dev = len(devices)
    n = x.shape[0]
    if n % n_dev != 0:
        raise ValueError(f"N={n} must be divisible by axis size {n_dev}")
    rows = n // n_dev
    return [
        move(row_slice(x, s * rows, (s + 1) * rows), d, copy=copy)
        for s, d in enumerate(devices)
    ]


def row_slice(x, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of a numpy array, tensor or row-sharded ``Sharded``,
    as a tensor (a view where one exists)."""
    if isinstance(x, Sharded):
        if x.blocks[1] != 1:
            raise ValueError("row_slice needs a row-sharded value")
        pieces, start = [], 0
        for p in x.parts:
            stop = start + p.shape[0]
            lo, hi = max(r0, start), min(r1, stop)
            if lo < hi:
                pieces.append(move(p[lo - start:hi - start],
                                   x.parts[0].device))
            start = stop
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return torch.as_tensor(x[r0:r1])


def gather_rows(parts, idx, devices) -> list:
    """``x[idx]`` of a row-sharded x, on every slot: each slot picks the
    indexed rows it holds (zeros for the others) and the picks are
    psummed, so no slot gathers the whole of x. No host sync."""
    picked, start = [], 0
    for p, d in zip(parts, devices):
        rows, inb = local_indices(move(idx, d), start, start + p.shape[0])
        mask = inb.reshape(-1, *([1] * (p.dim() - 1)))
        picked.append(torch.where(mask, p[rows], torch.zeros((), dtype=p.dtype,
                                                             device=d)))
        start += p.shape[0]
    return psum(picked, devices)


def local_indices(idx, start: int, stop: int):
    """(rows, inside) of the entries of `idx` against the rows
    [start, stop) a slot holds: row offsets from `start`, clamped into
    range, and whether each entry lies inside (a mask, so that no
    shape depends on the data)."""
    inside = (idx >= start) & (idx < stop)
    return torch.clamp(idx - start, 0, stop - start - 1), inside


def trim(parts, n: int, dim: int = 0) -> list:
    """Cut the concatenation of `parts` along `dim` back to length `n`
    (drops a padded tail)."""
    out, start = [], 0
    for p in parts:
        size = p.shape[dim]
        keep = max(0, min(size, n - start))
        out.append(p.narrow(dim, 0, keep))
        start += size
    return out
