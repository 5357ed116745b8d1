r"""Sharded non-stationary (ellipse) covariance: assembly, draws and the
ring-SUMMA stream operator.

Port of ``glomargridding_tpu/parallel/ellipse.py``. A 1-degree
non-stationary covariance is ~17 GB in f32. Row blocks of the
Paciorek-Schervish matrix are embarrassingly parallel: every slot holds
the (small) packed point parameters and assembles ONLY its rows, so the
matrix exists only as a row-sharded ``Sharded``. Each row block is K4
(``ops.cuda.ellipse_tile``) at a ``kernel_order``, the plain tile
otherwise (``models.ellipse.covariance._tile_into``).

The stream operator shards everything by grid rows and applies
``cov @ X`` as a ring-SUMMA: at each of n_slots steps a slot multiplies
its rows against the column shard it holds, then passes that shard's
points and x one step around the ring. Each product uses the
single-device stream's machinery: K3 for applications of at most
``MV_W`` columns, K4 tiles and a true-f32 GEMM for wider ones, both
banded by a latitude certificate per (row shard, column shard) pair
under ``max_dist``; a pair the cutoff zeroes entirely is skipped.
"""

import numpy as np
import torch

from ..constants import RADIUS_OF_EARTH_KM
from ..models.ellipse.covariance import (
    _apply_wide,
    _as_2d,
    _block_rows,
    _ellipse_inputs,
    _finish,
    _tile_into,
    stream_plan,
)
from ..ops.covariance_tools import _normals
from ..ops.cuda.ellipse import (
    MV_W,
    TILE,
    ellipse_matvec,
    matvec_takes,
    pack_points,
)
from ..ops.sampling import Matvec
from .mesh import Sharded, move, ring_shift, shard_rows


def _packed(Lx, Ly, theta, stdev, lats_deg, lons_deg, device, lat_dtype=None):
    """The points packed by ``pack_points`` on `device`, in Lx's dtype
    (coordinates first taken in `lat_dtype` when given)."""
    def t(a, dtype=None):
        return torch.as_tensor(a, device=device, dtype=dtype)

    la = torch.deg2rad(t(lats_deg, lat_dtype))
    lo = torch.deg2rad(t(lons_deg, lat_dtype))
    return pack_points(*_ellipse_inputs(t(Lx), t(Ly), t(theta), t(stdev),
                                        la, lo))


def sharded_ellipse_covariance(
    mesh,
    Lx,
    Ly,
    theta,
    stdev,
    lats_deg,
    lons_deg,
    v: float,
    delta_x_method: str = "Modified_Met_Office",
    max_dist: float | None = None,
    axis: str = "grid",
):
    """Row-sharded N x N Paciorek-Schervish covariance over the mesh.

    Inputs are the per-point (already compressed/unmasked) parameter and
    coordinate vectors, N divisible by the axis size. Returns the
    covariance, diag(stdev^2) included, as a ``Sharded`` of the slots'
    (N / n_slots, N) row blocks, in Lx's dtype.
    """
    devices = mesh.axis_devices(axis)
    n = len(lats_deg)
    if n % len(devices) != 0:
        raise ValueError(f"N={n} must be divisible by axis size "
                         f"{len(devices)}")
    P = _packed(Lx, Ly, theta, stdev, lats_deg, lons_deg, devices[0])
    rows = n // len(devices)
    parts = []
    for s, d in enumerate(devices):
        P_d = move(P, d)
        r0 = s * rows
        block = torch.empty((rows, n), dtype=P.dtype, device=d)
        _tile_into(P_d[r0:r0 + rows], P_d, v, delta_x_method, max_dist, block)
        k = torch.arange(rows, device=d)
        block[k, r0 + k] += P_d[r0:r0 + rows, 6] ** 2
        parts.append(block)
    return Sharded(parts)


def sharded_state_draws(mesh, L, n_members: int, axis: str = "grid", *,
                        generator=None, noise=None):
    """(n_members, N) draws of N(0, L L') with L row-sharded.

    z is replicated; each slot computes its row slice of L z, one local
    matmul and no collectives. The standard normals come from
    `generator`, drawn on the first slot, or are given as `noise` of
    shape (n_members, N). Returns a ``Sharded`` of the slots'
    (n_members, N / n_slots) column blocks.
    """
    devices = mesh.axis_devices(axis)
    L_parts = shard_rows(L, devices)
    (z,) = _normals(None if noise is None else (noise,), generator,
                    [(n_members, L.shape[0])], L_parts[0])
    parts = [(p @ move(z.T, d)).T for p, d in zip(L_parts, devices)]
    return Sharded(parts, (1, len(parts)))


# -- the ring-SUMMA stream operator -------------------------------------------
def _pair_band(lat_a, lat_b, max_dist):
    """K3's band limits over the points [a; b] (in this order) for the
    product between the a-points and the b-points only: for each 64-point
    tile i of the concatenation, the last tile j >= i holding a pair
    (a-point, b-point) within the latitude gap max_dist / R (central
    angle >= |dlat|, so every omitted pair is beyond the cutoff), or i.
    ``max_dist`` None: every such pair."""
    na = lat_a.size
    lat = np.concatenate([lat_a, lat_b])
    nq = -(-lat.size // TILE)
    padded = np.full(nq * TILE, np.nan)
    padded[:lat.size] = lat
    is_a = np.arange(nq * TILE) < na

    def interval(mask):
        x = np.where(mask & ~np.isnan(padded), padded, np.nan).reshape(nq,
                                                                        TILE)
        has = ~np.isnan(x).all(axis=1)
        lo = np.where(np.isnan(x), np.inf, x).min(axis=1)
        hi = np.where(np.isnan(x), -np.inf, x).max(axis=1)
        return has, lo, hi

    has_a, amin, amax = interval(is_a)
    has_b, bmin, bmax = interval(~is_a)
    active = has_a[:, None] & has_b[None, :]
    if max_dist is not None:
        gap = np.maximum(amin[:, None] - bmax[None, :],
                         bmin[None, :] - amax[:, None])
        active &= gap <= max_dist / RADIUS_OF_EARTH_KM
    active &= np.triu(np.ones((nq, nq), bool))
    last = np.where(active.any(axis=1),
                    nq - 1 - np.argmax(active[:, ::-1], axis=1), 0)
    return np.maximum(last, np.arange(nq)).astype(np.int32)


def _shard_gap(lat_r, lat_c):
    return max(0.0, lat_r.min() - lat_c.max(), lat_c.min() - lat_r.max())


def _stream_plans(lats, block, max_dist):
    """The band plan of every (row shard s, column shard c) pair the
    cutoff leaves: ``{(s, c): (windows, hi)}`` (K3's limits for s != c
    over the two shards' points, in shard order), and the pair counts."""
    n_dev = len(lats)
    plans = {}
    stats = {"pairs": 0, "wide_pairs": 0, "fused_pairs": 0}
    for s in range(n_dev):
        for c in range(n_dev):
            if max_dist is not None and _shard_gap(lats[s], lats[c]) > (
                    max_dist / RADIUS_OF_EARTH_KM):
                continue  # the cutoff zeroes the whole pair
            windows, hi, _ = stream_plan(lats[s], lats[c], block, max_dist)
            if c != s:
                a, b = (c, s) if c < s else (s, c)
                hi = _pair_band(lats[a], lats[b], max_dist)
            plans[s, c] = (windows, hi)
            stats["pairs"] += 1
            stats["wide_pairs"] += int(sum((r1 - r0) * (c1 - c0)
                                           for r0, r1, c0, c1 in windows))
            stats["fused_pairs"] += int(
                (hi - np.arange(hi.size) + 1).sum()) * TILE * TILE
    return plans, stats


def _ring_product(plans, P_parts, use_fused, kernel):
    """``product(s, c, P_c, x_c)``: C(rows of s, points of c) @ x_c on
    slot s, without the diagonal."""
    shard = P_parts[0].shape[0]

    def product(s, c, P_c, x_c):
        windows, hi = plans[s, c]
        P_s = P_parts[s]
        if not (use_fused and x_c.shape[1] <= MV_W):
            return _apply_wide(P_s, x_c, windows, *kernel, cols=P_c)
        if c == s:
            return ellipse_matvec(P_s, x_c.contiguous(), hi, *kernel)
        # K3 is symmetric in one point set: run it on [c; s] or [s; c]
        # (shard order) with x zero on s's points, and keep s's rows
        first = c < s
        Q = torch.cat([P_c, P_s] if first else [P_s, P_c])
        xq = torch.zeros((Q.shape[0], x_c.shape[1]), dtype=x_c.dtype,
                         device=x_c.device)
        (xq[:shard] if first else xq[shard:]).copy_(x_c)
        y = ellipse_matvec(Q, xq, hi, *kernel)
        return y[shard:] if first else y[:shard]

    return product


def _ring_apply(product, plans, P_parts, x_parts, devices):
    """The slots' (C x)_s without the diagonal: n_slots ring steps, each
    slot multiplying its rows by the column shard it holds, then passing
    that shard's points and x one slot on."""
    n_dev = len(devices)
    held = [(s, P_parts[s], x_parts[s]) for s in range(n_dev)]
    acc = [torch.zeros_like(xp) for xp in x_parts]
    for step in range(n_dev):
        for s in range(n_dev):
            c, P_c, x_c = held[s]
            if (s, c) in plans:
                acc[s] += product(s, c, P_c, x_c)
        if step < n_dev - 1:
            held = list(zip(
                [h[0] for h in held[-1:] + held[:-1]],
                ring_shift([h[1] for h in held], devices),
                ring_shift([h[2] for h in held], devices)))
    return acc


def sharded_ellipse_stream_operator(
    mesh,
    Lx,
    Ly,
    theta,
    stdev,
    lats_deg,
    lons_deg,
    v: float,
    delta_x_method: str = "Modified_Met_Office",
    max_dist: float | None = None,
    axis: str = "grid",
):
    """Row-sharded zero-storage ``cov @ X`` over the mesh.

    Returns ``(matvec, n, trace)`` like the single-device
    ``ellipse_covariance_operator(store="stream")``. ``matvec`` is an
    ``ops.sampling.Matvec`` of two forms, chosen by its input:

    - a ``Sharded`` (n, k) block of equal row blocks on the axis' slots
      gives the product as the same: x and the result never leave their
      slots. ``matvec.row_devices`` names the slots, so that the
      device-scale clips (``explained_variance_clip_lowrank`` /
      ``laloux_clip_lowrank``, through ``ops.eigsh``) keep every (n,
      width) block of the solve row-sharded, as the reference does: each
      slot holds 1 / n_slots of every block (``clip_memory_analysis``);
    - a whole (n,) or (n, k) tensor gives the whole product on the
      mesh's first slot (the blocks of a solve on ``Matvec(matvec.fn)``
      then live whole there).

    Inside an application nothing n x n (or n x n / n_slots) exists. N
    must divide by the axis size. ``matvec.band_stats`` counts the pairs
    each path builds per application.
    """
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    n = len(lats_deg)
    if n % n_dev != 0:
        raise ValueError(f"N={n} must be divisible by axis size {n_dev}")
    P = _packed(Lx, Ly, theta, stdev, lats_deg, lons_deg, devices[0],
                torch.float32)
    diag = P[:, 6].float() ** 2
    trace = float(torch.sum(diag))
    shard = n // n_dev
    P_parts = [move(P[s * shard:(s + 1) * shard], d)
               for s, d in enumerate(devices)]
    diag_parts = shard_rows(diag, devices)
    use_fused = matvec_takes(v, P.dtype)
    lat = np.asarray(P[:, 0].cpu(), dtype=np.float64)
    plans, pair_stats = _stream_plans(
        [lat[s * shard:(s + 1) * shard] for s in range(n_dev)],
        _block_rows(shard, None), max_dist)
    stats = {"n_cols": n, "use_fused": use_fused, **pair_stats}
    product = _ring_product(plans, P_parts, use_fused,
                            (v, delta_x_method, max_dist))

    def stream(x):
        if isinstance(x, Sharded):
            x_parts = [_as_2d(p, P_s) for p, P_s in zip(x.parts, P_parts)]
            acc = _ring_apply(product, plans, P_parts, x_parts, devices)
            return Sharded([a + dg[:, None] * xp for a, dg, xp in
                            zip(acc, diag_parts, x_parts)])
        x2 = _as_2d(x, P)
        x_parts = shard_rows(x2, devices)
        acc = _ring_apply(product, plans, P_parts, x_parts, devices)
        y = torch.cat([move(a + dg[:, None] * xp, devices[0])
                       for a, dg, xp in zip(acc, diag_parts, x_parts)])
        return _finish(y, x)

    mv = Matvec(stream, stats)
    mv.row_devices = devices
    return mv, n, trace


def clip_memory_analysis(n: int, width: int, n_slots: int, locked: int = 0,
                         dtype=torch.float32):
    """Count, from the shapes, the bytes of the eigensolver's blocks each
    slot holds at the peak of a stage of a clip on the row-sharded
    stream (nothing is allocated).

    Returns ``(per_slot_bytes, whole_block_bytes, small_bytes)``: the
    (n / n_slots, width) row blocks alive together (the start or image
    block Y, the basis Q and its image B, the accumulator and the result
    of an application, and in a locked widening the locked basis and its
    action, `locked` columns each); then the same blocks whole; and the
    (width, width) matrices every slot may hold besides (the summed Gram,
    R^-1, the projection and the Ritz rotation). A start block is drawn
    a slot's rows at a time (``ops.eigsh._normal``), so no slot holds a
    whole block during the solve; the clip's returned factor (n, rank)
    is gathered whole on the first slot (``ops.covariance_tools.
    _factored``) and is not counted here.
    """
    rows = n // n_slots
    blocks = 5 * width + 2 * locked
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (rows * blocks * itemsize, n * blocks * itemsize,
            4 * width * width * itemsize)
