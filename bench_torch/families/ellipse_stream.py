"""The yardstick of the ellipse covariance applied as the zero-storage
stream, frozen when the benchmark took the stream in: the pairs the
result needs and the least work of building and applying them.

An application y = C x of the stream needs C's entries within the
cutoff and nothing else: every other entry is an exact 0. So the work is
counted from the needed pairs, the ordered pairs i != j of the grid
within ``max_dist_km`` of great-circle distance, and not from the pairs
an implementation builds. The pairs are counted once, in float64, from
the grid's latitude rows and longitude offsets with the reference's
haversine (``reference/ellipse.py``): on a regular grid every cell of a
latitude row has the same number of partners in each other row.

Per needed pair, the stream's tile kernel (K4, ``ellipse_tile_kernel``
of ``glomargridding_tpu_torch/ops/cuda/csrc/ellipse_tile.cu`` as it stood
when the benchmark took the stream in) writes one f32 value (4 bytes)
after its cutoff test (11 flops) and its value (31 flops and 3
transcendentals at nu = 1.5: rsqrt, sqrt, exp); each application reads
every point's 16 f32 values once. The product with x is a true-f32 GEMM
of 2 flops a needed pair and a column. The peaks are ``accounting``'s.
"""

import math

import numpy as np
import torch

from .. import accounting

RADIUS_KM = 6371.0  # the reference's mean radius of the Earth
K4_BYTES = 4  # one f32 value written a needed pair
K4_FLOPS = 11 + 31  # the cutoff test and the value at nu = 1.5
K4_TRANSCENDENTALS = 3
POINT_BYTES = 64  # a point's 16 packed f32 values, read once
# the widest application the stream's fused kernel (K3) carries; a wider
# one builds tiles with K4 and multiplies them (ops/cuda/ellipse.MV_W)
K3_COLUMNS = 8


def axes(step_deg):
    """(lat, lon) of the regular grid's cell centres, float64 degrees."""
    step = float(step_deg)
    return (np.arange(-90.0 + step / 2, 90.0, step, dtype=np.float64),
            np.arange(-180.0 + step / 2, 180.0, step, dtype=np.float64))


def needed_pairs(step_deg, max_dist_km, device="cpu"):
    """Ordered pairs i != j of the grid within `max_dist_km` of
    great-circle distance: for each pair of latitude rows, the longitude
    offsets whose haversine-a stays within the cutoff's, times the cells
    of a row, less the n pairs i == j."""
    lat, lon = axes(step_deg)
    f64 = dict(dtype=torch.float64, device=device)
    la = torch.deg2rad(torch.as_tensor(lat, **f64))
    dlon = torch.deg2rad(torch.as_tensor(lon - lon[0], **f64))
    half = min(float(max_dist_km) / (2.0 * RADIUS_KM), 0.5 * math.pi)
    limit = math.sin(half) ** 2
    s2 = torch.sin(0.5 * dlon) ** 2
    total = 0
    for a in range(la.numel()):
        hav = torch.sin(0.5 * (la[a] - la))[:, None] ** 2 \
            + (torch.cos(la[a]) * torch.cos(la))[:, None] * s2[None, :]
        total += int(torch.count_nonzero(hav <= limit))
    return lon.size * total - lat.size * lon.size


def k4_work(needed, n):
    """(bytes, flops, transcendentals) of one application's tiles: the
    needed pairs' values written once, the n points read once."""
    return (float(K4_BYTES) * needed + float(POINT_BYTES) * n,
            float(K4_FLOPS) * needed, float(K4_TRANSCENDENTALS) * needed)


def k4_least_ms(needed, n):
    """Least time of one application's tiles (ms), and what binds it."""
    return accounting.least_ms(*k4_work(needed, n))


def gemm_flops(needed, columns):
    """f32 flops of multiplying the needed pairs by `columns` columns."""
    return 2.0 * needed * columns
