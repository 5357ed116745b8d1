r"""Non-stationary anisotropic covariance (Paciorek-Schervish), on tensors.

Port of ``glomargridding_tpu/models/ellipse/covariance.py``: the full
N x N covariance from per-gridpoint ellipse parameter fields (PS06 Eq. 8,
Karspeck Eq. 17),

.. math::
    c_{ij} = \sigma_i \sigma_j
        \frac{|\Sigma_i|^{1/4} |\Sigma_j|^{1/4}}{|\bar\Sigma|^{1/2}}
        \frac{(2\sqrt{\nu}\tau)^\nu K_\nu(2\sqrt{\nu}\tau)}
             {\Gamma(\nu) 2^{\nu-1}},
    \qquad \bar\Sigma = \tfrac{\Sigma_i + \Sigma_j}{2},

with :math:`\tau` the Mahalanobis distance of the (Modified) Met Office
displacement under :math:`\bar\Sigma`, and its matvec forms.

At an order the kernels have (``ops.cuda.ellipse.kernel_order``), K2
builds the whole matrix, K4 the stream's wide tiles and the sharded row
blocks, and K3 the stream's narrow (<= 8 column) applications where it
``matvec_takes`` the points; on the CPU their plain twins. Each refuses a
dtype it does not take (``takes``). Any other order takes, on every
device, the twin's pair function with the general-order K_nu, as the
reference routes it
(``glomargridding_tpu/models/ellipse/covariance.py:185-192,672-680``).
No argument selects a route: the reference's ``use_pallas``, ``assemble``,
``covariance_method`` and ``batch_size`` are only checked, as it does.
"""

import logging
import math

import numpy as np
import torch

from ...constants import RADIUS_OF_EARTH_KM
from ...ops.cuda.ellipse import (
    DELTA_X_METHODS,
    MV_W,
    TILE,
    ellipse_matvec,
    ellipse_sym,
    ellipse_tile,
    beyond_cutoff,
    ellipse_tile_torch,
    kernel_order,
    matvec_takes,
    pack_points,
    tile_pair_bytes,
)
from ...ops.distances import sigma_rot_flat
from ...ops.sampling import Matvec, _mm_bf16_f32
from ...utils.device import resolve_device
from ...utils.profiling import count, span

logger = logging.getLogger(__name__)

# Sizes for one H100 (80 GB). The stream works one row block at a time
# against its column window, through one reused tile workspace: a row
# block against all n columns holds about _BLOCK_BYTES of f32. A tile's
# build holds (``tile_pair_bytes`` a pair, ``_tile_rows``) at most
# _TILE_LIMIT_BYTES in the stream, above which it goes in column chunks of
# about _CHUNK_BYTES, and _BUILD_LIMIT_BYTES in a general-order build of
# the whole matrix (2,048 rows at 1 degree in f32: a 41 GB peak).
_BLOCK_BYTES = 1 << 30
_TILE_LIMIT_BYTES = 2 << 30
_CHUNK_BYTES = 1 << 30
_BUILD_LIMIT_BYTES = 24 << 30

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def ellipse_covariance_block(
    lat_i, lon_i, sig_i, sqrt_det_i, stdev_i,
    lat_j, lon_j, sig_j, sqrt_det_j, stdev_j,
    v: float,
    delta_x_method: str = "Modified_Met_Office",
    max_dist: float = 0.0,
    use_max_dist: bool = False,
):
    """One (B_i x B_j) tile of the reference's jnp tile: the kernels' pair
    function (``ellipse_tile_torch``) of the packed points, whose closed
    form serves the orders the kernels take and the general-order K_nu
    any other.

    lat/lon in radians; `sig_*` the (B, 3) Sigma rows (s00, s01, s11);
    `sqrt_det_*` = |Sigma|^(1/2). Entries at zero displacement and, with
    `use_max_dist`, beyond `max_dist` (haversine km) are 0, every pair at
    a `max_dist` of 0, as in the reference's tile.
    """
    Pi = pack_points(lat_i, lon_i, sig_i, sqrt_det_i, stdev_i)
    Pj = pack_points(lat_j, lon_j, sig_j, sqrt_det_j, stdev_j)
    tile = ellipse_tile_torch(Pi, Pj, v, delta_x_method)
    if use_max_dist:
        tile.masked_fill_(beyond_cutoff(Pi, Pj, float(max_dist)), 0.0)
    return tile


def _tile_rows(n_cols: int, pair_bytes: int, limit: int) -> int:
    """The one tile-height rule: the most rows, a multiple of TILE (at
    least TILE), whose (rows x n_cols) tile's build, `pair_bytes` a pair
    (``tile_pair_bytes``), fits `limit`."""
    return max(TILE, limit // pair_bytes // max(n_cols, 1) // TILE * TILE)


def _tile_into(rows, cols, v, delta_x_method, max_dist, out):
    """C(rows, cols) of packed points into `out`: K4 at a
    ``kernel_order`` (which refuses a dtype it does not take), else its
    twin's pair function (general-order K_nu)."""
    if kernel_order(v):
        return ellipse_tile(rows, cols, v, delta_x_method, max_dist, out=out)
    return out.copy_(ellipse_tile_torch(rows, cols, v, delta_x_method,
                                        max_dist))


def build_ellipse_covariance(
    lats_rad,
    lons_rad,
    sig_flat,
    sqrt_dets,
    stdevs,
    v: float,
    delta_x_method: str = "Modified_Met_Office",
    max_dist: float | None = None,
    use_pallas: bool | str = "auto",
    device=None,
):
    """The full covariance, diag(stdev^2) included, in `sig_flat`'s dtype,
    on `device`: by default that of a tensor input, else the card
    (``resolve_device``).

    At a ``kernel_order`` it is one K2 launch, upper-triangle tiles only
    (K2 refuses a dtype it does not take); any other order is built by
    ``_rows_into``. ``use_pallas`` (the reference's name) selects nothing:
    forced (True) at an order K2 does not take, K2 refuses it, as the
    reference's Pallas build does.
    """
    device = resolve_device(device, sig_flat, lats_rad, lons_rad, sqrt_dets,
                            stdevs)
    P = pack_points(lats_rad, lons_rad, torch.as_tensor(sig_flat,
                                                        device=device),
                    sqrt_dets, stdevs)
    if kernel_order(v) or (use_pallas and use_pallas != "auto"):
        return ellipse_sym(P, v, delta_x_method, max_dist)
    n = P.shape[0]
    cov = _rows_into(P, v, delta_x_method, max_dist, torch.empty(
        (n, n), dtype=P.dtype, device=P.device))
    cov.diagonal().add_(P[:, 6] ** 2)
    return cov


def _rows_into(P, v, delta_x_method, max_dist, out):
    """C(P, P) without its diagonal into `out` ((n, n), in its dtype) at
    an order no kernel has: the twin's pair function in row blocks
    ``_tile_rows`` high under _BUILD_LIMIT_BYTES."""
    n = P.shape[0]
    block = _tile_rows(n, tile_pair_bytes(v, P.dtype), _BUILD_LIMIT_BYTES)
    for r0 in range(0, n, block):
        out[r0:r0 + block] = ellipse_tile_torch(P[r0:r0 + block], P, v,
                                                delta_x_method, max_dist)
    return out


def _ellipse_inputs(Lx, Ly, theta, stdevs, lats_rad, lons_rad):
    """Sigma from (Lx, Ly, theta): ``build_ellipse_covariance``'s
    (lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs)."""
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, theta)
    sig_flat = torch.stack([s00, s01, s11], dim=-1)
    sqrt_dets = torch.sqrt(s00 * s11 - s01 * s01)
    return lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs


class EllipseCovarianceBuilder:
    """Covariance from ellipse parameter fields and positions.

    Valid (unmasked) points only enter the matrix; `max_dist` (haversine
    km) zeroes covariance beyond the radius; `precision` (a numpy float
    dtype) defaults to float32. The matrix is ``build_ellipse_covariance``'s:
    `covariance_method` ("array" / "batched" / "low_memory"), `batch_size`
    and `use_pallas` are the reference's names, checked as it checks them,
    and select nothing.

    Sets `cov_ns`, a tensor on `device` (by default the card: the inputs
    are numpy); `calculate_cor` adds `cor_ns`;
    `uncompress_cov` re-inflates to the full grid with fill values.
    (Parity: ``glomargridding_tpu/models/ellipse/covariance.py:280-468``.)
    """

    def __init__(
        self,
        Lx,
        Ly,
        theta,
        stdev,
        lats,
        lons,
        v: float,
        delta_x_method: str | None = "Modified_Met_Office",
        max_dist: float | None = None,
        precision=np.float32,
        covariance_method: str = "array",
        batch_size: int | None = None,
        use_pallas: bool | str = "auto",
        device=None,
    ) -> None:
        if max_dist is not None and not isinstance(max_dist, (int, float)):
            raise ValueError("max_dist must be a number")
        if delta_x_method not in DELTA_X_METHODS:
            raise ValueError(
                f"Unknown 'delta_x_method' value: {delta_x_method}"
            )
        self.v = float(v)
        self.precision = precision
        self.dtype = _TORCH_DTYPES[np.dtype(precision)]
        self.device = resolve_device(device)

        def as_masked(arr):
            return np.ma.MaskedArray(
                np.asarray(np.ma.getdata(arr), dtype=precision),
                np.ma.getmaskarray(arr),
            )

        self.Lx = as_masked(Lx)
        self.Ly = as_masked(Ly)
        self.theta = as_masked(theta)
        self.stdev = as_masked(stdev)
        self.max_dist = max_dist
        self.delta_x_method = delta_x_method
        self.lats = np.asarray(lats, dtype=precision)
        self.lons = np.asarray(lons, dtype=precision)
        self.covariance_method = covariance_method
        self.batch_size = batch_size
        self.use_pallas = use_pallas

        self.xy_shape = self.Lx.shape
        self.n_elements = int(np.prod(self.xy_shape))

        self._get_mask()
        self._calculate_covariance()

    def _get_mask(self) -> None:
        self.data_has_mask = bool(np.ma.getmaskarray(self.Lx).any())
        self.data_mask = np.ma.getmaskarray(self.Lx)
        self.covar_size = int(np.sum(~self.data_mask))

        self.Lx_compressed = self.Lx.compressed()
        self.Ly_compressed = self.Ly.compressed()
        self.theta_compressed = self.theta.compressed()
        self.stdev_compressed = self.stdev.compressed()

        self.x_grid, self.y_grid = np.meshgrid(self.lons, self.lats)
        self.x_mask = np.ma.masked_where(self.data_mask, self.x_grid)
        self.y_mask = np.ma.masked_where(self.data_mask, self.y_grid)
        self.lat_grid_compressed = self.y_mask.compressed()
        self.lon_grid_compressed = self.x_mask.compressed()
        self.lat_grid_compressed_rad = np.deg2rad(self.lat_grid_compressed)
        self.lon_grid_compressed_rad = np.deg2rad(self.lon_grid_compressed)

        self.xy_compressed = np.column_stack(
            [self.lon_grid_compressed, self.lat_grid_compressed]
        )
        self.xy_full = np.column_stack(
            [self.x_mask.flatten(), self.y_mask.flatten()]
        )

    @property
    def sigmas(self):
        """Per-point flattened 2x2 Sigma rows (numpy, computed lazily)."""
        if getattr(self, "_sigmas", None) is None:
            ct = np.cos(self.theta_compressed)
            st = np.sin(self.theta_compressed)
            Lx2 = self.Lx_compressed**2
            Ly2 = self.Ly_compressed**2
            s00 = ct * ct * Lx2 + st * st * Ly2
            s01 = ct * st * (Lx2 - Ly2)
            s11 = st * st * Lx2 + ct * ct * Ly2
            self._sigmas = np.column_stack([s00, s01, s01, s11]).astype(
                self.precision
            )
        return self._sigmas

    @property
    def sqrt_dets(self):
        """Per-point sqrt(det Sigma) (numpy, lazy)."""
        if getattr(self, "_sqrt_dets", None) is None:
            s = self.sigmas
            self._sqrt_dets = np.sqrt(s[:, 0] * s[:, 3] - s[:, 1] * s[:, 2])
        return self._sqrt_dets

    def _device_inputs(self):
        """(Lx, Ly, theta, stdev, lats_rad, lons_rad) of the valid points,
        as tensors in the builder's dtype on its device."""

        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        return tuple(dev(a) for a in (
            self.Lx_compressed, self.Ly_compressed, self.theta_compressed,
            self.stdev_compressed, self.lat_grid_compressed_rad,
            self.lon_grid_compressed_rad))

    def _calculate_covariance(self) -> None:
        self.gamma_v_term = math.gamma(self.v) * (2 ** (self.v - 1))
        self.sqrt_v_term = math.sqrt(self.v) * 2
        self._sigmas = None
        self._sqrt_dets = None
        if self.covariance_method not in ("array", "batched", "low_memory"):
            raise ValueError(
                f"Unknown covariance_method: {self.covariance_method}")
        if self.covariance_method == "batched" and self.batch_size is None:
            raise ValueError("batch_size must be set if using 'batched' method")
        self.cov_ns = build_ellipse_covariance(
            *_ellipse_inputs(*self._device_inputs()), v=self.v,
            delta_x_method=self.delta_x_method, max_dist=self.max_dist,
            use_pallas=self.use_pallas,
        )
        logger.info("Covariance assembled: %s", tuple(self.cov_ns.shape))

    def calculate_cor(self) -> None:
        """Correlation matrix from the covariance matrix."""
        from ...utils.arrays import cov_2_cor

        self.cor_ns = cov_2_cor(self.cov_ns)

    def uncompress_cov(
        self, diag_fill_value=np.nan, fill_value=np.nan
    ) -> None:
        """Re-inflate cov_ns to full-grid size with fill values."""
        cov = self.cov_ns
        keep = torch.as_tensor(~self.data_mask.flatten(), device=cov.device)
        if int(keep.sum()) != cov.shape[0]:
            raise ValueError("Data mask and coordinates cannot be aligned")
        size = keep.numel()
        full = torch.full((size, size), fill_value, dtype=cov.dtype,
                          device=cov.device)
        full.diagonal().fill_(diag_fill_value)
        idx = torch.nonzero(keep)[:, 0]
        full[idx[:, None], idx[None, :]] = cov
        self.cov_ns = full


# ---------------------------------------------------------------------------
# Matvec forms
# ---------------------------------------------------------------------------
def _block_rows(n: int, n_blocks: int | None) -> int:
    """Rows per block, a multiple of the kernels' tile: about
    _BLOCK_BYTES of f32 tile against all n columns, or n / n_blocks."""
    if n_blocks is None:
        block = max(TILE, (_BLOCK_BYTES // 4) // max(n, 1))
    else:
        block = -(-n // n_blocks)
    block = -(-block // TILE) * TILE
    return min(block, -(-n // TILE) * TILE)


def ellipse_covariance_operator(
    lats_rad,
    lons_rad,
    sig_flat,
    sqrt_dets,
    stdevs,
    v: float,
    delta_x_method: str = "Modified_Met_Office",
    max_dist: float | None = None,
    n_blocks: int | None = None,
    store: str = "bf16",
    assemble: str = "auto",
    device=None,
):
    """Matvec form of the covariance, ``cov @ X``, with no f32 n x n
    matrix. Returns ``(matvec, n, trace)``; ``matvec`` is an
    ``ops.sampling.Matvec`` taking (n,) or (n, k) inputs.

    store="bf16": the covariance without its diagonal is stored once in
    bf16 (half the f32 bytes); diag(stdev^2) is added in f32. Each
    application rounds x to bf16 and multiplies with f32 accumulation
    and an f32 result. An order K2 takes is built by K2 from f32 points
    into the (n_pad, n_pad) store, padded to the tile with exact zeros
    (so x is zero-padded instead of the store ever being sliced); any
    other by ``_rows_into`` into one (n, n) store.
    ``assemble`` ("auto" / "pallas" / "scan", the reference's name)
    selects nothing: "pallas" at an order K2 does not take is refused,
    as the reference refuses it.

    store="stream": nothing n x n at all; every application rebuilds the
    tiles. With `max_dist` set it is banded: a latitude-gap certificate
    (``_stream_band_plan``) gives each row block its own column window
    and K3 its per-row-block band limits, and tiles outside are never
    built (they are exact zeros). Applications of at most ``MV_W``
    columns run K3 (f32 points, kernel orders); wider ones build each
    row block's (block x window) tile with K4 into one reused workspace
    and multiply it with ``torch.matmul`` in true f32; with no `n_blocks`
    a banded block has as many rows as keep its tile against the window
    within _TILE_LIMIT_BYTES (256 at 0.1 degree). Within its window
    a latitude-longitude certificate (``_active_chunks``) keeps the
    64-point column chunks that can hold a pair within `max_dist`, and
    the block's tile is built against those alone, gathered with their
    rows of x: a block that spans less than a latitude row skips the
    longitudes beyond the cutoff, a wider one the window's latitudes it
    does not reach. ``matvec.band_stats`` counts the pairs each path
    builds.

    The operator lives on `device`; with no device, on the inputs' if one
    is a tensor, else on the card (``resolve_device``).
    """
    with span("assembly.operator"):
        device = resolve_device(device, sig_flat, lats_rad, lons_rad,
                                sqrt_dets, stdevs)
        P = pack_points(lats_rad, lons_rad, torch.as_tensor(
            sig_flat, device=device), sqrt_dets, stdevs)
        n = P.shape[0]
        # the diagonal in the stream's dtype, in f32 beside the bf16 store
        diag = (P[:, 6] if store == "stream" else P[:, 6].float()) ** 2
        trace = float(torch.sum(diag))
        kernel = (v, delta_x_method, max_dist)
        if store == "stream":
            return _stream_matvec(P, diag, n_blocks, *kernel), n, trace
        if store != "bf16":
            raise ValueError(f"Unknown store: {store!r}")
        return _bf16_matvec(P, diag, assemble, *kernel), n, trace


def stream_plan(lat_rows, lat_cols, block, max_dist):
    """(windows, hi, bw) of the banded stream of the rows against the
    columns (host, numpy latitudes in radians): ``_row_windows``'s
    (r0, r1, c0, c1) per row block of `block` rows, K3's band limits over
    the columns and the uniform window width. With no `max_dist` every
    row block sees every column."""
    n, n_cols = lat_rows.size, lat_cols.size
    n_rb = -(-n // block)
    if max_dist is None:
        nb = -(-n_cols // TILE)
        return (_row_windows(n, block, np.zeros(n_rb, np.int64), n_cols),
                np.full(nb, nb - 1), n_cols)
    lat_pad = np.pad(lat_rows, (0, n_rb * block - n), mode="edge")
    col_starts, bw, hi = _stream_band_plan(
        lat_pad, lat_cols, n_cols, block, float(max_dist), TILE, TILE)
    return _row_windows(n, block, col_starts, bw), hi, bw


def _stream_matvec(P, diag, n_blocks, v, delta_x_method, max_dist):
    """The zero-storage ``Matvec`` of ``ellipse_covariance_operator``."""
    with span("stream.plan"):
        n = P.shape[0]
        block = _block_rows(n, n_blocks)
        lat_np = np.asarray(P[:, 0].cpu(), dtype=np.float64)
        windows, hi, bw = stream_plan(lat_np, lat_np, block, max_dist)
        if n_blocks is None and bw < n:
            # a banded block's tile spans its window, not the n columns
            # that _block_rows sizes it against: the tile-height rule
            # against the window (taller tiles are fewer launches and
            # gathers, and run K4 and the GEMM faster)
            wide = _tile_rows(bw, tile_pair_bytes(v, P.dtype),
                              _TILE_LIMIT_BYTES)
            if wide > block:
                block = min(wide, -(-n // TILE) * TILE)
                windows, hi, bw = stream_plan(lat_np, lat_np, block, max_dist)
        chunks = (None if max_dist is None
                  else _active_chunks(P, windows, bw, max_dist))
    use_fused = matvec_takes(v, P.dtype)
    nb = hi.size
    stats = {
        "banded": bw < n,
        "bw": int(bw),
        "n_cols": n,
        "block": block,
        "col_starts": np.array([c0 for _, _, c0, _ in windows]),
        # the wide path: each row block against its own window
        "wide_pairs": int(sum((r1 - r0) * (c1 - c0)
                              for r0, r1, c0, c1 in windows)),
        # ... of which it builds these: with a cutoff, each block's active
        # chunks alone (the certificate, ``_active_chunks``)
        "kept_pairs": _kept_pairs(windows, chunks),
        # K3: the active upper-triangle tiles
        "fused_pairs": int((hi - np.arange(nb) + 1).sum()) * TILE * TILE,
        "use_fused": use_fused,
    }
    k3_hi = hi if max_dist is not None else None

    def stream(x):
        with span("stream.apply"):
            x2 = _as_2d(x, P)
            count("stream.applications")
            count("stream.columns", x2.shape[1])
            if use_fused and x2.shape[1] <= MV_W:
                with span("stream.fused"):
                    y = ellipse_matvec(P, x2.contiguous(), k3_hi, v,
                                       delta_x_method, max_dist)
            else:
                count("stream.built_pairs", stats["kept_pairs"])
                y = _apply_wide(P, x2, windows, v, delta_x_method, max_dist,
                                chunks=chunks)
            return _finish(y + diag[:, None] * x2, x)

    return Matvec(stream, stats)


def _bf16_matvec(P, diag, assemble, v, delta_x_method, max_dist):
    """The bf16-store ``Matvec`` of ``ellipse_covariance_operator``."""
    n = P.shape[0]
    if assemble not in ("auto", "pallas", "scan"):
        raise ValueError(f"Unknown assemble: {assemble!r}")
    with span("assembly.store"):
        if kernel_order(v) or assemble == "pallas":
            # K2 refuses "pallas" at an order it does not take
            A = ellipse_sym(P.float(), v, delta_x_method, max_dist,
                            out_dtype=torch.bfloat16, add_diag=False,
                            keep_pad=True)
        else:
            A = _rows_into(P, v, delta_x_method, max_dist, torch.empty(
                (n, n), dtype=torch.bfloat16, device=P.device))

    def bf16(x):
        x2 = _as_2d(x, P).float()
        xb = torch.zeros((A.shape[1], x2.shape[1]), dtype=torch.bfloat16,
                         device=P.device)
        xb[:n] = x2
        y = _mm_bf16_f32(A, xb)
        return _finish(y[:n] + diag[:, None] * x2, x)

    return Matvec(bf16)


def _as_2d(x, P):
    x = torch.as_tensor(x, device=P.device)
    x2 = x if x.dim() == 2 else x[:, None]
    return x2.to(P.dtype)


def _finish(y, x):
    return y if torch.as_tensor(x).dim() == 2 else y[:, 0]


def _row_windows(n, block, col_starts, bw):
    """(r0, r1, c0, c1) for each row block: rows [r0, r1) against the
    column window [c0, c1)."""
    return [
        (r0, min(r0 + block, n), int(cs), min(int(cs) + int(bw), n))
        for r0, cs in zip(range(0, n, block), col_starts)
    ]


def _apply_wide(P, x2, windows, v, delta_x_method, max_dist, cols=None,
                chunks=None):
    """y = C x (no diagonal) by row blocks: each block's tile against its
    window into one reused workspace, then a true-f32 GEMM. A window
    whose tile's build would pass _TILE_LIMIT_BYTES goes in column chunks
    of about _CHUNK_BYTES, accumulated in place. `cols` (default `P`) are the
    column points, which x2's rows follow: C = C(P, cols). With `chunks`
    (``_active_chunks``), each block builds its tile against its active
    column chunks alone, gathered with their rows of x2 (the chunks it
    skips hold only pairs beyond the cutoff: exact zeros)."""
    cols = P if cols is None else cols
    n = P.shape[0]
    item = tile_pair_bytes(v, P.dtype)
    block = max(r1 - r0 for r0, r1, _, _ in windows)
    width = max(c1 - c0 for _, _, c0, c1 in windows)
    ccw = width
    if block * width * item > _TILE_LIMIT_BYTES:
        ncc = -(-(block * width * item) // _CHUNK_BYTES)
        ccw = -(-(-(-width // ncc)) // TILE) * TILE
    if chunks is not None:  # gathered pieces are whole chunks
        ccw = -(-ccw // TILE) * TILE
    ws = torch.empty(block * ccw, dtype=P.dtype, device=P.device)
    y = torch.zeros((n, x2.shape[1]), dtype=P.dtype, device=P.device)
    if chunks is not None:
        ptr, ids = chunks
        with span("stream.gather"):
            by_chunk = _by_chunk(cols, x2)
    for b, (r0, r1, c0, c1) in enumerate(windows):
        if chunks is not None:
            cid = ids[ptr[b]:ptr[b + 1]]
            step = ccw // TILE
            with span("stream.gather"):
                pieces = [_gathered(by_chunk, cid[k0:k0 + step])
                          for k0 in range(0, cid.numel(), step)]
        else:
            pieces = [(cols[k0:min(k0 + ccw, c1)], x2[k0:min(k0 + ccw, c1)])
                      for k0 in range(c0, c1, ccw)]
        for cp, xp in pieces:
            tile = ws[: (r1 - r0) * cp.shape[0]].view(r1 - r0, cp.shape[0])
            with span("stream.tile"):
                _tile_into(P[r0:r1], cp, v, delta_x_method, max_dist, tile)
            with span("stream.gemm"):
                y[r0:r1].addmm_(tile, xp)
    return y


def _by_chunk(cols, x2):
    """The column points and x2's rows as (chunks, TILE, .) blocks, padded
    to a whole chunk: the last point repeated, x zero there (so the
    padding adds nothing)."""
    pad = -cols.shape[0] % TILE
    if pad:
        cols = torch.cat([cols, cols[-1:].expand(pad, -1)])
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    return (cols.reshape(-1, TILE, cols.shape[1]),
            x2.reshape(-1, TILE, x2.shape[1]))


def _gathered(by_chunk, cid):
    """The column points and x rows of the chunks `cid`, contiguous."""
    cols, x = by_chunk
    cid = cid.long()
    return (torch.index_select(cols, 0, cid).view(-1, cols.shape[2]),
            torch.index_select(x, 0, cid).view(-1, x.shape[2]))


def _chunk_boxes(P, size):
    """Per run of `size` points (the last padded by its edge), float64 on
    P's device: the latitude range, the least cos(latitude), and the
    longitude interval's centre and half-width (the narrower of the plain
    interval and the one on [0, 2 pi), so that a run across the
    antimeridian stays narrow)."""
    n = P.shape[0]
    m = -(-n // size) * size
    idx = torch.clamp(torch.arange(m, device=P.device), max=n - 1)
    la = P[idx, 0].double().view(-1, size)
    lo = P[idx, 1].double().view(-1, size)
    pmin, pmax = la.amin(1), la.amax(1)
    cmin = torch.cos(torch.maximum(pmin.abs(), pmax.abs()))
    a0, a1 = lo.amin(1), lo.amax(1)
    sh = torch.remainder(lo, 2 * math.pi)
    b0, b1 = sh.amin(1), sh.amax(1)
    use = (b1 - b0) < (a1 - a0)
    centre = torch.where(use, 0.5 * (b0 + b1), 0.5 * (a0 + a1))
    half = torch.where(use, 0.5 * (b1 - b0), 0.5 * (a1 - a0))
    return pmin, pmax, cmin, centre, half


def _active_chunks(P, windows, bw, max_dist, batch=512):
    """The longitude certificate of the stream's row blocks (on P's
    device): for each block, the TILE-point column chunks of its window
    that can hold a pair within `max_dist`.

    For points in two boxes with latitude gap dphi >= 0, cos(lat) >= cA
    and cB, and longitude gap dlam in [0, pi] (circular intervals),
    cos c = cos(lat1 - lat2) - cos lat1 cos lat2 (1 - cos dlam)
          <= cos(dphi) - cA cB (1 - cos dlam),
    so a chunk whose bound on the central angle c passes the cutoff (with
    a 1e-3 margin for the kernels' f32 distances) holds only zeros.
    Returns (ptr, ids): CSR over the blocks (host ptr, device int32 chunk
    ids)."""
    thresh = max_dist / RADIUS_OF_EARTH_KM * (1.0 + 1e-3)
    block = max(r1 - r0 for r0, r1, _, _ in windows)
    rows = _chunk_boxes(P, block)
    cols = _chunk_boxes(P, TILE)
    n_chunks = cols[0].numel()
    wc = -(-bw // TILE)
    starts = torch.as_tensor([c0 // TILE for _, _, c0, _ in windows],
                             device=P.device)
    span = torch.arange(wc, device=P.device)
    ids, counts = [], []
    for b0 in range(0, len(windows), batch):
        b1 = min(b0 + batch, len(windows))
        cid = torch.clamp(starts[b0:b1, None] + span, max=n_chunks - 1)
        r = [t[b0:b1, None] for t in rows]
        c = [t[cid] for t in cols]
        dphi = torch.clamp(torch.maximum(c[0] - r[1], r[0] - c[1]), min=0.0)
        gap = torch.abs(torch.remainder(c[3] - r[3] + math.pi, 2 * math.pi)
                        - math.pi)
        dlam = torch.clamp(gap - c[4] - r[4], min=0.0, max=math.pi)
        cos_c = torch.cos(dphi) - r[2] * c[2] * (1.0 - torch.cos(dlam))
        active = torch.arccos(torch.clamp(cos_c, -1.0, 1.0)) <= thresh
        active &= starts[b0:b1, None] + span < n_chunks
        ids.append(cid[active].int())
        counts.append(active.sum(1).cpu().numpy())
    ptr = np.concatenate([[0], np.cumsum(np.concatenate(counts))])
    return ptr, torch.cat(ids)


def _kept_pairs(windows, chunks):
    """The pairs the wide path builds an application: each block against
    its window, or against its active chunks (`chunks`)."""
    total = 0
    for b, (r0, r1, c0, c1) in enumerate(windows):
        if chunks is not None:
            total += (r1 - r0) * TILE * int(chunks[0][b + 1] - chunks[0][b])
        else:
            total += (r1 - r0) * (c1 - c0)
    return int(total)


def _stream_band_plan(
    lat_pad_np, lat_np, n, block, max_dist_km, chunk, chunk_p
):
    """Column-band certificates from latitude intervals (host, numpy).

    Central angle >= |dlat|, so any (row-block, column-chunk) pair whose
    latitude gap exceeds max_dist / R holds only entries the cutoff
    zeroes, and omitting it is exact. Returns ``col_starts`` ((n_blocks,)
    chunk-aligned window starts), ``bw`` (the uniform window width) and
    ``hi`` ((ceil(n / chunk_p),) upper band limits, hi[i] >= i, for the
    fused matvec). (Port of the reference's ``_stream_band_plan``.)
    """
    thresh = max_dist_km / RADIUS_OF_EARTH_KM
    n_blocks = len(lat_pad_np) // block
    rlat = lat_pad_np.reshape(n_blocks, block)
    rmin, rmax = rlat.min(axis=1), rlat.max(axis=1)
    n_chunks = -(-n // chunk)
    cpad = n_chunks * chunk - n
    clat = (
        np.pad(lat_np, (0, cpad), mode="edge") if cpad else lat_np
    ).reshape(n_chunks, chunk)
    cmin, cmax = clat.min(axis=1), clat.max(axis=1)

    has, first, last = _interval_windows(rmin, rmax, cmin, cmax, thresh)
    bw_chunks = int((last - first + 1).max())
    start = np.minimum(first, n_chunks - bw_chunks).astype(np.int64)
    col_starts = (start * chunk).astype(np.int32)

    n_p = -(-n // chunk_p)
    ppad = n_p * chunk_p - n
    plat = (
        np.pad(lat_np, (0, ppad), mode="edge") if ppad else lat_np
    ).reshape(n_p, chunk_p)
    pmin, pmax = plat.min(axis=1), plat.max(axis=1)
    _, _, last_p = _interval_windows(pmin, pmax, pmin, pmax, thresh)
    hi = np.maximum(last_p, np.arange(n_p)).astype(np.int32)
    return col_starts, bw_chunks * chunk, hi


def _interval_windows(amin, amax, bmin, bmax, thresh):
    """For each row interval [amin_i, amax_i], the first and last column
    interval j within latitude gap `thresh` (bmax_j >= amin_i - thresh
    and bmin_j <= amax_i + thresh). Latitude-sorted columns take two
    searchsorted calls; unsorted ones the pairwise scan (conservative).
    (Port of the reference's ``_interval_windows``.)
    """
    if np.all(np.diff(bmin) >= 0.0) and np.all(np.diff(bmax) >= 0.0):
        first = np.searchsorted(bmax, amin - thresh, side="left")
        last = np.searchsorted(bmin, amax + thresh, side="right") - 1
        has = first <= last
        return (
            has,
            np.where(has, first, 0).astype(np.int64),
            np.where(has, last, 0).astype(np.int64),
        )
    gap = np.maximum(
        0.0,
        np.maximum(
            amin[:, None] - bmax[None, :], bmin[None, :] - amax[:, None]
        ),
    )
    active = gap <= thresh
    has = active.any(axis=1)
    nc = bmin.shape[0]
    first = np.where(has, np.argmax(active, axis=1), 0)
    last = np.where(has, nc - 1 - np.argmax(active[:, ::-1], axis=1), 0)
    return has, first.astype(np.int64), last.astype(np.int64)
