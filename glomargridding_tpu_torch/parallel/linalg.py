r"""Distributed dense linear algebra over the slots of a mesh axis.

Port of ``glomargridding_tpu/parallel/linalg.py``. A right-looking
blocked Cholesky: the matrix lives as row blocks, slot s owning blocks
[s * B / n_slots, (s + 1) * B / n_slots), and never exists whole on any
slot. Per block column j:

1. the owner of row block j factorises its diagonal tile (nb x nb), and
   the factor is broadcast;
2. every slot triangular-solves its own row tiles of the panel column;
3. each slot applies the trailing rank-nb update to its rows over the
   columns [(j + 1) nb, its last row], one product for each slot's
   piece of the panel, which moves to it (the reference updates the full
   width under a column mask, for XLA's static shapes; nothing here
   needs it).

Peak memory per slot is n^2 / n_slots + O(n nb / n_slots). The diagonal factor,
the panel solve and the trailing GEMM are ``torch.linalg`` /
``torch.matmul`` in the input's dtype (true f32 for f32: the port never
enables TF32). A forward triangular solve with the same layout
(``sharded_triangular_solve``) applies the factor without gathering it.
"""

import torch

from .mesh import Sharded, broadcast, move, psum, shard_rows


def _resolve_blocks(n: int, n_dev: int, n_blocks: int | None) -> int:
    if n_blocks is None:
        n_blocks = max(n_dev, min(32, n // 128 if n >= 128 else n_dev))
        n_blocks = max(n_dev, (n_blocks // n_dev) * n_dev)
    if n % n_blocks != 0 or n_blocks % n_dev != 0:
        raise ValueError(
            f"n={n} must divide into n_blocks={n_blocks} divisible by the "
            f"axis size {n_dev}"
        )
    return n_blocks


def resolve_blocks_padded(
    n: int, n_dev: int, n_blocks: int | None
) -> tuple[int, int]:
    """(n_blocks, n_padded) for an ARBITRARY n: the single source of the
    block-count heuristic for callers that can pad (the ensemble step
    pads the covariance with an identity tail). n_padded is the smallest
    multiple of the chosen block count >= n."""
    if n_blocks is None:
        n_blocks = max(n_dev, min(32, n // 128 if n >= 128 else n_dev))
        n_blocks = max(n_dev, (n_blocks // n_dev) * n_dev)
    n_pad = -(-n // n_blocks) * n_blocks
    return _resolve_blocks(n_pad, n_dev, n_blocks), n_pad


def make_sharded_cholesky(mesh, n: int, n_blocks: int, axis: str = "grid"):
    """The blocked Cholesky as ``chol(parts)``: `parts` are the slots'
    (n / n_slots, n) row blocks of an SPD matrix, overwritten in place by
    the rows of its lower factor L (strict upper triangle zeroed), and
    returned."""
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    nb = n // n_blocks
    blocks_per_dev = n_blocks // n_dev
    rows = blocks_per_dev * nb

    def chol(parts):
        for j in range(n_blocks):
            owner, j_local = divmod(j, blocks_per_dev)
            c0, c1 = j * nb, (j + 1) * nb
            row_j = parts[owner][j_local * nb:(j_local + 1) * nb]
            L_jj = torch.linalg.cholesky(row_j[:, c0:c1])
            row_j[:, c0:c1] = L_jj
            row_j[:, c1:] = 0.0
            if c1 == n:
                break
            L_on = broadcast(L_jj, devices)
            # panel tiles L_ij = A_ij L_jj^-T of every slot's rows below j
            panels = []
            for s in range(n_dev):
                lo = max(0, c1 - s * rows)
                if lo >= rows:
                    panels.append(None)
                    continue
                tiles = parts[s][lo:, c0:c1]
                tiles.copy_(torch.linalg.solve_triangular(
                    L_on[s].T, tiles, upper=True, left=False))
                panels.append(tiles)
            # trailing update of each slot's rows below j over the columns
            # [c1, (s + 1) rows): one product per panel piece of a slot
            # t <= s, whose rows are those columns (a piece moves only
            # between slots of two devices)
            for s, d in enumerate(devices):
                if panels[s] is None:
                    continue
                lo = max(0, c1 - s * rows)
                for t in range(s + 1):
                    if panels[t] is None:
                        continue
                    g0, g1 = max(c1, t * rows), (t + 1) * rows
                    parts[s][lo:, g0:g1].addmm_(
                        panels[s], move(panels[t], d).T, alpha=-1.0)
        return parts

    return chol


def _row_parts(mesh, A, axis, copy):
    return shard_rows(A, mesh.axis_devices(axis), copy=copy)


def sharded_cholesky(mesh, A, n_blocks: int | None = None, axis: str = "grid"):
    """Lower Cholesky factor of an SPD matrix, row-sharded over `axis`.

    `A` is (n, n): numpy, a tensor or a row-``Sharded`` (n divisible by
    n_blocks, n_blocks divisible by the axis size). Returns L as a
    ``Sharded`` of the slots' (n / n_slots, n) row blocks, strict upper
    triangle zeroed. The input is not modified.
    """
    n = A.shape[0]
    n_blocks = _resolve_blocks(n, mesh.shape[axis], n_blocks)
    parts = _row_parts(mesh, A, axis, copy=True)
    return Sharded(make_sharded_cholesky(mesh, n, n_blocks, axis)(parts))


def make_sharded_triangular_solve(
    mesh, n: int, n_rhs: int, n_blocks: int, axis: str = "grid"
):
    """Forward substitution as ``solve(L_parts, B)``: L's row blocks on
    the slots, B (n, n_rhs) a tensor; solves L X = B without gathering L.
    X is replicated (every slot holds the solution as it grows); the
    first slot's copy is returned. Each step is one (nb, j nb) x
    (j nb, n_rhs) product on the owner and the broadcast of the nb solved
    rows."""
    devices = mesh.axis_devices(axis)
    nb = n // n_blocks
    blocks_per_dev = n_blocks // len(devices)

    def solve(L_parts, B):
        X = {d: torch.zeros((n, n_rhs), dtype=B.dtype, device=d)
             for d in devices}
        Bs = {d: move(B, d) for d in devices}
        for j in range(n_blocks):
            owner, j_local = divmod(j, blocks_per_dev)
            d = devices[owner]
            c0, c1 = j * nb, (j + 1) * nb
            row = L_parts[owner][j_local * nb:(j_local + 1) * nb]
            rhs = Bs[d][c0:c1] - row[:, :c0] @ X[d][:c0]
            x_j = torch.linalg.solve_triangular(row[:, c0:c1], rhs,
                                                upper=False)
            for dd in X:
                X[dd][c0:c1] = move(x_j, dd)
        return X[devices[0]]

    return solve


def sharded_triangular_solve(
    mesh, L, B, n_blocks: int | None = None, axis: str = "grid"
):
    """Solve L X = B (L lower-triangular and row-sharded; B (n,) or
    (n, k)). Returns X on the mesh's first slot of `axis`, (n,) for a
    1-d B."""
    n = L.shape[0]
    L_parts = _row_parts(mesh, L, axis, copy=False)
    B = torch.as_tensor(B, device=L_parts[0].device).to(L_parts[0].dtype)
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    n_blocks = _resolve_blocks(n, mesh.shape[axis], n_blocks)
    solve = make_sharded_triangular_solve(mesh, n, int(B.shape[1]),
                                          n_blocks, axis)
    X = solve(L_parts, B)
    return X[:, 0] if squeeze else X


_LOG_2PI = 1.8378770664093453


def sharded_whiten(mesh, L, X, n_blocks: int | None = None,
                   axis: str = "grid"):
    """Whiten fields against a sharded factor: z = L^{-1} X.

    With a covariance C = L L' factored by :func:`sharded_cholesky`,
    whitening turns correlated fields or residuals into iid N(0, 1)
    coordinates (standardised residual QC, de-correlation before
    per-cell statistics, the quadratic form of every Gaussian score).
    X may be (n,) or (n, b); the factor never leaves its row blocks.
    """
    return sharded_triangular_solve(mesh, L, X, n_blocks, axis)


def sharded_mvn_logpdf(mesh, L, x, mean=None, n_blocks: int | None = None,
                       axis: str = "grid"):
    r"""log N(x; mean, L L') from the sharded factor, never gathering it.

    .. math::
        \log p = -\tfrac12 \|L^{-1}(x-\mu)\|^2 - \sum_i \log L_{ii}
                 - \tfrac{n}{2}\log 2\pi

    `x` may be (n,) for one field or (n, b) for a batch scored under the
    same factor; returns a scalar or (b,) scores, on the first slot. The
    log-determinant is summed per slot from its rows' diagonal entries
    and psummed.
    """
    devices = mesh.axis_devices(axis)
    L_parts = _row_parts(mesh, L, axis, copy=False)
    like = dict(dtype=L_parts[0].dtype, device=L_parts[0].device)
    x = torch.as_tensor(x, **like)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    if mean is not None:
        x = x - torch.as_tensor(mean, **like).reshape(-1, 1)
    n = x.shape[0]
    z = sharded_triangular_solve(mesh, Sharded(L_parts), x,
                                 n_blocks, axis)
    quad = torch.sum(z * z, dim=0)
    logdets, start = [], 0
    for p in L_parts:
        k = torch.arange(p.shape[0], device=p.device)
        logdets.append(torch.sum(torch.log(p[k, start + k])))
        start += p.shape[0]
    logdet = psum(logdets, devices)[0]
    out = -0.5 * quad - logdet - 0.5 * n * _LOG_2PI
    return out[0] if squeeze else out
