r"""Sharded kriging pipelines over a mesh.

Port of ``glomargridding_tpu/parallel/kriging.py``. The observation
system K = C_obs + E is small (n ~ thousands) and replicated; everything
sized by the output grid M (C_cross columns, field, uncertainty,
simulated states) is sharded over the ``grid`` axis, and ensemble
members over ``ens`` as well. The M x M covariance stays in row blocks
end to end: the observation blocks are read shard-locally (a column
gather of each slot's rows, K's rows psummed from the slots that hold
them, the diagonal a local pick), so no slot ever holds the M x M matrix
or its factor, and the ensemble step factors it with the blocked
Cholesky of ``parallel.linalg``.
"""

import torch

from ..models.kriging import _ordinary_core
from ..ops.covariance_tools import _normals
from .linalg import make_sharded_cholesky, resolve_blocks_padded
from .mesh import (
    Sharded,
    gather_rows,
    local_indices,
    move,
    psum,
    row_slice,
    shard_rows,
    trim,
)


def _obs_blocks(parts, idx, devices):
    """(K, C_cross' blocks, diagonal blocks) from row blocks of the
    covariance: K (n, n) on every slot, psummed from the rows each slot
    holds; slot s's (rows, n) block of C_cross' = cov[rows_s, idx] (a
    column gather of its own rows, by symmetry) and its diagonal."""
    K_local, Ct, diag, start = [], [], [], 0
    for p, d in zip(parts, devices):
        idx_d = move(idx, d)
        Ct_s = p[:, idx_d]
        rows, inside = local_indices(idx_d, start, start + p.shape[0])
        K_local.append(torch.where(inside[:, None], Ct_s[rows],
                                   torch.zeros((), dtype=p.dtype, device=d)))
        Ct.append(Ct_s)
        k = torch.arange(p.shape[0], device=d)
        diag.append(p[k, start + k])
        start += p.shape[0]
    return psum(K_local, devices), Ct, diag


def sharded_ordinary_kriging(mesh, covariance, idx, obs, error_cov=None):
    """Ordinary kriging with the output grid sharded over the mesh.

    `covariance` is the dense M x M grid covariance (numpy, a tensor or
    a row-``Sharded``, M divisible by the grid axis size), `idx`/`obs`
    the observed gridboxes and values. Returns (field, uncertainty^2,
    constraint_mask), each a ``Sharded`` vector over ``grid``.
    """
    devices = mesh.axis_devices("grid")
    parts = shard_rows(covariance, devices)
    like = dict(dtype=parts[0].dtype, device=devices[0])
    idx = torch.as_tensor(idx, device=devices[0]).long()
    y = torch.as_tensor(obs, **like)
    E = None if error_cov is None else torch.as_tensor(error_cov, **like)
    K, Ct, diag = _obs_blocks(parts, idx, devices)
    out = []
    for s, d in enumerate(devices):
        K_s = K[s] if E is None else K[s] + move(E, d)
        field, uncert2, cmask, *_ = _ordinary_core(
            K_s, Ct[s].T, diag[s], move(y, d))
        out.append((field, uncert2, cmask))
    return tuple(Sharded([o[k] for o in out]) for k in range(3))


def ensemble_kriging_step(
    mesh,
    covariance,
    error_cov,
    idx,
    obs,
    n_members: int,
    n_blocks: int | None = None,
    *,
    generator=None,
    noise=None,
):
    """Full stochastic-kriging ensemble step, sharded over (grid, ens).

    The M x M grid covariance stays ROW-SHARDED end to end: it is
    factorised by the blocked Cholesky (``parallel.linalg``; no slot
    holds the full matrix or the full factor), and the state draws apply
    the sharded factor locally (slot (g, e) computes its rows of L z for
    its members). Only the small observation system K = C_obs + E is
    replicated. Both `covariance` and `error_cov` must be symmetric
    positive-definite. A grid that does not divide into the blocks is
    padded with an IDENTITY tail (SPD is preserved and the factor's
    tail rows are e_i), and the outputs are cut back to M.

    The standard normals come from `generator` (drawn on the first slot)
    or are given as ``noise=(z_state, z_obs)`` of shapes (n_members, M)
    and (n_members, n_obs), as ``models.stochastic.batched_ensemble_step``
    takes them. Returns ``Sharded`` (members (n_members, M) in
    (ens, grid) blocks, field (M,), uncert2 (M,)).
    """
    n_ens = mesh.shape["ens"]
    if n_members % n_ens != 0:
        raise ValueError(
            f"n_members={n_members} must be divisible by the ens axis "
            f"size {n_ens}"
        )
    devices = mesh.axis_devices("grid")
    m_true = covariance.shape[0]
    n_blocks, m = resolve_blocks_padded(m_true, len(devices), n_blocks)
    rows = m // len(devices)
    first = row_slice(covariance, 0, 1)
    parts = []
    for s, d in enumerate(devices):
        r0, r1 = s * rows, (s + 1) * rows
        block = torch.zeros((rows, m), dtype=first.dtype, device=d)
        if r0 < m_true:
            block[:min(r1, m_true) - r0, :m_true] = move(
                row_slice(covariance, r0, min(r1, m_true)), d)
        tail = torch.arange(min(max(r0, m_true), r1), r1, device=d)
        block[tail - r0, tail] = 1.0
        parts.append(block)
    like = dict(dtype=first.dtype, device=devices[0])
    E = torch.as_tensor(error_cov, **like)
    idx = torch.as_tensor(idx, device=devices[0]).long()
    y = torch.as_tensor(obs, **like)
    z_state, z_obs = _normals(
        noise, generator, [(n_members, m_true), (n_members, idx.shape[0])],
        y)
    if m != m_true:
        z_state = torch.nn.functional.pad(z_state, (0, m - m_true))
    step = make_ensemble_step(mesh, m, n_blocks)
    members, field, uncert2 = step(parts, E, idx, y, z_state, z_obs)
    if m != m_true:  # drop the identity-pad tail
        n_grid = len(devices)
        members = Sharded(
            [p for e in range(n_ens)
             for p in trim(members.parts[e * n_grid:(e + 1) * n_grid],
                           m_true, dim=1)],
            members.blocks)
        field = Sharded(trim(field.parts, m_true))
        uncert2 = Sharded(trim(uncert2.parts, m_true))
    return members, field, uncert2


def make_ensemble_step(mesh, m: int, n_blocks: int):
    """The ensemble step for an (m, n_blocks) problem shape, on inputs
    already in place: ``step(parts, E, idx, y, z_state, z_obs)`` with
    `parts` the grid slots' (m / n_grid, m) row blocks of the (padded)
    covariance, overwritten by its factor's; E, idx, y on the first slot;
    z_state (n_members, m) and z_obs (n_members, n_obs). Returns
    ``Sharded`` (members, field, uncert2).

    Exposed apart from :func:`ensemble_kriging_step` so that what each
    slot holds can be counted without the covariance
    (:func:`ensemble_step_memory_analysis`).
    """
    devices = mesh.axis_devices("grid")
    n_grid, n_ens = mesh.shape["grid"], mesh.shape["ens"]
    chol = make_sharded_cholesky(mesh, m, n_blocks, axis="grid")

    def step(parts, E, idx, y, z_state, z_obs):
        K, Ct, diag = _obs_blocks(parts, idx, devices)
        field, uncert2, V = [], [], []
        for s, d in enumerate(devices):
            f_s, u_s, _, V_s, _, _ = _ordinary_core(
                K[s] + move(E, d), Ct[s].T, diag[s], move(y, d))
            field.append(f_s)
            uncert2.append(u_s)
            V.append(V_s)
        del K, Ct, diag
        L_parts = chol(parts)  # the factor of the grid covariance
        obs_noise = z_obs @ torch.linalg.cholesky(E).T  # (members, n)
        per_e = z_state.shape[0] // n_ens
        members = [None] * (n_ens * n_grid)
        for e in range(n_ens):
            sl = slice(e * per_e, (e + 1) * per_e)
            slots = list(mesh.devices[:, e])
            # states: slot (g, e)'s rows of L z for its members
            states = [move(L_parts[g], d) @ move(z_state[sl].T, d)
                      for g, d in enumerate(slots)]
            # the states at the observed cells: a shard-local pick, psummed
            sim_obs = gather_rows(states, idx, slots)
            for g, d in enumerate(slots):
                sim = sim_obs[g].T + move(obs_noise[sl], d)  # (per_e, n)
                members[e * n_grid + g] = move(field[g], d)[None, :] + (
                    sim @ move(V[g], d) - states[g].T)
        return (Sharded(members, (n_ens, n_grid)), Sharded(field),
                Sharded(uncert2))

    return step


def ensemble_step_memory_analysis(
    mesh,
    m: int,
    n_obs: int,
    n_members: int,
    n_blocks: int | None = None,
    dtype=torch.float32,
):
    """Count, from the shapes, the bytes each slot holds at the peak of
    :func:`make_ensemble_step` (nothing is allocated).

    Returns ``(per_slot_peak_bytes, full_matrix_bytes, None)``: the
    reference's tuple, whose third entry (XLA's memory analysis) PyTorch
    has no counterpart for. The count is the shard, which the factor
    overwrites in place; the observation blocks (C_cross' rows, the
    kriging weights V, K and its psum); the Cholesky loop's panel tiles,
    their solve's result, the panel piece moved in from another slot and
    the diagonal factor; and the draws (z, the states, the simulated
    observations, the members and their product). The design invariant:
    NO slot holds the full M x M covariance or factor, so the peak is
    O(shard), ``peak <= 5 * full / n_grid`` whatever the axis size; an
    all-gather of the store would make peak / shard grow with the axis.
    """
    n_grid, n_ens = mesh.shape["grid"], mesh.shape["ens"]
    n_blocks, m_pad = resolve_blocks_padded(m, n_grid, n_blocks)
    nb = m_pad // n_blocks
    rows = m_pad // n_grid
    per_e = -(-n_members // n_ens)
    values = (
        rows * m_pad  # the shard, then the factor in place
        + 2 * rows * n_obs + 2 * n_obs * n_obs  # C_cross' rows, V; K, psum
        + 3 * rows * nb + nb * nb  # panel tiles, solve result, moved piece
        + m_pad * per_e + 3 * rows * per_e + 2 * n_obs * per_e  # draws
    )
    itemsize = torch.empty((), dtype=dtype).element_size()
    return values * itemsize, m_pad * m_pad * itemsize, None
