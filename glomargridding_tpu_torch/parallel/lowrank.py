r"""Non-stationary kriging and ensembles on a factored covariance,
sharded over the (grid x ens) mesh.

Port of ``glomargridding_tpu/parallel/lowrank.py``. ``models.lowrank``
kriges and draws members off C = diag(f) + V diag(g) V' on one device;
here the factors are sharded:

- ``V`` and the floor ``f`` are ROW-sharded over ``grid``, so every
  n-sized contraction of the solve (``V (g (V_o' z))``, the diagnostic
  Gram form, the state draws) is local to a slot's rows;
- ``V_o = V[idx]`` and ``f[idx]`` are gathered by a one-hot psum (each
  slot contributes the observed rows it holds), and so are the states
  at the observed cells;
- the m x m observation system is solved once, on the first slot, and
  what the rows need of it (u, w, K^-1 V_o, diag K^-1, K^-1 sim_obs) is
  broadcast: O(m (r + members)) per call, never O(n);
- members are sharded over (``ens``, ``grid``).

The reference re-jits its local core with shardings and lets the SPMD
partitioner place these collectives; here they are written out, around
the same pieces of ``models.lowrank`` that the local path runs.
"""

import torch

from ..models.lowrank import (
    LowRankKrigingResult,
    _error_forms,
    _finish_rows,
    _inputs,
    _is_diagonal,
    _members_rows,
    _obs_noise,
    _obs_solve,
    _result,
    _states,
)
from ..ops.covariance_tools import LowRankPSD, _normals
from .mesh import Sharded, gather_rows, local_indices, move, shard_rows


def _sharded_solve(mesh, psd, idx, obs, error_cov, n_members, generator,
                   noise):
    idx, y, E = _inputs(psd, idx, obs, error_cov)
    e_diag = _is_diagonal(E)
    devices = mesh.axis_devices("grid")
    n_grid, n_ens = mesh.shape["grid"], mesh.shape["ens"]
    first = devices[0]
    n, r = psd.vectors.shape
    m = idx.shape[0]
    V_parts = shard_rows(psd.vectors, devices)
    f_parts = shard_rows(psd.floor, devices)
    g = move(psd.gains.to(psd.vectors.dtype), first)
    idx, y = move(idx, first), move(y, first)
    E, e_vec = _error_forms(move(E, first), e_diag)
    V_o = gather_rows(V_parts, idx, devices)[0]
    f_o = gather_rows(f_parts, idx, devices)[0]
    rows = n // n_grid

    sim_obs = None
    states = {}
    if n_members > 0:
        z1, z2, zo = _normals(
            noise, generator,
            [(n, n_members), (r, n_members), (m, n_members)], V_o)
        per_e = n_members // n_ens
        picked = []
        for e in range(n_ens):
            sl = slice(e * per_e, (e + 1) * per_e)
            slots = list(mesh.devices[:, e])
            for k, d in enumerate(slots):
                states[k, e] = _states(
                    move(V_parts[k], d), move(g, d), move(f_parts[k], d),
                    move(z1[k * rows:(k + 1) * rows, sl], d),
                    move(z2[:, sl], d))
            picked.append(gather_rows([states[k, e] for k in range(n_grid)],
                                      idx, slots)[0])
        sim_obs = torch.cat([move(p, first) for p in picked], dim=1)
        sim_obs = sim_obs + _obs_noise(E, e_vec, zo, e_diag)

    sol = _obs_solve(V_o, g, f_o, E, e_vec, y, sim_obs, True, e_diag)

    outs, members = [], [None] * (n_ens * n_grid)
    for k, d in enumerate(devices):
        local, inside = local_indices(move(idx, d), k * rows,
                                      (k + 1) * rows)
        args = (move(g, d), move(V_o, d), move(f_o, d))
        sol_d = type(sol)(*(None if t is None else move(t, d) for t in sol))
        field, uncert2, cmask = _finish_rows(
            V_parts[k], args[0], f_parts[k], args[1], args[2], local,
            inside, move(y, d), sol_d)
        outs.append((field, uncert2, cmask))
        for e in range(n_ens if n_members > 0 else 0):
            de = mesh.devices[k, e]
            sl = slice(e * per_e, (e + 1) * per_e)
            members[e * n_grid + k] = _members_rows(
                move(V_parts[k], de), *(move(a, de) for a in args),
                move(local, de), move(inside, de), move(sol.A[:, sl], de),
                states[k, e], move(field, de))
    members = Sharded(members, (n_ens, n_grid)) if n_members > 0 else None
    return (*(Sharded([o[i] for o in outs]) for i in range(3)), members)


def _sharded_result(field, uncert2, cmask):
    parts = [_result(*p) for p in zip(field.parts, uncert2.parts,
                                      cmask.parts)]
    return LowRankKrigingResult(*(Sharded([p[i] for p in parts])
                                  for i in range(3)))


def sharded_lowrank_kriging(
    mesh, psd: LowRankPSD, idx, obs, error_cov
) -> LowRankKrigingResult:
    """Ordinary kriging off row-sharded factors; outputs grid-sharded.

    Exact (the algebra of ``models.lowrank.lowrank_kriging``); the grid
    dimension n must be divisible by the ``grid`` axis size. Returns a
    ``LowRankKrigingResult`` of ``Sharded`` vectors.
    """
    field, uncert2, cmask, _ = _sharded_solve(
        mesh, psd, idx, obs, error_cov, 0, None, None)
    return _sharded_result(field, uncert2, cmask)


def sharded_lowrank_ensemble_step(
    mesh,
    psd: LowRankPSD,
    idx,
    obs,
    error_cov,
    generator: torch.Generator | None = None,
    n_members: int = 100,
    noise=None,
):
    """Two-stage perturbation ensemble off row-sharded factors.

    Same scheme as ``models.lowrank.lowrank_ensemble_step`` (exact
    factored N(0, C) states, simple-kriged simulated obs, member =
    field + grid_sim - state). The standard normals come from
    `generator`, drawn on the first slot, or are given as
    ``noise=(z1, z2, zo)`` of shapes (n, members), (r, members),
    (m, members), so the same draws give the local path's members up to
    the order of reductions. Returns (result, members): the
    ``LowRankKrigingResult`` sharded over ``grid`` and the members over
    (``ens``, ``grid``).
    """
    if n_members % mesh.shape["ens"] != 0:
        raise ValueError(
            f"n_members={n_members} must be divisible by the ens axis "
            f"size {mesh.shape['ens']}"
        )
    field, uncert2, cmask, members = _sharded_solve(
        mesh, psd, idx, obs, error_cov, int(n_members), generator, noise)
    return _sharded_result(field, uncert2, cmask), members
