"""Plain kriging against any covariance, in the precision of its inputs
(float64 in every comparison), written from the method's definition.

The covariance enters as K = C(obs, obs) + E, the diagonal c0 = C(x, x)
of the grid and a function ``cross(c0, c1)`` giving the (m, c1 - c0)
block C(obs, grid[c0:c1]), so that nothing (m, n) is held at once.

Ordinary kriging solves the bordered system [[K, 1], [1', 0]] [w; a] =
[c; 1] for every grid column by one LU factorisation. Its uncertainty is
the one GloMarGridding's ``kriging_ordinary`` reports:
c0 - sum([w; a] * [c; 1]) - a, which takes the Lagrange multiplier a
twice. The constraint mask is c' K^-1 c / c0, the share of the variance
the simple-kriging weights explain.
"""

import torch

BLOCK = 8192


def _bordered(K):
    m = K.shape[0]
    B = K.new_zeros((m + 1, m + 1))
    B[:m, :m] = K
    B[:m, m] = 1.0
    B[m, :m] = 1.0
    return torch.linalg.lu_factor(B)


def ordinary(K, cross, c0, y, block=BLOCK):
    """(field, uncertainty, constraint mask) of ordinary kriging."""
    m, n = K.shape[0], c0.shape[0]
    lu = _bordered(K)
    L = torch.linalg.cholesky(K)
    field, unc, mask = (torch.empty_like(c0) for _ in range(3))
    for a in range(0, n, block):
        b = min(a + block, n)
        Cx = cross(a, b)
        R = torch.cat([Cx, Cx.new_ones((1, b - a))])
        W = torch.linalg.lu_solve(*lu, R)
        field[a:b] = W[:m].T @ y
        unc2 = c0[a:b] - torch.sum(W * R, dim=0) - W[m]
        unc[a:b] = torch.sqrt(torch.clamp(unc2, min=0.0))
        mask[a:b] = torch.sum(Cx * torch.cholesky_solve(Cx, L), dim=0) / c0[a:b]
    return field, unc, mask


def simple(K, cross, c0, y, mean=0.0, block=BLOCK):
    """(field, uncertainty, constraint mask) of simple kriging about a
    known `mean`."""
    n = c0.shape[0]
    L = torch.linalg.cholesky(K)
    w = torch.cholesky_solve((y - mean)[:, None], L)[:, 0]
    field, unc, mask = (torch.empty_like(c0) for _ in range(3))
    for a in range(0, n, block):
        b = min(a + block, n)
        Cx = cross(a, b)
        field[a:b] = Cx.T @ w + mean
        sv = torch.sum(Cx * torch.cholesky_solve(Cx, L), dim=0)
        unc[a:b] = torch.sqrt(torch.clamp(c0[a:b] - sv, min=0.0))
        mask[a:b] = sv / c0[a:b]
    return field, unc, mask


def kriged_draws(K, cross, n, sim_obs, block=BLOCK):
    """(members, n): C(grid, obs) K^-1 s for each column s of `sim_obs`
    (m, members), the simple-kriged simulated observations."""
    A = torch.linalg.solve(K, sim_obs)
    out = sim_obs.new_empty((sim_obs.shape[1], n))
    for a in range(0, n, block):
        b = min(a + block, n)
        out[:, a:b] = (cross(a, b).T @ A).T
    return out
