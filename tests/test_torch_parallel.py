"""The port's ``parallel`` package against the JAX package's, on the CPU.

Each test of ``tests/test_parallel.py`` has its counterpart here: the JAX
function runs on the 8-device virtual CPU mesh of ``tests/conftest.py``,
the port's on a mesh of eight CPU slots (``make_mesh(devices=["cpu"] *
8)``) of the same shape, both on the same numpy inputs from a seed.
Keyed draws are replayed: the port takes the reference's normals as
``noise=``.

Bounds, as max |port - JAX| / max |JAX| unless a test says otherwise:
f64 Cholesky, triangular solves, whitening and scores 1e-10; f64 kriging
and fields 1e-9; where the JAX test runs in f32, its own tolerances (the
stream operator rtol 2e-4 / atol 2e-5 against the dense product, the
clip 5e-4 relative Frobenius error against the full dense clip, the
factored path's 1e-5 / 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ellipse import _initialise_covariance
from test_torch_eigsh import reference_draws

from glomargridding_tpu import parallel as jpar
from glomargridding_tpu.core.labeled import Coordinates as JCoordinates
from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.models.ellipse import EllipseBuilder as JBuilder
from glomargridding_tpu.models.ellipse import EllipseModel as JModel
from glomargridding_tpu.models.ellipse.covariance import (
    ellipse_covariance_block as jblock,
)
from glomargridding_tpu.models.kriging import OrdinaryKriging as JOrdinary
from glomargridding_tpu.ops.covariance_tools import (
    LowRankPSD as JLowRankPSD,
    explained_variance_clip as jclip_dense,
    explained_variance_clip_lowrank as jclip,
)
from glomargridding_tpu.ops.distances import sigma_rot_flat as jsigma
from glomargridding_tpu.ops.variogram import MaternVariogram as JMatern
from glomargridding_tpu_torch import convert, parallel as tpar
from glomargridding_tpu_torch.models.ellipse import EllipseBuilder
from glomargridding_tpu_torch.models.ellipse.covariance import (
    _ellipse_inputs,
    ellipse_covariance_operator,
)
from glomargridding_tpu_torch.models.kernel_kriging import (
    kriging_from_kernel,
    variogram_kernel,
)
from glomargridding_tpu_torch.models.lowrank import (
    lowrank_ensemble_step,
    lowrank_kriging,
)
from glomargridding_tpu_torch.ops.covariance_tools import (
    LowRankPSD,
    explained_variance_clip_lowrank,
)
from glomargridding_tpu_torch.ops.sampling import Matvec
from glomargridding_tpu_torch.ops.variogram import MaternVariogram
from glomargridding_tpu_torch.parallel import mesh as tmesh
from glomargridding_tpu_torch.parallel.kriging import (
    ensemble_step_memory_analysis,
)
from glomargridding_tpu_torch.parallel.linalg import resolve_blocks_padded

torch.set_num_threads(2)

LINALG_TOL = 1e-10  # f64 Cholesky, solves, whitening, scores
FIELD_TOL = 1e-9  # f64 kriging and fields
CPU8 = ["cpu"] * 8


def _meshes(n_grid, n_ens):
    return (jpar.make_mesh(n_grid=n_grid, n_ens=n_ens),
            tpar.make_mesh(n_grid=n_grid, n_ens=n_ens, devices=CPU8))


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.max(np.abs(ours - ref)) / np.max(np.abs(ref))


def _problem(rng, m=128, n_obs=10):
    pts = rng.uniform(0, 1, size=(m, 2))
    d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    cov = np.exp(-d / 0.3) + 1e-6 * np.eye(m)
    idx = np.sort(rng.choice(m, size=n_obs, replace=False))
    obs = rng.normal(size=n_obs)
    err = 0.05 * np.eye(n_obs)
    return cov, idx, obs, err


def _ensemble_noise(key, m, n_obs, n_members, dtype=np.float64, n_grid=4):
    """The reference ensemble step's normals, as the port's noise: z over
    the block-padded grid (the pad rows never reach a real output) and
    the observation noise."""
    _, m_pad = resolve_blocks_padded(m, n_grid, None)
    k_state, k_obs = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_state, (m_pad, n_members), dtype))
    zo = np.asarray(jax.random.normal(k_obs, (n_members, n_obs), dtype))
    return z[:m].T, zo


def _slot_shapes(sharded):
    return {tuple(p.shape) for p in sharded.parts}


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------
def test_make_mesh_factorisations(monkeypatch):
    jmesh = jpar.make_mesh()
    mesh = tpar.make_mesh(devices=CPU8)
    assert mesh.devices.size == jmesh.devices.size == 8
    assert mesh.shape == dict(jmesh.shape) == {"grid": 8, "ens": 1}
    mesh2 = tpar.make_mesh(n_grid=4, n_ens=2, devices=CPU8)
    assert mesh2.shape == dict(jpar.make_mesh(n_grid=4, n_ens=2).shape)
    assert tpar.make_mesh(n_ens=2, devices=CPU8).shape == {"grid": 4,
                                                            "ens": 2}
    with pytest.raises(ValueError):
        tpar.make_mesh(n_grid=3, n_ens=2, devices=CPU8)
    # the default mesh is every card; without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()


def test_psum_and_owner_broadcast():
    devices = [torch.device("cpu")] * 4
    parts = [torch.full((3,), float(k + 1)) for k in range(4)]
    for out in tmesh.psum(parts, devices):
        assert torch.equal(out, torch.full((3,), 10.0))
    for out in tmesh.broadcast(parts[2], devices):
        assert torch.equal(out, parts[2])
    # the psum leaves its inputs as they were
    assert torch.equal(parts[0], torch.full((3,), 1.0))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_shift_visits_every_shard(n):
    """n ring steps show each slot every shard once, in the order of the
    reference's ppermute pairs (j, j + 1)."""
    devices = [torch.device("cpu")] * n
    held = [torch.tensor([k]) for k in range(n)]
    seen = [[] for _ in range(n)]
    for _ in range(n):
        for s in range(n):
            seen[s].append(int(held[s]))
        held = tmesh.ring_shift(held, devices)
    for s in range(n):
        assert seen[s] == [(s - t) % n for t in range(n)]
    assert [int(h) for h in held] == list(range(n))


def test_shard_gather_and_row_gather(rng):
    x = rng.normal(size=(24, 3))
    devices = [torch.device("cpu")] * 4
    parts = tmesh.shard_rows(x, devices)
    assert [tuple(p.shape) for p in parts] == [(6, 3)] * 4
    sharded = tmesh.Sharded(parts)
    np.testing.assert_array_equal(np.asarray(sharded), x)
    np.testing.assert_array_equal(tmesh.row_slice(sharded, 5, 13).numpy(),
                                  x[5:13])
    idx = torch.tensor([23, 0, 7, 7, 12])
    for out in tmesh.gather_rows(parts, idx, devices):
        np.testing.assert_array_equal(out.numpy(), x[idx.numpy()])
    copies = tmesh.shard_rows(torch.from_numpy(x), devices, copy=True)
    copies[0].zero_()
    assert np.abs(x[:6]).sum() > 0  # a copy never aliases the input
    with pytest.raises(ValueError, match="divisible"):
        tmesh.shard_rows(x, [torch.device("cpu")] * 5)


# ---------------------------------------------------------------------------
# Kriging and the ensemble step
# ---------------------------------------------------------------------------
def test_sharded_matches_single_device(rng):
    cov, idx, obs, err = _problem(rng)
    jmesh, mesh = _meshes(8, 1)
    ref = jpar.sharded_ordinary_kriging(jmesh, cov, idx, obs, err)
    ours = tpar.sharded_ordinary_kriging(mesh, cov, idx, obs, err)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= FIELD_TOL
    OK = JOrdinary(cov, idx=idx, obs=obs, error_cov=err)
    assert _rel(ours[0], OK.solve()) <= FIELD_TOL
    assert _rel(ours[2], OK.constraint_mask()) <= FIELD_TOL
    # the outputs live on the eight grid slots
    assert _slot_shapes(ours[0]) == {(16,)} and len(ours[0].parts) == 8


def test_ensemble_step_2d_mesh(rng):
    cov, idx, obs, err = _problem(rng)
    jmesh, mesh = _meshes(4, 2)
    key = jax.random.key(0)
    ref = jpar.ensemble_kriging_step(jmesh, key, cov, err, idx, obs,
                                     n_members=8)
    ours = tpar.ensemble_kriging_step(
        mesh, cov, err, idx, obs, n_members=8,
        noise=_ensemble_noise(key, 128, idx.size, 8))
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= FIELD_TOL
    members = ours[0]
    assert members.shape == (8, 128) and members.blocks == (2, 4)
    assert _slot_shapes(members) == {(4, 32)}

    # statistical sanity: the ensemble mean approaches the kriged field
    _, mesh1 = _meshes(8, 1)
    gen = torch.Generator().manual_seed(1)
    many, field2, _ = tpar.ensemble_kriging_step(
        mesh1, cov, err, idx, obs, n_members=512, generator=gen)
    np.testing.assert_allclose(np.asarray(field2), np.asarray(ours[1]),
                               rtol=1e-12)
    spread = np.abs(np.asarray(many).mean(0) - np.asarray(ours[1]))
    assert spread.mean() < 0.2
    err_at_obs = np.abs(np.asarray(many)[:, idx].mean(0)
                        - np.asarray(ours[1])[idx])
    assert err_at_obs.mean() < 0.2


def test_ensemble_step_non_divisible_grid(rng):
    cov, idx, obs, err = _problem(rng, m=130, n_obs=9)  # 130 % 8 != 0
    jmesh, mesh = _meshes(4, 2)
    key = jax.random.key(3)
    ref = jpar.ensemble_kriging_step(jmesh, key, cov, err, idx, obs,
                                     n_members=4)
    ours = tpar.ensemble_kriging_step(
        mesh, cov, err, idx, obs, n_members=4,
        noise=_ensemble_noise(key, 130, idx.size, 4))
    assert ours[0].shape == (4, 130) and ours[1].shape == (130,)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= FIELD_TOL
    OK = JOrdinary(cov, idx=idx, obs=obs, error_cov=err)
    assert _rel(ours[1], OK.solve()) <= FIELD_TOL
    assert np.isfinite(np.asarray(ours[0])).all()


def test_dryrun_on_eight_slots():
    """The counterpart of ``__graft_entry__.dryrun_multichip(8)`` (the
    JAX test runs it): an f32 ensemble step on a 4 x 2 mesh whose members
    hold (4, M / 4) per slot, then the blocked Cholesky and triangular
    solve at 128 on eight grid slots, against the JAX step (f32: 1e-4 of
    the scale) and numpy."""
    m, n_obs = 64, 6
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, size=(m, 2))
    d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    cov = np.exp(-d / 0.3).astype(np.float32) + 1e-4 * np.eye(
        m, dtype=np.float32)
    idx = np.sort(rng.choice(m, size=n_obs, replace=False)).astype(np.int32)
    obs = rng.normal(size=n_obs).astype(np.float32)
    err = (0.05 * np.eye(n_obs)).astype(np.float32)
    jmesh, mesh = _meshes(4, 2)
    key = jax.random.key(0)
    ref = jpar.ensemble_kriging_step(jmesh, key, cov, err, idx, obs,
                                     n_members=8)
    ours = tpar.ensemble_kriging_step(
        mesh, cov, err, idx, obs, n_members=8,
        noise=_ensemble_noise(key, m, n_obs, 8, np.float32))
    assert _slot_shapes(ours[0]) == {(4, m // 4)}
    for o, r in zip(ours, ref):
        assert np.isfinite(np.asarray(o)).all()
        assert _rel(o, r) <= 1e-4

    _, mesh1 = _meshes(8, 1)
    n = 128
    B = rng.normal(size=(n, n))
    spd = (B @ B.T + n * np.eye(n)).astype(np.float32)
    L = tpar.sharded_cholesky(mesh1, spd, n_blocks=16)
    ref_L = np.linalg.cholesky(spd.astype(np.float64))
    np.testing.assert_allclose(np.asarray(L), ref_L, rtol=1e-3, atol=1e-3)
    rhs = rng.normal(size=(n, 3)).astype(np.float32)
    X = tpar.sharded_triangular_solve(mesh1, L, rhs, n_blocks=16).numpy()
    np.testing.assert_allclose(X, np.linalg.solve(ref_L, rhs), rtol=1e-3,
                               atol=1e-3)


def test_sharded_kernel_kriging_matches_single(rng):
    lat = np.arange(-82.5, 90, 15.0)  # 12
    lon = np.arange(-172.5, 180, 22.5)  # 16
    glat, glon = np.repeat(lat, 16), np.tile(lon, 12)
    m = glat.size  # 192
    idx = np.sort(rng.choice(m, 15, replace=False))
    obs = rng.normal(size=15)
    err = np.diag(0.1 + 0.05 * rng.random(15))
    jmesh, mesh = _meshes(8, 1)
    ref = jpar.sharded_kriging_from_kernel(
        jmesh, jkk.variogram_kernel(JMatern(psill=1.2, nugget=0.0,
                                            range=2500.0, nu=1.5)),
        glat, glon, idx, obs, err, variance=1.2)
    kernel = variogram_kernel(MaternVariogram(psill=1.2, nugget=0.0,
                                              range=2500.0, nu=1.5))
    ours = tpar.sharded_kriging_from_kernel(
        mesh, kernel, glat, glon, idx, obs, err, variance=1.2)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= FIELD_TOL
    single = kriging_from_kernel(kernel, glat, glon, idx, obs, err,
                                 variance=1.2, n_blocks=4, device="cpu")
    assert _rel(ours[0], single.field) <= FIELD_TOL
    assert _rel(np.sqrt(np.clip(np.asarray(ours[1]), 0, None)),
                single.uncertainty) <= FIELD_TOL
    assert _slot_shapes(ours[0]) == {(24,)} and len(ours[0].parts) == 8
    with pytest.raises(ValueError, match="divisible"):
        tpar.sharded_kriging_from_kernel(mesh, kernel, glat[:100],
                                         glon[:100], idx, obs, err)


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------
def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def test_sharded_cholesky_matches_numpy(rng):
    n = 256
    spd = _spd(rng, n)
    jmesh, mesh = _meshes(8, 1)
    L = tpar.sharded_cholesky(mesh, spd, n_blocks=16)
    assert _rel(L, jpar.sharded_cholesky(jmesh, spd, n_blocks=16)) \
        <= LINALG_TOL
    assert _rel(L, np.linalg.cholesky(spd)) <= LINALG_TOL
    assert np.abs(np.triu(np.asarray(L), 1)).max() == 0.0
    # each slot holds its (n / 8, n) rows; the input is left as it was
    assert _slot_shapes(L) == {(32, n)}
    spd_t = torch.from_numpy(spd.copy())
    tpar.sharded_cholesky(mesh, spd_t)
    np.testing.assert_array_equal(spd_t.numpy(), spd)


def test_sharded_cholesky_block_count_validation():
    _, mesh = _meshes(8, 1)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_cholesky(mesh, np.eye(100), n_blocks=7)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_cholesky(mesh, np.eye(96), n_blocks=12)


def test_sharded_triangular_solve_matches_lapack(rng):
    n, k = 192, 5
    spd = _spd(rng, n)
    jmesh, mesh = _meshes(8, 1)
    L = tpar.sharded_cholesky(mesh, spd, n_blocks=24)
    jL = jpar.sharded_cholesky(jmesh, spd, n_blocks=24)
    B = rng.normal(size=(n, k))
    X = tpar.sharded_triangular_solve(mesh, L, B, n_blocks=24)
    assert _rel(X, jpar.sharded_triangular_solve(jmesh, jL, B, n_blocks=24)) \
        <= LINALG_TOL
    assert _rel(X, np.linalg.solve(np.asarray(L), B)) <= LINALG_TOL
    b = rng.normal(size=n)
    x = tpar.sharded_triangular_solve(mesh, L, b, n_blocks=24)
    assert tuple(x.shape) == (n,)
    y = np.linalg.solve(np.asarray(L).T, x.numpy())
    np.testing.assert_allclose(spd @ y, b, rtol=1e-6, atol=1e-8)


def test_sharded_whiten_and_mvn_logpdf(rng):
    from scipy.stats import multivariate_normal

    n, b = 256, 5
    M = rng.normal(size=(n, n))
    C = M @ M.T / n + np.eye(n)
    mean = rng.normal(size=n)
    X = rng.normal(size=(n, b))
    jmesh, mesh = _meshes(8, 1)
    L = tpar.sharded_cholesky(mesh, C)
    jL = jpar.sharded_cholesky(jmesh, jnp.asarray(C))

    z = tpar.sharded_whiten(mesh, L, X)
    assert _rel(z, jpar.sharded_whiten(jmesh, jL, jnp.asarray(X))) \
        <= LINALG_TOL
    assert _rel(z, np.linalg.solve(np.linalg.cholesky(C), X)) <= LINALG_TOL

    got = tpar.sharded_mvn_logpdf(mesh, L, X, mean=mean)
    ref = jpar.sharded_mvn_logpdf(jmesh, jL, jnp.asarray(X),
                                  mean=jnp.asarray(mean))
    assert _rel(got, ref) <= LINALG_TOL
    assert _rel(got, multivariate_normal(mean=mean, cov=C).logpdf(X.T)) \
        <= LINALG_TOL
    one = tpar.sharded_mvn_logpdf(mesh, L, X[:, 0])
    assert one.dim() == 0
    want = multivariate_normal(mean=np.zeros(n), cov=C).logpdf(X[:, 0])
    assert abs(float(one) - want) <= LINALG_TOL * abs(want)


# ---------------------------------------------------------------------------
# The ellipse covariance: assembly, draws, stream operator, clip
# ---------------------------------------------------------------------------
def _ellipse_fields(rng, n, Lx=(900, 2000), Ly=(500, 900), sort=False,
                    dtype=np.float64):
    lats = rng.uniform(-60, 60, n)
    if sort:
        lats = np.sort(lats)
    out = (rng.uniform(*Lx, n), rng.uniform(*Ly, n),
           rng.uniform(-np.pi, np.pi, n), rng.uniform(0.6, 1.4, n), lats,
           rng.uniform(-180, 180, n))
    return tuple(a.astype(dtype) for a in out)


def _jax_dense(Lx, Ly, th, sd, lats, lons, v, max_dist=None):
    """The reference's jnp tile over every pair, + diag(stdev^2), f64."""
    f64 = [jnp.asarray(np.asarray(a, np.float64))
           for a in (Lx, Ly, th, sd, lats, lons)]
    s00, s01, _, s11 = jsigma(*f64[:3])
    sig = jnp.stack([s00, s01, s11], -1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    la, lo = jnp.radians(f64[4]), jnp.radians(f64[5])
    C = np.asarray(jblock(la, lo, sig, sqd, f64[3], la, lo, sig, sqd, f64[3],
                          v=v, max_dist=0.0 if max_dist is None
                          else max_dist, use_max_dist=max_dist is not None))
    return C + np.diag(np.asarray(sd, np.float64) ** 2)


def test_sharded_ellipse_covariance_and_draws(rng):
    n = 128
    Lx, Ly, th, sd, lats, lons = _ellipse_fields(rng, n)
    jmesh, mesh = _meshes(8, 1)
    cov = tpar.sharded_ellipse_covariance(mesh, Lx, Ly, th, sd, lats, lons,
                                          v=0.5)
    ref = jpar.sharded_ellipse_covariance(jmesh, Lx, Ly, th, sd, lats, lons,
                                          v=0.5)
    assert _rel(cov, ref) <= FIELD_TOL
    assert _slot_shapes(cov) == {(16, n)} and len(cov.parts) == 8
    # at a kernel order with a cutoff too
    banded = tpar.sharded_ellipse_covariance(
        mesh, Lx, Ly, th, sd, lats, lons, v=1.5, max_dist=3000.0)
    assert _rel(banded, _jax_dense(Lx, Ly, th, sd, lats, lons, 1.5,
                                   3000.0)) <= FIELD_TOL

    # the PSD repair, the sharded factor and draws from it
    from glomargridding_tpu.ops.covariance_tools import eigenvalue_clip

    spd = np.asarray(eigenvalue_clip(np.asarray(ref),
                                     target_variance_fraction=0.95))
    L = tpar.sharded_cholesky(mesh, spd, n_blocks=16)
    assert _rel(L, np.linalg.cholesky(spd)) <= LINALG_TOL
    key = jax.random.key(0)
    jL = jpar.sharded_cholesky(jmesh, spd, n_blocks=16)
    jdraws = jpar.sharded_state_draws(jmesh, key, jL, 2000)
    z = np.asarray(jax.random.normal(key, (n, 2000), jnp.float64))
    draws = tpar.sharded_state_draws(mesh, L, 2000, noise=z.T)
    assert draws.shape == (2000, n) and draws.blocks == (1, 8)
    assert _slot_shapes(draws) == {(2000, 16)}
    assert _rel(draws, jdraws) <= FIELD_TOL
    gen = torch.Generator().manual_seed(0)
    many = np.asarray(tpar.sharded_state_draws(mesh, L, 20_000,
                                               generator=gen))
    assert np.abs(np.cov(many.T) - spd).max() < 0.15


def _stream_inputs(seed, n, Lx=(800, 2000), Ly=(500, 1200), sort=False):
    rng = np.random.default_rng(seed)
    lats = rng.uniform(-60, 60, n).astype(np.float32)
    if sort:
        lats = np.sort(lats)
    lons = rng.uniform(-180, 180, n).astype(np.float32)
    Lx = rng.uniform(*Lx, n).astype(np.float32)
    Ly = rng.uniform(*Ly, n).astype(np.float32)
    th = rng.uniform(-1, 1, n).astype(np.float32)
    sd = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return (Lx, Ly, th, sd, lats, lons), rng


def test_sharded_stream_operator_parity():
    """The ring-SUMMA matvec against the dense product of the same
    covariance (the JAX test's bound), and against the JAX sharded
    operator on the same x."""
    fields, rng = _stream_inputs(11, 256)
    jmesh, mesh = _meshes(8, 1)
    mv, n_op, trace = tpar.sharded_ellipse_stream_operator(mesh, *fields,
                                                           v=1.5)
    jmv, _, jtrace = jpar.sharded_ellipse_stream_operator(jmesh, *fields,
                                                          v=1.5)
    assert n_op == 256 and isinstance(mv, Matvec)
    dense = _jax_dense(*fields, 1.5)
    for k in (7, 20):  # K3 (<= 8 columns) and the wide K4 + GEMM path
        X = rng.standard_normal((256, k)).astype(np.float32)
        out = mv(torch.from_numpy(X))
        assert out.device.type == "cpu" and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), dense @ X, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(jmv(X)),
                                   rtol=2e-4, atol=2e-5)
    v1 = mv(torch.from_numpy(X[:, 0]))
    assert tuple(v1.shape) == (256,)
    np.testing.assert_allclose(v1.numpy(), dense @ X[:, 0], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(trace, float(np.trace(dense)), rtol=1e-5)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-6)
    # the reference memoises its jitted fn per configuration; the port
    # has nothing to compile, and a re-created operator plans the same
    mv2, _, _ = tpar.sharded_ellipse_stream_operator(mesh, *fields, v=1.5)
    assert mv2.band_stats == mv.band_stats


@pytest.mark.parametrize("k", [3, 8, 24])
def test_sharded_stream_banded_pairs(k):
    """With a cutoff on latitude-sorted points, pairs of shards farther
    apart than the cutoff are skipped and the rest banded (K3 over the
    two shards' points with x zero on the row shard's), and the product
    still equals the dense banded one and the JAX operator's."""
    fields, rng = _stream_inputs(5, 512, sort=True)
    jmesh = jpar.make_mesh(n_grid=4, n_ens=1, devices=jax.devices()[:4])
    mesh = tpar.make_mesh(n_grid=4, n_ens=1, devices=["cpu"] * 4)
    mv, _, _ = tpar.sharded_ellipse_stream_operator(mesh, *fields, v=1.5,
                                                    max_dist=2000.0)
    assert mv.band_stats["pairs"] < 16  # far shards are skipped
    X = rng.standard_normal((512, k)).astype(np.float32)
    dense = _jax_dense(*fields, 1.5, 2000.0)
    np.testing.assert_allclose(mv(torch.from_numpy(X)).numpy(), dense @ X,
                               rtol=2e-4, atol=2e-5)
    jmv, _, _ = jpar.sharded_ellipse_stream_operator(
        jmesh, *fields, v=1.5, max_dist=2000.0)
    np.testing.assert_allclose(mv(torch.from_numpy(X)).numpy(),
                               np.asarray(jmv(X)), rtol=2e-4, atol=2e-5)


def test_sharded_stream_clip_matches_dense_clip():
    """The explained-variance clip on the sharded stream operator, its
    blocks row-sharded over eight slots, in f64 as the reference's runs
    under the tests' x64 (its ``dtype=None`` is JAX's default float, f64
    here; the port's is torch's default, f32, for a callable), from the
    reference's start blocks: it gives the JAX sharded clip on its
    8-device mesh and the single-device stream's clip (1e-6, densified),
    and meets the full dense clip within the JAX test's bound."""
    fields, _ = _stream_inputs(12, 256, Lx=(1500, 3000), Ly=(900, 1800))
    jmesh, mesh = _meshes(8, 1)
    mv, n_op, trace = tpar.sharded_ellipse_stream_operator(mesh, *fields,
                                                           v=1.5)
    kw = dict(n=n_op, trace=trace, target_variance_fraction=0.90, k0=32,
              max_rank=256, n_iter=6)
    Lx, Ly, th, sd, lats, lons = (torch.from_numpy(a) for a in fields)
    single, _, _ = ellipse_covariance_operator(
        *_ellipse_inputs(Lx, Ly, th, sd, torch.deg2rad(lats),
                         torch.deg2rad(lons)),
        v=1.5, store="stream", device="cpu")
    psd, theirs = (
        explained_variance_clip_lowrank(
            op, draw=reference_draws(jax.random.key(2)), device="cpu",
            dtype=torch.float64, **kw)
        for op in (mv, single))
    got = psd.to_dense().double().numpy()
    assert _rel(got, theirs.to_dense()) <= 1e-6
    jmv, _, _ = jpar.sharded_ellipse_stream_operator(jmesh, *fields, v=1.5)
    jpsd = jclip(jmv, key=jax.random.key(2), **kw)
    assert _rel(got, jpsd.to_dense()) <= 1e-6

    dense = _jax_dense(*fields, 1.5)
    want = np.asarray(jclip_dense(dense, 0.90, spectrum="full"))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-4
    np.testing.assert_allclose(float(psd.trace()), float(np.trace(dense)),
                               rtol=1e-5)


def test_clip_on_row_sharded_store(rng):
    """The randomized clip on a row-sharded dense store (a matvec over
    the slots' row blocks) against the reference's clip of the same
    store, sharded on its mesh: the clipped matrices agree."""
    n, r = 256, 12
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([np.linspace(30.0, 5.0, r), np.full(n - r, 0.1)])
    cov = (Q * w[None, :]) @ Q.T
    cov = ((cov + cov.T) / 2).astype(np.float32)
    jmesh, mesh = _meshes(8, 1)
    from glomargridding_tpu.ops.sampling import dense_matvec
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = jax.random.key(0)
    ref = jclip(dense_matvec(jax.device_put(
        jnp.asarray(cov), NamedSharding(jmesh, P("grid", None)))),
        n=n, trace=float(np.trace(cov)), target_variance_fraction=0.9,
        k0=16, key=key)
    store = tmesh.Sharded(tmesh.shard_rows(cov, mesh.axis_devices("grid")))

    def rows_matvec(X):
        return torch.cat([p @ X for p in store.parts])

    psd = explained_variance_clip_lowrank(
        rows_matvec, n=n, trace=float(np.trace(cov)),
        target_variance_fraction=0.9, k0=16, draw=reference_draws(key),
        device="cpu")
    assert psd.rank == ref.rank
    np.testing.assert_allclose(psd.gains.numpy(), np.asarray(ref.gains),
                               rtol=1e-4,
                               atol=1e-3 * float(np.asarray(ref.gains).max()))
    np.testing.assert_allclose(psd.to_dense().numpy(),
                               np.asarray(ref.to_dense()), atol=1e-3)


# ---------------------------------------------------------------------------
# The factored (low-rank) path
# ---------------------------------------------------------------------------
def _lowrank_noise(key, n, r, m, n_members):
    k_state, k_obs = jax.random.split(key)
    k1, k2 = jax.random.split(k_state)
    return tuple(np.asarray(jax.random.normal(k, s, jnp.float32))
                 for k, s in ((k1, (n, n_members)), (k2, (r, n_members)),
                              (k_obs, (m, n_members))))


def test_sharded_lowrank_matches_single_device(rng):
    n, r, m = 256, 16, 24
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    V = Q[:, :r].astype(np.float32)
    g = np.sort(rng.uniform(0.5, 4.0, r))[::-1].astype(np.float32)
    f = rng.uniform(0.05, 0.3, n).astype(np.float32)
    psd = LowRankPSD(torch.from_numpy(V), torch.from_numpy(g.copy()),
                     torch.from_numpy(f))
    jpsd = JLowRankPSD(vectors=jnp.asarray(V), gains=jnp.asarray(g),
                       floor=jnp.asarray(f))
    idx = np.sort(rng.choice(n, size=m, replace=False))
    y = rng.normal(size=m).astype(np.float32)
    E = (0.05 * np.eye(m)).astype(np.float32)
    jmesh, mesh = _meshes(4, 2)

    res = tpar.sharded_lowrank_kriging(mesh, psd, idx, y, E)
    ref = jpar.sharded_lowrank_kriging(jmesh, jpsd, idx, y, E)
    local = lowrank_kriging(psd, idx, y, E)
    np.testing.assert_allclose(np.asarray(res.field), np.asarray(ref.field),
                               atol=1e-5)
    for name, atol in (("uncertainty", 1e-4), ("constraint_mask", 1e-4)):
        np.testing.assert_allclose(np.asarray(getattr(res, name)),
                                   np.asarray(getattr(ref, name)), atol=atol)
    for o, want in zip(res, local):
        np.testing.assert_allclose(np.asarray(o), want.numpy(), atol=1e-5)

    key = jax.random.key(11)
    noise = _lowrank_noise(key, n, r, m, 8)
    res2, members = tpar.sharded_lowrank_ensemble_step(
        mesh, psd, idx, y, E, n_members=8, noise=noise)
    _, jmembers = jpar.sharded_lowrank_ensemble_step(jmesh, jpsd, idx, y, E,
                                                     key, n_members=8)
    _, lmembers = lowrank_ensemble_step(psd, idx, y, E, n_members=8,
                                        noise=noise)
    np.testing.assert_allclose(np.asarray(members), np.asarray(jmembers),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(members), lmembers.numpy(),
                               atol=1e-5)
    # members live over (ens, grid), the fields over grid
    assert _slot_shapes(members) == {(4, 64)}
    assert _slot_shapes(res2.field) == {(64,)}


# ---------------------------------------------------------------------------
# The whole-grid ellipse fit over the slots
# ---------------------------------------------------------------------------
ISO_MODEL = dict(anisotropic=False, rotated=False, physical_distance=True,
                 v=0.5, unit_sigma=True)
ISO_FIT = dict(
    default_value=[-999.0] * JModel(**ISO_MODEL).supercategory_n_params,
    bounds=[(100.0, 20000.0)],
    guesses=[500.0],
    max_distance=8000.0,
    delta_x_method="Modified_Met_Office",
)


def _builders(rng, size, n):
    """The JAX test's synthetic cube (``test_ellipse._synthetic_builder``)
    for both packages."""
    lats = np.linspace(-21.0, 21.0, size[0]).astype(np.float32)
    lons = np.linspace(0.0, 27.0, size[1]).astype(np.float32)
    cov = _initialise_covariance(Lx=1500.0, Ly=1500.0, theta=0.0, stdev=1.0,
                                 v=0.5, size=size)
    data = rng.multivariate_normal(np.zeros(cov.shape[0]), cov,
                                   size=n).reshape((n, *size))
    coords = {"time": np.arange(n), "latitude": lats, "longitude": lons}
    jm = JModel(**ISO_MODEL)
    return (JBuilder(data, JCoordinates(coords)), jm,
            EllipseBuilder(data, coords, device="cpu"),
            convert.ellipse_model_from_params(vars(jm)))


def test_sharded_compute_params_matches_single(rng):
    """Lane for lane: the sharded port fit equals the unsharded port fit
    (the batched optimiser freezes each lane once it converges), and
    meets the JAX sharded fit to the JAX test's bounds."""
    jb, jm, tb, tm = _builders(rng, (8, 10), 1500)
    kw = dict(chunk_size=16, estimate_SE="hessian", **ISO_FIT)
    single = tb.compute_params(matern_ellipse=tm, **kw)
    jmesh, mesh = _meshes(8, 1)
    ours = tb.compute_params(matern_ellipse=tm, mesh=mesh, **kw)
    for name in ("R", "R_se", "qc_code", "number_of_iterations"):
        np.testing.assert_array_equal(ours[name].values,
                                      single[name].values, err_msg=name)
    ref = jb.compute_params(matern_ellipse=jm, mesh=jmesh, **kw)
    np.testing.assert_array_equal(ours["qc_code"].values,
                                  ref["qc_code"].values)
    np.testing.assert_allclose(ours["R"].values, ref["R"].values, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ours["R_se"].values, ref["R_se"].values,
                               rtol=1e-5, atol=1e-8)


def test_sharded_compute_params_rounds_chunk(rng):
    _, _, tb, tm = _builders(rng, (4, 6), 600)
    _, mesh = _meshes(8, 1)
    with pytest.warns(UserWarning, match="sharded"):
        params = tb.compute_params(matern_ellipse=tm, chunk_size=12,
                                   mesh=mesh, **ISO_FIT)
    # one lane a slot against eight in one batch: the batched products
    # round differently in f32 geometry
    single = tb.compute_params(matern_ellipse=tm, chunk_size=8, **ISO_FIT)
    np.testing.assert_allclose(params["R"].values, single["R"].values,
                               rtol=1e-6)
    assert np.isfinite(params["R"].values).any()


def test_sharded_compute_params_subchunk_grid(rng):
    """18 points in one short chunk, 18 % 8 != 0: the row is padded up to
    the slot count, and the fit and its SEs match the JAX sharded fit."""
    jb, jm, tb, tm = _builders(rng, (3, 6), 600)
    jmesh, mesh = _meshes(8, 1)
    kw = dict(chunk_size=64, estimate_SE="hessian", **ISO_FIT)
    ours = tb.compute_params(matern_ellipse=tm, mesh=mesh, **kw)
    ref = jb.compute_params(matern_ellipse=jm, mesh=jmesh, **kw)
    assert np.isfinite(ours["R"].values).any()
    assert np.isfinite(ours["R_se"].values).any()
    np.testing.assert_allclose(ours["R"].values, ref["R"].values, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ours["R_se"].values, ref["R_se"].values,
                               rtol=1e-5, atol=1e-8)


def test_sharded_fit_with_groups_and_checkpoint(rng, tmp_path):
    _, _, tb, tm = _builders(rng, (8, 10), 1200)
    _, mesh = _meshes(8, 1)
    ckpt = str(tmp_path / "sharded_fit.npz")
    kw = dict(chunk_size=16, dispatch_chunks=2, mesh=mesh, **ISO_FIT)
    p1 = tb.compute_params(matern_ellipse=tm, checkpoint=ckpt, **kw)
    # a completed checkpoint: the rerun reloads without fitting
    p2 = tb.compute_params(matern_ellipse=tm, checkpoint=ckpt, **kw)
    np.testing.assert_array_equal(p1["R"].values, p2["R"].values)
    np.testing.assert_array_equal(p1["qc_code"].values,
                                  p2["qc_code"].values)
    p3 = tb.compute_params(matern_ellipse=tm,
                           **{**kw, "mesh": None, "dispatch_chunks": 1})
    np.testing.assert_array_equal(p1["R"].values, p3["R"].values)


# ---------------------------------------------------------------------------
# What each slot holds
# ---------------------------------------------------------------------------
def test_ensemble_step_per_device_memory_is_o_shard(rng, monkeypatch):
    """Per-slot peak of the ensemble step, counted from its shapes, stays
    O(shard), never O(full matrix), and flat across grid-axis sizes (an
    all-gather of the store would make peak / shard grow linearly with
    the axis). Then a run: every slot holds (M / n_grid)-wide blocks and
    no Cholesky ever factors anything wider than a block or K."""
    ratios = {}
    for n_grid in (2, 4, 8):
        mesh = tpar.make_mesh(n_grid=n_grid, n_ens=1,
                              devices=["cpu"] * n_grid)
        peak, full, stats = ensemble_step_memory_analysis(
            mesh, 2048, 64, n_members=8)
        assert stats is None
        shard = full / n_grid
        assert peak <= 5 * shard, (n_grid, peak, shard)
        ratios[n_grid] = peak / shard
    assert max(ratios.values()) / min(ratios.values()) < 1.2, ratios

    factored = []
    cholesky = torch.linalg.cholesky
    monkeypatch.setattr(torch.linalg, "cholesky",
                        lambda A: factored.append(A.shape[-1]) or cholesky(A))
    cov, idx, obs, err = _problem(rng, m=256, n_obs=12)
    _, mesh = _meshes(4, 2)
    members, field, _ = tpar.ensemble_kriging_step(
        mesh, cov, err, idx, obs, n_members=8,
        generator=torch.Generator().manual_seed(0))
    assert _slot_shapes(members) == {(4, 64)}
    assert _slot_shapes(field) == {(64,)}
    n_blocks, _ = resolve_blocks_padded(256, 4, None)
    assert max(factored) <= max(256 // n_blocks, 12), factored
