"""The clips on the row-sharded stream operator with the eigensolver's
blocks row-sharded over the slots, against the JAX package's clips on its
8-device mesh (whose blocks its mesh shards the same way), in f64.

The port's mesh is eight CPU slots (``make_mesh(devices=["cpu"] * 8)``),
the reference's the 8-device virtual CPU mesh of ``tests/conftest.py``;
the reference's keyed start blocks are replayed as ``draw=``. Densified
factors are compared, so that the Ritz vectors' signs do not matter.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_eigsh import reference_draws
from torch.utils._python_dispatch import TorchDispatchMode

from glomargridding_tpu import parallel as jpar
from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu_torch import parallel as tpar
from glomargridding_tpu_torch.ops import covariance_tools as tct
from glomargridding_tpu_torch.ops import eigsh as teig
from glomargridding_tpu_torch.ops.sampling import Matvec
from glomargridding_tpu_torch.parallel.ellipse import clip_memory_analysis
from glomargridding_tpu_torch.parallel.mesh import Sharded



@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, whatever another test file set: the suite's
    workers share the cores, and wider pools wait on each other."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


# two f64 eigensolves from the same start blocks; also the whole-tensor
# form against the sharded one, whose Gram sums run in another order: the
# Laloux clip's rank-1 head is taken by the structural gate, converged to
# n_iter's sweeps, not to roundoff (4.4e-8 apart; the explained-variance
# clip, taken by the residual gate, 3e-16)
CLIP_TOL = 1e-6
SLOTS = 8
N = 256
CLIP_KW = dict(k0=32, max_rank=256, n_iter=6)


def _fields(seed=12, n=N):
    rng = np.random.default_rng(seed)
    lats = rng.uniform(-60, 60, n).astype(np.float32)
    lons = rng.uniform(-180, 180, n).astype(np.float32)
    Lx = rng.uniform(1500, 3000, n).astype(np.float32)
    Ly = rng.uniform(900, 1800, n).astype(np.float32)
    th = rng.uniform(-1, 1, n).astype(np.float32)
    sd = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return Lx, Ly, th, sd, lats, lons


def _operators(max_dist=None):
    fields = _fields()
    mesh = tpar.make_mesh(n_grid=SLOTS, n_ens=1, devices=["cpu"] * SLOTS)
    mv, n, trace = tpar.sharded_ellipse_stream_operator(
        mesh, *fields, v=1.5, max_dist=max_dist)
    jmv, _, _ = jpar.sharded_ellipse_stream_operator(
        jpar.make_mesh(n_grid=SLOTS, n_ens=1), *fields, v=1.5,
        max_dist=max_dist)
    return mv, jmv, n, trace, fields


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


def _clip(name, mv, n, trace, fields, key, **kw):
    """The port's clip `name` of `mv` in f64 from the reference's key."""
    if name == "explained_variance":
        return tct.explained_variance_clip_lowrank(
            mv, n=n, trace=trace, target_variance_fraction=0.90,
            draw=reference_draws(key), dtype=torch.float64, device="cpu",
            **CLIP_KW, **kw)
    return tct.laloux_clip_lowrank(
        mv, diag=torch.from_numpy(fields[3].astype(np.float64) ** 2), n=n,
        num_time_pts=60, draw=reference_draws(key), dtype=torch.float64,
        device="cpu", **CLIP_KW, **kw)


def _jax_clip(name, jmv, n, trace, fields, key):
    if name == "explained_variance":
        return jct.explained_variance_clip_lowrank(
            jmv, n=n, trace=trace, target_variance_fraction=0.90, key=key,
            **CLIP_KW)
    return jct.laloux_clip_lowrank(
        jmv, diag=fields[3].astype(np.float64) ** 2, n=n, num_time_pts=60,
        key=key, **CLIP_KW)


@pytest.mark.parametrize("name, max_dist", [
    ("explained_variance", 3000.0), ("laloux", None), ("laloux", 3000.0)])
def test_row_sharded_clip_matches_jax_mesh(name, max_dist):
    """Every block the operator sees is row-sharded over the eight slots,
    and the clip meets the reference's on its 8-device mesh. (The
    explained-variance clip without a cutoff is
    ``tests/test_torch_parallel.py::test_sharded_stream_clip_matches_
    dense_clip``.)"""
    mv, jmv, n, trace, fields = _operators(max_dist)
    seen = []

    def counted(x):
        seen.append(x)
        return mv(x)

    op = Matvec(counted, mv.band_stats)
    op.row_devices = mv.row_devices
    key = jax.random.key(2)
    psd = _clip(name, op, n, trace, fields, key)
    ref = _jax_clip(name, jmv, n, trace, fields, key)
    assert _rel(psd.to_dense(), ref.to_dense()) <= CLIP_TOL
    np.testing.assert_allclose(psd.trace(), float(ref.trace()), rtol=1e-8)
    assert seen and all(isinstance(x, Sharded) for x in seen)
    assert {p.shape[0] for x in seen for p in x.parts} == {n // SLOTS}
    assert all(len(x.parts) == SLOTS for x in seen)


@pytest.mark.parametrize("name", ["explained_variance", "laloux"])
def test_row_sharded_clip_equals_whole_block_clip(name):
    """The sharded form and the whole-tensor form (the same operator's
    ``fn``, with no ``row_devices``) give the same clip."""
    mv, _, n, trace, fields = _operators(3000.0)
    key = jax.random.key(5)
    sharded = _clip(name, mv, n, trace, fields, key)
    whole = _clip(name, Matvec(mv.fn), n, trace, fields, key)
    assert sharded.rank == whole.rank
    assert _rel(sharded.to_dense(), whole.to_dense()) <= CLIP_TOL
    # the factors come back gathered on the first slot
    assert isinstance(sharded.vectors, torch.Tensor)
    assert sharded.vectors.shape == whole.vectors.shape


def _assert_row_sharded(X, n):
    """X is eight equal row blocks: each slot holds 1/8 of its bytes."""
    assert isinstance(X, Sharded) and len(X.parts) == SLOTS
    whole = sum(p.numel() * p.element_size() for p in X.parts)
    for p in X.parts:
        assert p.numel() * p.element_size() * SLOTS == whole
        assert p.shape[0] == n // SLOTS


def _recorded_clip(mv, n, trace, fields):
    """(clip, the blocks whose Grams the solve summed, the Grams'
    shapes)."""
    gram_shapes, blocks = [], []
    gram = teig._gram

    def recording_gram(A, B):
        G = gram(A, B)
        gram_shapes.append(tuple(G.shape))
        blocks.extend([A, B])
        return G

    teig._gram = recording_gram
    try:
        psd = _clip("explained_variance", mv, n, trace, fields,
                    jax.random.key(2))
    finally:
        teig._gram = gram
    return psd, blocks, gram_shapes


def test_row_sharded_blocks_per_slot_bytes():
    """Each slot holds 1/8 of every (n, width) block: the blocks of the
    stages, recorded as the solve makes them, and the count from the
    shapes (``clip_memory_analysis``) besides the (width, width) Grams."""
    mv, _, n, trace, fields = _operators(3000.0)
    psd, blocks, gram_shapes = _recorded_clip(mv, n, trace, fields)
    assert psd.rank >= 1 and blocks
    for X in blocks:
        _assert_row_sharded(X, n)
    width = max(s[0] for s in gram_shapes)
    per_slot, whole, small = clip_memory_analysis(n, width, SLOTS,
                                                  dtype=torch.float64)
    assert per_slot * SLOTS == whole
    assert per_slot == 5 * (n // SLOTS) * width * 8
    assert small == 4 * width * width * 8
    # the production shape of the 0.1-degree repair: (6,480,000 x 3,072)
    # f32 blocks, each 80 GB whole and 20 GB on each of four slots
    per_slot, whole, _ = clip_memory_analysis(6_480_000, 3072, 4)
    assert whole == 5 * 6_480_000 * 3072 * 4
    assert per_slot == whole // 4


def _slot_order_draw(seed, slots):
    """The whole-tensor form's ``draw`` of the sharded form's generator
    draws: each block's slots' rows drawn one after another."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, dtype):
        rows = (shape[0] // slots, *shape[1:])
        return torch.cat([torch.randn(rows, dtype=dtype, generator=gen)
                          for _ in range(slots)])

    return draw


def test_row_sharded_clip_from_a_generator():
    """With a generator the sharded form draws each slot's rows on its
    own, in slot order: the same clip as the whole-tensor form fed those
    rows in that order, and from other start blocks than the reference's
    key's, the same clip to the solver's convergence."""
    mv, _, n, trace, fields = _operators()
    kw = dict(n=n, trace=trace, target_variance_fraction=0.90,
              dtype=torch.float64, **CLIP_KW)
    psd = tct.explained_variance_clip_lowrank(
        mv, generator=torch.Generator().manual_seed(3), **kw)
    whole = tct.explained_variance_clip_lowrank(
        Matvec(mv.fn), draw=_slot_order_draw(3, SLOTS), device="cpu", **kw)
    assert _rel(psd.to_dense(), whole.to_dense()) <= CLIP_TOL
    keyed = _clip("explained_variance", mv, n, trace, fields,
                  jax.random.key(2))
    assert _rel(psd.to_dense(), keyed.to_dense()) <= 1e-4
    np.testing.assert_allclose(psd.trace(), trace, rtol=1e-10)


class _Shapes(TorchDispatchMode):
    """The shapes of every tensor an operation makes while it is on."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("rescue", [False, True])
def test_row_sharded_solve_makes_no_whole_block(rescue):
    """Every tensor made during a row-sharded solve from a generator (the
    start blocks, the operator's applications, CholQR2, Rayleigh-Ritz,
    and with `rescue` the Householder path's TSQR) has at most n / 8
    rows, but for the TSQR's stacked R factors: the (n, width) blocks live
    a slot's rows at a time, and the small matrices are narrower than a
    slot's rows here."""
    n = 2048
    fields = _fields(n=n)
    mesh = tpar.make_mesh(n_grid=SLOTS, n_ens=1, devices=["cpu"] * SLOTS)
    mv, _, _ = tpar.sharded_ellipse_stream_operator(mesh, *fields, v=1.5,
                                                    max_dist=3000.0)
    cholqr2 = teig._cholqr2
    with pytest.MonkeyPatch.context() as mp:
        if rescue:  # every CholQR2 fails: the Householder iteration runs
            mp.setattr(teig, "_cholqr2", lambda Y: (
                cholqr2(Y)[0], torch.zeros((), dtype=torch.bool)))
        with _Shapes() as seen:
            w, V, r = teig.adaptive_topk_eigh(
                mv, lambda w: 8, n, k0=32, max_rank=128, n_iter=2,
                generator=torch.Generator().manual_seed(4),
                dtype=torch.float64)
        # the whole-tensor form fed the same rows finds the same subspace
        w2, V2, _ = teig.adaptive_topk_eigh(
            Matvec(mv.fn), lambda w: 8, n, k0=32, max_rank=128, n_iter=2,
            draw=_slot_order_draw(4, SLOTS), dtype=torch.float64,
            device="cpu")
    assert r == 8 and isinstance(V, Sharded)
    # besides the slots' rows, only the TSQR's stacked (8 x 40, 40) R
    # factors and their Q
    big = {s for s in seen.shapes if len(s) == 2 and s[0] > n // SLOTS}
    assert big <= ({(SLOTS * 40, 40)} if rescue else set())
    assert any(s == (n // SLOTS, 40) for s in seen.shapes)
    np.testing.assert_allclose(w[:8], w2[:8], rtol=1e-10)
    Vg = V.gather()[:, :8]
    assert _rel(Vg @ Vg.T, V2[:, :8] @ V2[:, :8].T) <= 1e-8


def test_tsqr_matches_householder_qr():
    """The sharded Householder Q (``_qr_q``'s TSQR) spans the whole
    block's Q's columns one by one (up to sign) and is orthonormal."""
    Y = torch.from_numpy(np.random.default_rng(6).normal(size=(256, 24)))
    Q = teig._qr_q(Sharded(list(Y.split(256 // SLOTS)))).gather()
    ref = teig._qr_q(Y)
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(24), atol=1e-13)
    np.testing.assert_allclose(torch.abs(torch.sum(Q * ref, 0)).numpy(),
                               np.ones(24), atol=1e-12)
