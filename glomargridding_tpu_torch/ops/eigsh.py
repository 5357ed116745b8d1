r"""Randomized partial symmetric eigensolver (top-k Ritz pairs), on tensors.

Port of ``glomargridding_tpu/ops/eigsh.py``. Eigenvalue clipping needs
only the TOP of the spectrum plus the trace, so the dominant k Ritz
pairs come from randomized subspace iteration (Halko, Martinsson & Tropp
2011, alg. 4.4 + Rayleigh-Ritz): ``n_iter + 2`` applications of the
operator to an (n, k+p) block, tall-skinny Cholesky-QRs, and one
``eigh`` of the (k+p, k+p) projection.

The operator can be a dense tensor, a bf16-stored tensor, or any matvec
callable (``ops.sampling.dense_matvec``, the ellipse covariance
operators), so the same code scales to the 1-degree grid where no dense
factorisation or full spectrum is wanted.

Accuracy model: a Ritz pair retained by a clip (rank r << k, block size
l = k + oversample) converges like (lambda_l / lambda_r)^(2 n_iter + 1).
Large-magnitude NEGATIVE eigenvalues, if present, enter the captured
subspace (the iteration converges in |lambda|) but are sorted to the
bottom of the Ritz values and excluded from the returned top-k.

What differs from the reference, and why:

- random start blocks. ``jax.random`` keys become ``generator=`` (a
  ``torch.Generator`` on the operator's device; default: a fresh one
  seeded 0, so results are deterministic by default) or ``draw=``, a
  callable ``(shape, dtype) -> tensor`` of standard normals that is
  called once per stage, in the reference's order (and once more by a
  Householder rescue). Parity tests build ``draw`` from the reference's
  key sequence.
- the Rayleigh-Ritz ``eigh`` runs on the operator's device in float64
  (the reference fetches the projection and calls host LAPACK, because
  its accelerator's ``eigh`` is Jacobi); the Ritz values go to the host,
  where ``accept``/``predict`` are plain functions of a small vector, and
  the rotation stays on the device.
- CholQR validity is ``torch.linalg.cholesky_ex``'s ``info`` combined
  with a finiteness probe, kept on the device; each acceptance round
  reads it once, then reads the Ritz values (two small syncs per round).
- the reference's fused stage programs (``_fused_stage_fns``, one jitted
  dispatch per stage for a remote backend) are left out: they compute
  exactly what the unfused ``run_stage`` computes, which is what this
  module keeps.

Every product here feeds a Cholesky or a cancellation: true f32, never
TF32 (the port never changes ``torch.get_float32_matmul_precision()``).

Row-sharded blocks: an operator with a ``row_devices`` attribute (the
slots of ``parallel.sharded_ellipse_stream_operator``) takes and returns
``parallel.mesh.Sharded`` (n, k) row blocks, and then every (n, width)
block of the solve is one: each slot holds its rows. The Gram matrices
of CholQR2 and of the Rayleigh-Ritz projection are summed over the slots
(``parallel.mesh.psum``), the small Cholesky and the f64 ``eigh`` run on
the first slot, and R^-1 and the Ritz rotation are applied per slot.
Each slot's rows of a start block are drawn one slot after another and
moved to their slot (``_normal``), and the Householder rescue is a TSQR
(``_qr_q``): no slot holds a whole (n, width) block.
"""

import logging
from typing import Callable

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .sampling import dense_matvec

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Blocks: an (n, k) tensor, or a row-sharded ``parallel.mesh.Sharded``
# ---------------------------------------------------------------------------
def _sharded(X) -> bool:
    return not isinstance(X, torch.Tensor)


def _map(fn, *blocks):
    """fn over the blocks, slot by slot when they are row-sharded."""
    if not _sharded(blocks[0]):
        return fn(*blocks)
    from ..parallel.mesh import Sharded

    return Sharded([fn(*parts) for parts in zip(*(b.parts for b in blocks))])


def _rmul(X, M):
    """X @ M for a small (k, l) M, on each slot for a sharded X."""
    return _map(lambda x: x @ M.to(x.device), X)


def _slot_sum(parts):
    """The per-slot values summed over the slots, on the first slot."""
    from ..parallel.mesh import psum

    return psum(parts, [p.device for p in parts])[0]


def _gram(A, B):
    """A' B, summed over the slots for sharded blocks."""
    if not _sharded(A):
        return A.T @ B
    return _slot_sum([a.T @ b for a, b in zip(A.parts, B.parts)])


def _colsq(X):
    """Column sums of squares, summed over the slots."""
    if not _sharded(X):
        return torch.sum(X * X, dim=0)
    return _slot_sum([torch.sum(x * x, dim=0) for x in X.parts])


def _cols(X, start=None, stop=None):
    return _map(lambda x: x[:, start:stop], X)


def _cat_cols(blocks):
    if not _sharded(blocks[0]):
        return torch.cat(blocks, dim=1)
    from ..parallel.mesh import Sharded

    return Sharded([torch.cat(parts, dim=1)
                    for parts in zip(*(b.parts for b in blocks))])


def _shard_like(X, devices):
    """A whole tensor as equal row blocks on `devices` (each its own)."""
    from ..parallel.mesh import Sharded, shard_rows

    return Sharded(shard_rows(X, devices, copy=True))


def _qr_q(Y):
    """The Q of a Householder QR. A sharded block's is a TSQR: each
    slot's rows reduced on their slot, the stacked R factors (slots x
    width, width) reduced on the first slot, and their Q applied to each
    slot's; its columns may differ from the whole block's Q in sign."""
    if not _sharded(Y):
        return torch.linalg.qr(Y)[0]
    from ..parallel.mesh import Sharded

    local = [torch.linalg.qr(p) for p in Y.parts]
    first = Y.parts[0].device
    Q2 = torch.linalg.qr(torch.cat([r.to(first) for _, r in local]))[0]
    parts, k0 = [], 0
    for q, r in local:
        k1 = k0 + r.shape[0]
        parts.append(q @ Q2[k0:k1].to(q.device))
        k0 = k1
    return Sharded(parts)


class PartialSpectrumError(ValueError):
    """The adaptive partial-spectrum solve hit max_rank without
    converging (spectrum too flat for a low-rank clip)."""


def _cholqr_once(Y):
    """One Cholesky-QR pass: Q = Y R^{-1} with R = chol(Y'Y)'.

    Returns (Q, ok): ok is a DEVICE bool, False when Y'Y is numerically
    singular or overflowed and the caller must fall back.
    """
    G = _gram(Y, Y)
    # small diagonal lift: keeps chol alive when Y is nearly rank-
    # deficient; the second pass removes the resulting non-orthogonality
    eps = 1e-6 if Y.dtype == torch.float32 else 1e-12
    G.diagonal().add_(eps * torch.trace(G) / G.shape[0])
    L, info = torch.linalg.cholesky_ex(G)
    # Invert the SMALL (l, l) factor and apply it as a matmul. Any
    # inverse roundoff lands in Q's non-orthogonality, which the second
    # CholQR pass removes (that is what the "2" in CholQR2 is for).
    eye = torch.eye(L.shape[0], dtype=Y.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Q = _rmul(Y, Linv.T)
    ok = (info == 0) & torch.isfinite(L[-1, -1])
    return Q, ok


def _cholqr2(Y):
    """CholQR2 orthonormal basis of range(Y) + a DEVICE validity flag.

    Two Cholesky-QR passes give orthogonality to ~machine precision for
    condition numbers up to ~1/sqrt(eps) (Yamamoto et al. 2015), ample
    for subspace iteration, where Y is a covariance image of a random
    block. The flag stays on the device: callers combine flags across
    all passes of a stage and read them once.
    """
    with span("eigsh.cholqr"):
        Q, ok1 = _cholqr_once(Y)
        Q, ok2 = _cholqr_once(Q)
        return Q, ok1 & ok2


def _as_matvec(operator, n: int | None, device=None):
    """Normalise (dense | callable) to (matvec, n, tensor or None).

    A dense operator becomes an ``ops.sampling.dense_matvec`` on `device`
    (``resolve_device``: a tensor keeps its device, a numpy matrix goes
    to the card); the product accumulates in the matrix dtype (f32 for a
    bf16 store).
    """
    if callable(operator):
        if n is None:
            raise ValueError("n is required for a callable operator")
        return operator, n, None
    A = torch.as_tensor(operator, device=resolve_device(device, operator))
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"operator must be square, got {tuple(A.shape)}")
    if n is not None and n != A.shape[0]:
        raise ValueError(
            f"n={n} does not match operator shape {tuple(A.shape)}")
    return dense_matvec(A), int(A.shape[0]), A


def _setup(operator, n, device, dtype, generator, draw):
    """(matvec, n, dtype, device, normal, gen) of a solve: `normal(shape)`
    gives the next standard-normal block on the solve's device (row-
    sharded like the operator's blocks, ``_normal``), from `draw` or from
    the generator `gen` (None when `draw` is given)."""
    if device is None and generator is not None and not isinstance(
            operator, torch.Tensor):
        device = generator.device
    matvec, n, A = _as_matvec(operator, n, device)
    slots = getattr(matvec, "row_devices", None)
    if A is not None:
        device = A.device
        if dtype is None:
            dtype = (torch.float32 if A.dtype == torch.bfloat16
                     else A.dtype)
    else:
        device = resolve_device(slots[0] if slots is not None else device)
        if dtype is None:
            dtype = torch.get_default_dtype()
    gen = None
    if draw is None:
        gen = generator
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
    normal = _normal(draw, gen, dtype, device, slots)
    return matvec, n, dtype, device, normal, gen


def _normal(draw, gen, dtype, device, slots):
    """``normal(shape)``: the next standard-normal block, from `draw` or
    `gen`. For a row-sharded operator (`slots`) the block is a
    ``Sharded`` of equal row blocks, made a slot at a time: from `gen`,
    each slot's rows drawn in slot order (on the generator's device, then
    moved to the slot), so the values are those of the whole-tensor form
    only when its draw is the same sequence of row blocks; from `draw`,
    the block drawn where `draw` returns it (the host for numpy) and
    split over the slots."""
    def whole(shape):
        if draw is not None:
            return torch.as_tensor(draw(shape, dtype), device=device).to(
                dtype)
        return torch.randn(shape, dtype=dtype, device=device, generator=gen)

    if slots is None:
        return whole
    from ..parallel.mesh import Sharded, shard_rows

    def sharded(shape):
        if draw is not None:
            host = torch.as_tensor(draw(shape, dtype)).to(dtype)
            return Sharded(shard_rows(host, slots, copy=True))
        if shape[0] % len(slots):
            raise ValueError(f"N={shape[0]} must be divisible by "
                             f"{len(slots)} slots")
        rows = (shape[0] // len(slots), *shape[1:])
        return Sharded([torch.randn(rows, dtype=dtype, device=device,
                                    generator=gen).to(slot)
                        for slot in slots])

    return sharded


def _apply(matvec, X):
    """The operator's product as a block like X: the one door every
    application of the operator goes through, counted here."""
    count("eigsh.applications")
    count("eigsh.columns", X.shape[-1])
    with span("eigsh.sweep"):
        if _sharded(X):
            return _map(lambda y, x: y.to(x.dtype), matvec(X), X)
        return torch.as_tensor(matvec(X), device=X.device).to(X.dtype)


def _ritz_eigh(T, dtype):
    """Eigenpairs of the symmetric (w, w) projection, DESCENDING: the
    values as a float64 numpy vector on the host, the vectors on T's
    device in `dtype`. Solved in float64 on the device."""
    with span("eigsh.ritz"):
        theta, U = torch.linalg.eigh(T.double())
        return theta.flip(0).cpu().numpy(), U.flip(1).to(dtype)


def _projection(Q, B):
    with span("eigsh.ritz"):
        T = _gram(Q, B)
        return 0.5 * (T + T.T)


def topk_eigh(
    operator,
    k: int,
    n: int | None = None,
    *,
    generator: torch.Generator | None = None,
    draw: Callable | None = None,
    oversample: int = 8,
    n_iter: int = 6,
    dtype=None,
    device=None,
) -> tuple[np.ndarray, torch.Tensor]:
    """Top-k (algebraically largest) eigenpairs of a symmetric operator.

    Parameters
    ----------
    operator : (n, n) array or callable
        Symmetric matrix (tensor or numpy), or a matvec closure mapping
        an (n, b) tensor to ``A @ block``.
    k : int
        Number of eigenpairs to return.
    n : int, optional
        Operator dimension (required for callables).
    generator, draw : optional
        Source of the random test block (module docstring). By default a
        generator seeded 0: the result is deterministic, like LAPACK.
        A Householder rescue restarts from the same block.
    oversample : int
        Extra subspace width p; the k-th pair's accuracy is governed by
        the gap to lambda_{k+p}.
    n_iter : int
        Power (subspace) iterations; each sharpens convergence by
        (lambda_{k+p}/lambda_k)^2.
    dtype : optional
        Dtype of the random block (default: the matrix's, f32 for a bf16
        store; for a callable, torch's default dtype).
    device : optional
        Where the solve runs (``resolve_device``): a tensor operator
        keeps its device; a numpy matrix or a callable goes to the card
        unless a device (or a generator on one) is given.

    Returns
    -------
    (eigvals, eigvecs)
        ``eigvals``: (k,) numpy array, DESCENDING. ``eigvecs``: (n, k)
        tensor of matching Ritz vectors. Orthonormal to roundoff when
        the operator's numerical rank exceeds the iteration width; for
        rank-deficient operators (fast-decaying covariance spectra) f32
        columns are orthonormal only to ~1e-3, and consumers that
        resynthesise matrices from a retained subset must re-normalise
        (the clips in ``ops.covariance_tools`` do).
    """
    matvec, n, dtype, device, normal, gen = _setup(
        operator, n, device, dtype, generator, draw)
    if k < 1:
        raise ValueError("k must be >= 1")
    k = min(k, n)

    width = min(n, k + oversample)
    if width >= n:  # subspace is the whole space: just be exact
        w, V = _exact(matvec, n, dtype, device)
        return w[:k], _cols(V, None, k)

    # The rare rescue restarts from the same block, redrawn: keeping it
    # alive would cost an (n, width) buffer (1.07 GB at 259,200 x 1,032
    # f32) for a path that essentially never runs. A generator is wound
    # back to its state here; a `draw` is simply called again.
    state = None if gen is None else gen.get_state()
    Y = _apply(matvec, normal((n, width)))
    all_ok = torch.ones((), dtype=torch.bool, device=device)
    for _ in range(n_iter):
        Q, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        del Y
        Y = _apply(matvec, Q)
    Q, ok = _cholqr2(Y)
    all_ok = all_ok & ok
    del Y
    B = _apply(matvec, Q)
    if not bool(all_ok):  # pathological input: redo with Householder QR
        if gen is not None:
            gen.set_state(state)
        Q, B = _householder_iterate(matvec, normal((n, width)), n_iter)
    theta, U = _ritz_eigh(_projection(Q, B), dtype)
    return theta[:k], _rmul(Q, U[:, :k])


def _exact(matvec, n, dtype, device):
    """Every eigenpair (descending), from the operator applied to the
    identity, for a subspace as wide as the space; the vectors sharded
    like the operator's blocks."""
    eye = torch.eye(n, dtype=dtype, device=device)
    slots = getattr(matvec, "row_devices", None)
    if slots is None:
        return _ritz_eigh(_apply(matvec, eye), dtype)
    A = _apply(matvec, _shard_like(eye, slots)).gather()
    w, V = _ritz_eigh(A, dtype)
    return w, _shard_like(V, slots)


def _resid_and_vectors(Q, B, U_r, theta_r, mask):
    """(max masked Ritz residual, retained vectors Q U_r). ``mask``
    zeroes the residuals of shape-padding columns beyond the true
    retained rank: they carry zero gain downstream and must not fail the
    acceptance gate."""
    QU = _rmul(Q, U_r)
    R = _map(lambda b, qu: b @ U_r.to(b.device) - qu * theta_r.to(b.device)[
        None, :], B, QU)
    resid = torch.sqrt(_colsq(R))
    return torch.max(resid * mask), QU


def _rotate_ritz(Q, B, U_sorted, theta_sorted):
    """Ritz rotation + per-pair exact residual norms.

    QU = current Ritz vectors (descending eigenvalue order), BU their
    exact action (B = A Q so A QU = BU), rn_j = ||A u_j - theta_j u_j||:
    everything the locking split needs, two (n, w) matmuls total.
    """
    QU = _rmul(Q, U_sorted)
    BU = _rmul(B, U_sorted)
    R = _map(lambda bu, qu: bu - qu * theta_sorted.to(bu.device)[None, :],
             BU, QU)
    rn = (torch.sqrt(_colsq(R)) if _sharded(R)
          else torch.linalg.norm(R, dim=0))
    return QU, BU, rn


def _householder_iterate(matvec, Z, n_iter):
    """Subspace iteration from the start block Z, orthonormalised by
    Householder QR.

    The rescue path for inputs that break Cholesky-QR (Gram-matrix
    overflow: entries beyond sqrt(dtype max)). LAPACK's QR computes
    column norms with scaling, so it survives magnitudes CholQR cannot.
    Returns (Q, B = A @ Q).
    """
    Y = _apply(matvec, Z)
    for _ in range(n_iter):
        Y = _apply(matvec, _qr_q(Y))
    Q = _qr_q(Y)
    return Q, _apply(matvec, Q)


def _deflate(Y, Q):
    """Y - Q (Q' Y): Y with the span of the orthonormal Q removed."""
    G = _gram(Q, Y)
    return _map(lambda y, q: y - q @ G.to(y.device), Y, Q)


def _converged_prefix(rn, scale, tol) -> int:
    """Length of the leading run of Ritz pairs whose residual over
    `scale` is within `tol`."""
    conv = rn.cpu().numpy() / scale <= tol
    return int(np.argmin(conv)) if not conv.all() else len(conv)


def adaptive_topk_eigh(  # noqa: C901
    operator,
    accept: Callable,
    n: int | None = None,
    *,
    k0: int = 64,
    max_rank: int = 2048,
    generator: torch.Generator | None = None,
    draw: Callable | None = None,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    extra_rounds: int = 2,
    rank_multiple: int = 1,
    dtype=None,
    predict: Callable | None = None,
    device=None,
) -> tuple[np.ndarray, torch.Tensor, int]:
    """Adaptive top-of-spectrum solve: find the retained rank a clip
    needs, growing the subspace only as far as the spectrum demands.

    ``accept(w)`` maps the computed DESCENDING Ritz head (numpy) to the
    retained rank r (or None when the head is not yet deep enough). A
    candidate rank is accepted through either of two gates:

    - **residual gate**: every retained pair's exact Ritz residual
      ||A u - theta u|| is <= ``tol * theta_1`` (rigorous eigenvalue
      error bound, measured from quantities the iteration already has).
      This typically accepts at width ~ r + oversample.
    - **structural gate**: ``r <= k // 2`` (effective oversampling
      scales with r itself). Kept as the provable fallback so accuracy
      can never regress even when residuals are noisy.

    When a candidate fails only the residual gate, up to
    ``extra_rounds`` additional power iterations sharpen the SAME block
    (one matvec each) before widening. Widening is WARM-STARTED by RITZ
    LOCKING: the previous stage's Ritz pairs are split by their MEASURED
    residuals, the converged leading prefix is frozen (its basis and
    exact action carried; alignment rounds the lock count DOWN to
    ``rank_multiple`` so no unconverged pair is ever frozen), while the
    remaining pairs re-iterate (warm-started from their current action)
    together with the fresh random columns, deflated against the locked
    basis, so each widening sweep costs only the ACTIVE width. The
    reference locks only from 200,000 points on and below that carries
    the whole block's action and re-iterates it jointly; this port locks
    at every size, because on an NVIDIA H100 80GB HBM3 (700 W;
    ``chip_smoke.py`` phase 19, a clip at target 0.90 widening from 512
    to 1,024) locking won wherever the two were measured: 0.07 s
    against 0.09 s on the 16,200-cell bf16 store, 0.21 s against 0.33 s
    at 64,800 (a sweep is one GEMM), 8.7 s against 11.8 s on the
    259,200-cell stream (a sweep rebuilds every tile), with the same
    stages, sweeps and rank. Acceptance always passes through the
    exact-residual gate, so the two reach the same pairs to the solver's
    tolerance.

    ``tol`` defaults by dtype: 1e-10 for f64, 1e-2 for f32. The f32
    default sits ABOVE the noise of a bf16 store's application, where
    retained-pair residuals plateau whatever the iteration count; Ritz
    VALUES converge as resid^2/gap, far tighter than the bound. Raises
    :class:`PartialSpectrumError` past ``max_rank``.

    ``rank_multiple`` pads the RETURNED vector block to a multiple
    (capped at the stage width), so that downstream shapes stay stable
    across runs whose rank jitters at the acceptance threshold. Padding
    columns are genuine Ritz vectors whose values the caller must
    zero-gain (the clips do); ``r`` still reports the true retained
    rank.

    ``predict(w, k)`` (optional) maps the current Ritz head to an
    ESTIMATE of the rank the acceptance will need (or None when it
    cannot tell). A prediction NARROWS the widening to ~ the predicted
    rank (+10% + oversample, rounded to ``rank_multiple``), clamped to
    [k + step, 2k]. It is fed only the measured-converged Ritz prefix,
    and jumping ahead of the doubling schedule is deliberately banned:
    real spectra decay faster than a local geometric fit, so trusted
    extrapolations overshoot.

    ``generator``, ``draw``, ``dtype`` and ``device`` as in
    :func:`topk_eigh`; one block is drawn per stage.

    Returns (w, V, r): ``w`` the full computed Ritz head (descending,
    numpy), ``V`` the (n, rp) retained Ritz vectors (tensor,
    rp = r rounded up to ``rank_multiple``), ``r`` the retained rank.
    """
    matvec, n, dtype, device, normal, _ = _setup(
        operator, n, device, dtype, generator, draw)
    if k0 < 1:
        raise ValueError("k must be >= 1")
    if tol is None:
        tol = 1e-10 if torch.finfo(dtype).bits >= 64 else 1e-2

    def run_stage(width, locked):
        """(Q, B, all_ok (device), T) for one widened stage.

        `locked` is None for the cold first stage, else the
        (Q_lock, B_lock, B_act) split of the previous stage's Ritz
        pairs: the measured-converged leading prefix is frozen
        (deflation), the rest re-iterates warm-started from its current
        action alongside the fresh random columns.
        """
        if locked is None:
            Y = _apply(matvec, normal((n, width)))
            all_ok = torch.ones((), dtype=torch.bool, device=device)
            for _ in range(n_iter):
                Q, ok = _cholqr2(Y)
                all_ok = all_ok & ok
                # drop the pre-QR block BEFORE the sweep: an (n, width)
                # f32 block is 1.07 GB at 259,200 x 1,032, and a
                # streamed sweep needs room for its own tiles
                del Y
                Y = _apply(matvec, Q)
            Q, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            del Y
            Bn = _apply(matvec, Q)
            return Q, Bn, all_ok, _projection(Q, Bn)
        # locked widening: sweeps cost the ACTIVE width only. The active
        # block runs n_iter + 2 sweeps, which buys its pairs the accuracy
        # that re-iterating the whole block would give them.
        Q_lock, B_lock, B_act = locked
        n_fresh = width - Q_lock.shape[1] - B_act.shape[1]
        Y = _cat_cols([B_act, _apply(matvec, normal((n, n_fresh)))])
        all_ok = torch.ones((), dtype=torch.bool, device=device)
        for _ in range(n_iter + 2):
            Y = _deflate(Y, Q_lock)
            Qa, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            del Y  # see the cold path
            Y = _apply(matvec, Qa)
        Y = _deflate(Y, Q_lock)
        Qa, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        del Y
        Ba = _apply(matvec, Qa)
        Q = _cat_cols([Q_lock, Qa])
        Bn = _cat_cols([B_lock, Ba])
        return Q, Bn, all_ok, _projection(Q, Bn)

    def extra_round(B):
        Q2, ok = _cholqr2(B)
        B2 = _apply(matvec, Q2)
        return Q2, B2, ok, _projection(Q2, B2)

    k = min(n, k0)
    # `locked` carries the previous stage's Ritz pairs into the next
    # widening, split by MEASURED residuals: (Q_lock, B_lock) the
    # converged leading prefix (frozen: deflation), B_act the action of
    # the still-inaccurate pairs (warm start for re-iteration). None =
    # cold first stage.
    locked = None
    tiny = np.finfo(np.float32).tiny
    while True:
        width = min(n, k + oversample)
        if width >= n:
            # subspace is the whole space: be exact
            w, V = _exact(matvec, n, dtype, device)
            r = accept(w)
            r = n if r is None else r
            count("eigsh.kept", r)
            return w, _cols(V, None, r), r

        Q, B, all_ok, T = run_stage(width, locked)
        locked = None  # its blocks now live on in Q and B

        rounds = 0
        while True:
            if not bool(all_ok):
                Q, B = _householder_iterate(matvec, normal((n, width)),
                                            n_iter)
                all_ok = torch.ones((), dtype=torch.bool, device=device)
                T = _projection(Q, B)
            w, U = _ritz_eigh(T, dtype)
            r = accept(w)

            if r is not None and r <= k:
                # pad the SHAPES to rank_multiple so that downstream
                # shapes stay the same across runs whose rank jitters at
                # the boundary
                rp = min(width, -(-r // rank_multiple) * rank_multiple)
                U_r = U[:, :rp]
                if r <= k // 2:  # structural gate
                    logger.info(
                        "adaptive eigh: structural accept r=%d at "
                        "width=%d (round %d)", r, width, rounds,
                    )
                    count("eigsh.kept", r)
                    return w, _rmul(Q, U_r), r
                with span("eigsh.gate"):
                    theta_r = torch.as_tensor(w[:rp], dtype=dtype,
                                              device=device)
                    mask = (torch.arange(rp, device=device) < r).to(dtype)
                    resid_max, V = _resid_and_vectors(Q, B, U_r, theta_r,
                                                      mask)
                    scale = max(abs(float(w[0])), tiny)
                    rel = float(resid_max) / scale
                logger.info(
                    "adaptive eigh: width=%d r=%d round=%d "
                    "max_resid/theta1=%.3e (tol %.1e)",
                    width, r, rounds, rel, tol,
                )
                if rel <= tol:
                    count("eigsh.kept", r)
                    return w, V, r  # residual gate
                del V
            if r is None or r > k or rounds >= extra_rounds:
                break  # deeper head needed, or sharpening exhausted
            # sharpen the same block: one more power iteration
            rounds += 1
            del Q
            Q, B, ok, T = extra_round(B)
            all_ok = all_ok & ok

        if k >= min(n, max_rank):
            raise PartialSpectrumError(
                "Partial-spectrum solve did not converge within "
                f"max_rank={max_rank} eigenpairs: the spectrum is too "
                "flat for a low-rank clip; lower the target or use "
                "spectrum='full'."
            )
        # lock the converged leading prefix (aligned DOWN so no
        # unconverged pair is ever frozen), carry the rest's action as
        # the re-iteration warm start: ~2 (n, w) matmuls, no operator
        # sweep
        count("eigsh.widenings")
        with span("eigsh.lock"):
            align = max(1, rank_multiple)
            scale = max(abs(float(w[0])), tiny)
            theta_sorted = torch.as_tensor(w, dtype=dtype, device=device)
            QU, BU, rn = _rotate_ritz(Q, B, U, theta_sorted)
            n_conv = _converged_prefix(rn, scale, tol)
            n_lock = n_conv - n_conv % align
            locked = (_cols(QU, None, n_lock), _cols(BU, None, n_lock),
                      _cols(BU, n_lock))
            del QU, BU
            del Q, B, T, U

        cap = min(n, max_rank)
        k_next = min(cap, 2 * k)
        if predict is not None:
            # extrapolate ONLY from the measured-converged prefix:
            # unconverged tail Ritz values are biased and an
            # extrapolation from them over- or under-shoots wildly
            p = predict(w[:n_conv], k)
            if p is not None:
                step = max(oversample, rank_multiple)
                p = int(1.1 * p) + oversample
                p = -(-p // align) * align
                # a prediction may only NARROW the widening (a doubling
                # that overshoots a rank just past k pays CholQR and
                # sweep cost quadratic/linear in the excess width);
                # skipping AHEAD of the doubling schedule is banned
                k_next = min(cap, max(k + step, min(p, 2 * k)))
        logger.info(
            "adaptive eigh: widening %d -> %d (doubling %d), locking "
            "%d of %d computed pairs",
            k, k_next, min(cap, 2 * k), n_lock, len(w),
        )
        k = k_next


def topk_from_callable(
    kernel_matvec: Callable,
    n: int,
    k: int,
    **kwargs,
) -> tuple[np.ndarray, torch.Tensor]:
    """Convenience alias of :func:`topk_eigh` for streamed operators."""
    return topk_eigh(kernel_matvec, k, n, **kwargs)
