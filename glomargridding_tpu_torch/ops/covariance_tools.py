r"""PSD repair: eigenvalue clipping for estimated covariance matrices, on
tensors.

Port of ``glomargridding_tpu/ops/covariance_tools.py``. Estimated
covariances (ellipse-based assembly, short training series) are routinely
not positive-definite; these tools coerce them by eigenvalue surgery and
re-synthesis:

- ``eigenvalue_clip`` (recommended): trace-preserving clip, dispatching to
  ``explained_variance_clip`` (keep top EOFs to a target explained
  variance, average the rest) or ``laloux_clip`` (random-matrix-theory
  noise threshold lambda_max = (1 + sqrt(q))^2 on the correlation matrix).
- ``simple_clipping``: raise eigenvalues below a LAPACK-accuracy-aware
  threshold (5 * dtype resolution * max |lambda|) to that threshold. Not
  trace-preserving.
- the ``_lowrank`` clips: the same two clips from the TOP of the spectrum
  only (``ops.eigsh``), returning the repaired covariance in factored
  form (:class:`LowRankPSD`); nothing n x n is formed.

Everything runs on one device. A numpy matrix goes to `device`, by
default the card (``utils.device.resolve_device``: with no card the call
raises, so a CPU run names ``device="cpu"``); a tensor keeps its device;
the results are tensors there. The spectrum comes from
``torch.linalg.eigh`` on that device (the reference's host-LAPACK branch
exists because its accelerator emulates f64; it is left out). Random
start blocks: ``generator=`` / ``draw=`` as in ``ops.eigsh``.
"""

import logging
import math
from dataclasses import dataclass
from typing import Any, Literal
from warnings import warn

import numpy as np
import torch

from ..utils.arrays import cor_2_cov, cov_2_cor
from ..utils.device import resolve_device
from ..utils.profiling import span
from .eigsh import PartialSpectrumError, adaptive_topk_eigh
from .sampling import dense_matvec

logger = logging.getLogger(__name__)

__all_errors__ = (PartialSpectrumError,)  # re-exported for API stability

# Above this size "auto" clips switch from the full spectrum to the
# randomized top-k path: a full eigh is O(n^3) while the clip needs only
# the top of the spectrum + the trace. Set from chip_smoke.py phase 19 on
# an NVIDIA H100 80GB HBM3 (700 W; f32, target 0.90, K2-built matrices):
# 2,048 is the largest measured size at which the full clip still wins
# (0.053 s against 0.093 s); at 4,096 the partial clip wins 0.096 s
# against 0.202 s, at 8,192 0.14 s against 1.13 s, at 16,384 0.32 s
# against 4.93 s.
_AUTO_PARTIAL_THRESHOLD = 2048

# Above this size the parity wrappers refuse to densify a partial-clip
# result. Set from the same run: the 64,800-cell factors (the 1-degree
# grid) densify in 0.17 s at a peak of 17.1 GB of the card's 85 GB, so
# the guard sits above that grid; the next grid of the package, 259,200
# cells, would be 269 GB in f32, the allocation the factored path exists
# to avoid. On the card the dense result must also fit beside a dense
# input of its own size: at most this share of the device's memory, which
# keeps the measured f32 case (17.1 GB of 85) and refuses the same grid in
# f64 (33.6 GB beside a 33.6 GB input).
_DENSIFY_GUARD = 65536
_DENSIFY_MEMORY_SHARE = 0.25


def _densify_fits(lr) -> bool:
    """Whether a partial clip of a dense input comes back dense."""
    n, vectors = lr.n, lr.vectors
    if n > _DENSIFY_GUARD:
        return False
    if vectors.device.type != "cuda":
        return True
    total = torch.cuda.get_device_properties(vectors.device).total_memory
    return n * n * vectors.element_size() <= _DENSIFY_MEMORY_SHARE * total


def _on_device(cov, device=None):
    return torch.as_tensor(cov, device=resolve_device(device, cov))


def check_symmetric(a, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """True if a matrix (numpy or tensor) is symmetric within tolerance."""
    if isinstance(a, torch.Tensor):
        return bool(torch.allclose(a, a.T, rtol=rtol, atol=atol))
    a = np.asarray(a)
    return bool(np.allclose(a, a.T, rtol=rtol, atol=atol))


def clean_small(matrix, atol: float = 1e-5):
    """Zero out entries with |x| < atol (numpy or tensor; a copy)."""
    if isinstance(matrix, torch.Tensor):
        return torch.where(matrix.abs() < atol, torch.zeros_like(matrix),
                           matrix)
    matrix = np.asarray(matrix)
    cleaned = matrix.copy()
    cleaned[np.abs(matrix) < atol] = 0.0
    return cleaned


def csum_up_to_val(
    vals,
    target: float,
    reverse: bool = True,
    niter: int = 0,
    csum: float = 0.0,
) -> tuple[float, int]:
    """Cumulative-sum index at which `target` is first exceeded (host
    side, on a vector of eigenvalues).

    With `reverse` the array is walked from the end and the returned index
    is negative (indexing the unreversed array). Warns when the target is
    never exceeded or `vals` is empty.
    """
    vals = np.asarray(vals)
    if vals.size == 0:
        warn("`vals` is empty")
        return csum, niter
    if vals.ndim != 1:
        raise ValueError("`vals` must be a vector")

    # The returned index counts how many elements were consumed when the
    # running sum first exceeds the target (negated for a reversed walk),
    # so `vals[i:]` is exactly the exceeding tail.
    walk = vals[::-1] if reverse else vals
    csums = csum + np.cumsum(walk)
    exceed = np.nonzero(csums > target)[0]
    if csum > target:
        return csum, niter
    if exceed.size == 0:
        warn("Out of `vals`, target not exceeded.")
        i = len(walk)
        return float(csums[-1]), niter + (-i if reverse else i)
    i = int(exceed[0]) + 1
    return float(csums[i - 1]), niter + (-i if reverse else i)


def _resynthesise(eigvecs, eigvals):
    """V diag(w) V' as two matmuls."""
    return (eigvecs * eigvals[None, :]) @ eigvecs.T


def _eigh(a):
    """Symmetric eigendecomposition of a tensor on its device, in its
    dtype: (ascending eigenvalues as numpy on the host, eigenvectors on
    the device)."""
    w, v = torch.linalg.eigh(a)
    return w.cpu().numpy(), v


def _eigenvalue_clip(eigvals, eigvecs, keep_i: int):
    """Replace all but the top `-keep_i` eigenvalues by their average.

    Trace-preserving: the clipped eigenvalues' total mass is redistributed
    uniformly among them. Warns if the result is still not PD.
    """
    eigvals = np.asarray(eigvals)
    total_var = float(np.sum(eigvals))
    var_explained = float(np.sum(eigvals[keep_i:]))

    logger.info("total explained variance = %s", total_var)
    logger.info("clipped explained variance = %s", var_explained)

    if total_var < var_explained:
        explained_needed = float(np.sum(eigvals[keep_i + 1 :]))
        new_threshold = explained_needed / total_var
        raise ValueError(
            "Variance explained by retained eigenvalues exceeds total "
            "variance. Resulting matrix will have negative eigenvalues. "
            f"Try using a lower threshold. A value below {new_threshold:.2f} "
            "may work with explained_variance_clip."
        )

    keep_i = keep_i if keep_i < 0 else -keep_i
    n_eigvals = len(eigvals)
    clip_i = n_eigvals + keep_i
    unexplained = total_var - var_explained
    avg_for_unexplained = unexplained / clip_i

    new_eigvals = eigvals.copy()
    new_eigvals[:keep_i] = avg_for_unexplained
    out = _resynthesise(
        eigvecs, torch.as_tensor(new_eigvals, dtype=eigvecs.dtype,
                                 device=eigvecs.device))

    if not bool((torch.linalg.eigvalsh(out) > 0).all()):
        warn(
            "Resulting matrix is not positive-definite, and may not be a "
            "valid covariance matrix."
        )
    return out


def _find_index_explained_variance(eigvals, target: float = 0.95) -> int:
    """Index (negative) of the smallest kept eigenvalue for a variance
    target."""
    total_variance = float(np.sum(eigvals))
    target_explained = target * total_variance
    csum, i2goal = csum_up_to_val(eigvals, target_explained)
    if csum <= target_explained:
        raise ValueError("Target Explained Variance not exceeded")
    return i2goal


def _find_index_aspect_ratio(
    eigvals,
    num_grid_pts: int = 180 * 360,
    num_times: int = 41 * 6,
) -> int:
    """Negative count of eigenvalues above the RMT noise ceiling.

    threshold = (1 + sqrt(q))^2, q = max(N/T, T/N): the largest eigenvalue
    a correlation matrix of uncorrelated data can produce (Laloux 2000 /
    Bun 2017 S7.2.2).
    """
    q = num_grid_pts / num_times
    if q < 1.0:
        q = 1.0 / q
    threshold = (1.0 + np.sqrt(q)) ** 2.0
    return -int(np.sum(np.asarray(eigvals) > threshold))


# ---------------------------------------------------------------------------
# Device-scale (partial-spectrum) clipping
# ---------------------------------------------------------------------------
@dataclass
class LowRankPSD:
    r"""A clipped covariance in factored form: diag(floor) + W diag(g) W'.

    Both trace-preserving clips produce exactly this structure: the
    retained eigenspace keeps its spectrum, everything orthogonal to it
    gets a uniform eigenvalue (the "floor"). So at 64,800 cells the
    repaired covariance never needs to exist as an n x n array: matvecs
    are one (n, r) matmul pair and exact N(0, C) draws cost
    O(n(r + members)) (``draw``), which plugs straight into the ensemble
    pipeline. The three tensors live on one device.
    """

    vectors: torch.Tensor  # (n, r); orthonormal iff floor is uniform
    gains: torch.Tensor  # (r,) nonnegative spectral surplus over the floor
    floor: torch.Tensor  # (n,) nonnegative diagonal floor

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def rank(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def effective_rank(self) -> int:
        """Columns carrying non-zero gain (excludes shape padding from
        ``rank_multiple`` / ``pad_rank``)."""
        return int(torch.sum(self.gains > 0))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    def matvec(self, x):
        """(diag(floor) + W g W') @ x for x of shape (n,) or (n, b)."""
        x = torch.as_tensor(x, dtype=self.vectors.dtype,
                            device=self.vectors.device)
        fl = self.floor if x.dim() == 1 else self.floor[:, None]
        g = self.gains if x.dim() == 1 else self.gains[:, None]
        return fl * x + self.vectors @ (g * (self.vectors.T @ x))

    def diagonal(self):
        return self.floor + torch.sum(
            self.vectors**2 * self.gains[None, :], dim=1
        )

    def trace(self) -> float:
        # Exact for NON-orthonormal vectors too (laloux scales columns
        # by sqrt(diag)): tr(W g W') = sum_k g_k ||w_k||^2.
        return float(
            torch.sum(self.floor)
            + torch.sum(self.gains * torch.sum(self.vectors**2, dim=0))
        )

    def to_dense(self) -> torch.Tensor:
        """The (n, n) covariance, on the factors' device (16.8 GB in f32
        at 64,800 cells: nothing but this call allocates it)."""
        out = (self.vectors * self.gains[None, :]) @ self.vectors.T
        out.diagonal().add_(self.floor)
        return out

    def draw(self, n_members: int, *, generator=None, noise=None):
        """(n_members, n) exact draws of N(0, diag(floor) + W g W').

        The standard normals come from `generator` (torch's global one
        when None), or are given as ``noise=(z1, z2)`` of shapes
        (n, n_members) and (rank, n_members).
        """
        z1, z2 = _normals(noise, generator,
                          [(self.n, n_members), (self.rank, n_members)],
                          self.vectors)
        x = torch.sqrt(self.floor)[:, None] * z1 + self.vectors @ (
            torch.sqrt(self.gains)[:, None] * z2
        )
        return x.T

    def pad_rank(self, multiple: int = 128) -> "LowRankPSD":
        """Pad the factors with zero-gain columns to a rank multiple.

        Numerically inert (zero gains contribute nothing to W g W',
        draws, or the solvers): the adaptive clips return a DIFFERENT
        rank per month, and padding to a fixed multiple keeps the
        downstream shapes stable across months.
        """
        if multiple < 1:
            raise ValueError("multiple must be >= 1")
        r = self.rank
        r_pad = -(-r // multiple) * multiple
        if r_pad == r:
            return self
        with span("lowrank.pad"):
            dt = self.vectors.dtype
            vecs = torch.nn.functional.pad(self.vectors, (0, r_pad - r))
            gains = torch.nn.functional.pad(self.gains.to(dt),
                                            (0, r_pad - r))
        return LowRankPSD(vectors=vecs, gains=gains, floor=self.floor)


def _normals(noise, generator, shapes, like):
    """Standard-normal tensors of `shapes` beside `like`: drawn from
    `generator` in order, or the given `noise` tensors, checked."""
    if noise is None:
        return [torch.randn(s, dtype=like.dtype, device=like.device,
                            generator=generator) for s in shapes]
    if len(noise) != len(shapes):
        raise ValueError(f"noise must hold {len(shapes)} arrays")
    out = [torch.as_tensor(z, dtype=like.dtype, device=like.device)
           for z in noise]
    for z, s in zip(out, shapes):
        if tuple(z.shape) != tuple(s):
            raise ValueError(
                f"noise has shape {tuple(z.shape)}, expected {tuple(s)}")
    return out


def _positive_head(w):
    wv = np.asarray(w, np.float64)
    return wv[wv > 0]


def _tail_ratio(wv):
    """Geometric ratio fitted to the last quarter of a positive,
    descending Ritz head, or None when that tail does not decay (no
    basis to extrapolate)."""
    L = wv.size
    q = max(4, L // 4)
    a, b = wv[L - q], wv[L - 1]
    if b <= 0 or a <= b * (1.0 + 1e-12):
        return None
    rho = (b / a) ** (1.0 / (q - 1))
    return min(max(rho, 1e-9), 0.99999)


def explained_variance_clip_lowrank(  # noqa: C901
    operator,
    n: int | None = None,
    trace: float | None = None,
    target_variance_fraction: float = 0.95,
    *,
    generator=None,
    draw=None,
    k0: int = 64,
    max_rank: int = 2048,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    rank_multiple: int = 1,
    dtype=None,
    device=None,
) -> LowRankPSD:
    """Trace-preserving explained-variance clip WITHOUT the full spectrum.

    The clip keeps the top-r eigenpairs (r = smallest count whose
    eigenvalues exceed ``target_variance_fraction`` of the trace) and
    assigns every remaining direction their average eigenvalue, which is
    exactly ``avg * I + V_r diag(w_r - avg) V_r'``, so only the top of the
    spectrum is ever computed (randomized subspace iteration,
    ``ops.eigsh``). Accepts a dense matrix or a matvec callable (with `n`
    and `trace` supplied); the 1-degree path passes the bf16 covariance
    operator and never materialises anything n x n in f32.
    """
    if not 0.0 < target_variance_fraction <= 1.0:
        raise ValueError("'target_variance_fraction' must be (0, 1.0]")
    if not callable(operator):
        operator = _on_device(operator, device)
        trace = float(torch.trace(operator)) if trace is None else trace
        n = operator.shape[0]
    elif n is None or trace is None:
        raise ValueError("n and trace are required for a callable operator")
    target = target_variance_fraction * trace

    def accept(w):
        csum = np.cumsum(w)
        hit = np.nonzero(csum > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    def predict(w, k):
        """Estimate the rank the variance target needs by geometric
        extrapolation of the computed Ritz tail.

        Blind k-doubling overshoots the needed subspace width by up to
        2x, and every extra column costs a full operator sweep's matmul
        width. The decaying spectra this clip exists for are locally
        ~geometric, so the tail ratio of the last quarter of the head
        predicts how many more eigenvalues reach the target; the solver
        clamps the prediction to [k + step, 2k], so the provable
        doubling schedule is the worst case.
        """
        wv = _positive_head(w)
        L = wv.size
        if L < 8:
            return None
        remaining = target - float(wv.sum())
        if remaining <= 0:
            return L
        rho = _tail_ratio(wv)
        if rho is None:
            return None
        b = wv[L - 1]
        geo_inf = b * rho / (1.0 - rho)
        if geo_inf <= remaining:
            return None  # even an infinite geometric tail falls short
        x = remaining * (1.0 - rho) / (b * rho)
        m = int(math.ceil(math.log1p(-x) / math.log(rho)))
        return L + max(m, 1)

    with span("eigsh.clip"):
        w, V, r = adaptive_topk_eigh(
            operator, accept, n, k0=k0, max_rank=max_rank, generator=generator,
            draw=draw, oversample=oversample, n_iter=n_iter, tol=tol,
            rank_multiple=rank_multiple, dtype=dtype, predict=predict,
            device=device,
        )
        retained = w[:r]
        var_explained = float(retained.sum())
        if trace < var_explained:
            rel_excess = (var_explained - trace) / max(abs(trace), 1e-30)
            if r < n and rel_excess > 1e-4:
                new_threshold = float(retained[:-1].sum()) / trace
                raise ValueError(
                    "Variance explained by retained eigenvalues exceeds "
                    "total variance. Resulting matrix will have negative "
                    "eigenvalues. Try using a lower threshold. A value "
                    f"below {new_threshold:.2f} may work."
                )
            # full-rank retention / solver roundoff: the clip is (near-)
            # exact, so clamp instead of failing
            var_explained = trace
        # r == n: everything retained, the clip is exact and the floor is 0
        avg = 0.0 if r >= n else (trace - var_explained) / (n - r)
        logger.info("total explained variance = %s", trace)
        logger.info("clipped explained variance = %s", var_explained)
        # re-normalise the retained columns: the solver's wide basis is only
        # ~1e-3 orthonormal in f32 when the operator's numerical rank is
        # below the iteration width, and tr(W g W') depends directly on the
        # column norms (trace preservation would silently degrade). V may be
        # rank_multiple-padded; padding columns get zero gain.
        return _factored(V, retained, avg, r, None)


def _factored(V, retained, avg, r, d):
    """The LowRankPSD of a clip: unit-normalised Ritz vectors (scaled by
    the standard deviations `d` for the correlation clip), gains
    max(retained - avg, 0) on the first r columns and zero on the
    padding, floor avg (times the variances d^2).

    Row-sharded vectors (a solve on ``parallel.sharded_ellipse_stream_
    operator``) are gathered on their first slot here: ``LowRankPSD`` and
    every factored path that takes it (``models.lowrank``, the sharded
    ``parallel.lowrank``, which shards it again) hold a tensor."""
    if not isinstance(V, torch.Tensor):
        V = V.gather()
    vecs = V / torch.sqrt(torch.sum(V**2, dim=0))[None, :]
    g_host = np.zeros(V.shape[1], dtype=np.float64)
    g_host[:r] = np.maximum(np.asarray(retained, np.float64) - avg, 0.0)
    gains = torch.as_tensor(g_host, dtype=V.dtype, device=V.device)
    if d is None:
        floor = torch.full((V.shape[0],), avg, dtype=V.dtype,
                           device=V.device)
    else:
        vecs = d[:, None] * vecs
        floor = avg * (d * d)
    return LowRankPSD(vectors=vecs, gains=gains, floor=floor)


def laloux_clip_lowrank(  # noqa: C901
    operator,
    diag=None,
    n: int | None = None,
    num_grid_pts: int | None = None,
    num_time_pts: int = 40,
    *,
    generator=None,
    draw=None,
    k0: int = 64,
    max_rank: int = 2048,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    rank_multiple: int = 1,
    dtype=None,
    device=None,
) -> LowRankPSD:
    """RMT (Laloux 2000) clip without the full spectrum.

    Standardises to the correlation operator, keeps every eigenvalue above
    the random-matrix ceiling (1 + sqrt(q))^2, floors the rest at their
    average (trace of a correlation matrix = n), and rescales back by the
    variances. `diag` (the covariance diagonal) is required for callable
    operators.
    """
    if not callable(operator):
        A = _on_device(operator, device)
        n = A.shape[0]
        diag = torch.diagonal(A) if diag is None else torch.as_tensor(
            diag, device=A.device)
        if A.dtype == torch.bfloat16:
            diag = diag.float()
        base_mv = dense_matvec(A)
        device = A.device
        if dtype is None:
            dtype = diag.dtype
    else:
        if n is None or diag is None:
            raise ValueError(
                "n and diag are required for a callable operator"
            )
        if device is None and generator is not None:
            device = generator.device
        diag = torch.as_tensor(diag, device=resolve_device(device, diag))
        device = diag.device
        base_mv = operator
    d = torch.sqrt(diag)
    inv_d = 1.0 / d

    def cor_mv(X):
        X = torch.as_tensor(X, device=device)
        scale = (inv_d if X.dim() == 1 else inv_d[:, None]).to(X.dtype)
        return scale * torch.as_tensor(base_mv(scale * X), device=device)

    slots = getattr(base_mv, "row_devices", None)
    if slots is not None:
        cor_mv = _sharded_cor_mv(base_mv, inv_d, slots, cor_mv)

    num_grid_pts = num_grid_pts or n
    q = num_grid_pts / num_time_pts
    if q < 1.0:
        q = 1.0 / q
    threshold = (1.0 + np.sqrt(q)) ** 2.0

    def accept(w):
        # all above-threshold pairs are captured once the computed head
        # dips below the ceiling
        if w[-1] > threshold:
            return None
        return max(int(np.sum(w > threshold)), 1)

    def predict(w, k):
        """Rank estimate: geometric tail extrapolation to where the
        spectrum crosses the RMT ceiling (see the explained-variance
        predictor for rationale; the solver clamps to [k + step, 2k])."""
        wv = _positive_head(w)
        L = wv.size
        if L < 8:
            return None
        b = wv[-1]
        if b <= threshold:
            return L
        rho = _tail_ratio(wv)
        if rho is None:
            return None
        m = int(math.ceil(math.log(threshold / b) / math.log(rho)))
        return L + max(m, 1)

    with span("eigsh.clip"):
        w, V, r = adaptive_topk_eigh(
            cor_mv, accept, n, k0=k0, max_rank=max_rank, generator=generator,
            draw=draw, oversample=oversample, n_iter=n_iter, tol=tol,
            rank_multiple=rank_multiple, dtype=dtype, predict=predict,
            device=device,
        )
        retained = w[:r]
        avg = 0.0 if r >= n else (n - float(retained.sum())) / (n - r)
        if avg < 0:
            raise ValueError(
                "Retained eigenvalues exceed the correlation trace; the "
                "aspect-ratio threshold retained too much variance."
            )
        # unit-normalise the correlation eigenvectors before the sqrt(diag)
        # scaling (see explained_variance_clip_lowrank)
        return _factored(V, retained, avg, r, d.to(V.dtype))


def _sharded_cor_mv(base_mv, inv_d, slots, whole_mv):
    """The correlation operator D^-1/2 C D^-1/2 of a row-sharded operator:
    a ``Sharded`` block is scaled on its slots, a tensor by `whole_mv`."""
    from ..parallel.mesh import Sharded, shard_rows

    scales = shard_rows(inv_d[:, None], slots)

    def cor_mv(X):
        if not isinstance(X, Sharded):
            return whole_mv(X)
        Y = base_mv(Sharded([s.to(x.dtype) * x
                             for s, x in zip(scales, X.parts)]))
        return Sharded([s.to(y.dtype) * y for s, y in zip(scales, Y.parts)])

    cor_mv.row_devices = slots
    return cor_mv


Spectrum = Literal["auto", "full", "partial"]


def _use_partial(n: int, spectrum: Spectrum) -> bool:
    match spectrum:
        case "full":
            return False
        case "partial":
            return True
        case "auto":
            return n > _AUTO_PARTIAL_THRESHOLD
        case _:
            raise ValueError(f"unknown spectrum mode {spectrum!r}")


def _partial_clip(name, lowrank, cov, spectrum, device, kwargs):
    """The partial-spectrum branch shared by the two clips: the result
    of `lowrank` under the return-type contract, or None when the full
    path must run (a dense input that is small under "auto", or whose
    partial solve did not converge under "auto")."""
    if not callable(cov) and not _use_partial(cov.shape[0], spectrum):
        return None
    try:
        lr = lowrank(cov, device=device, **kwargs)
    except PartialSpectrumError:
        # spectrum too flat for a low-rank clip: under "auto" a dense
        # input falls back to the exact full path; explicit "partial" or
        # a callable re-raises. (Only this specific non-convergence
        # triggers the fallback: argument errors still surface.)
        if callable(cov) or spectrum != "auto":
            raise
        logger.warning(
            "partial-spectrum clip did not converge; falling back to the "
            "full eigh (n=%s)", cov.shape[0],
        )
        return None
    if callable(cov):
        return lr
    if not _densify_fits(lr):
        # LOUD: the caller handed us a dense matrix and gets a different
        # type back, and a log line is too easy to miss
        warn(
            f"{name}: n={lr.n} (past {_DENSIFY_GUARD} points, or "
            f"{_DENSIFY_MEMORY_SHARE:.0%} of the card's memory in "
            f"{lr.vectors.dtype}) returns the factored "
            "LowRankPSD (densifying would allocate the n^2 array the "
            f"partial path avoids); call .to_dense() explicitly or use "
            f"{name}_lowrank"
        )
        return lr
    return lr.to_dense()


def explained_variance_clip(
    cov,
    target_variance_fraction: float = 0.95,
    spectrum: Spectrum = "auto",
    device=None,
    **partial_kwargs,
):
    """Trace-preserving clip keeping EOFs up to a target explained variance.

    Eigenvalues outside the retained set (small positive and negative) are
    replaced by their common average so the total variance is conserved.
    ``spectrum`` selects the eigensolver: "full" (the exact spectrum),
    "partial" (randomized top-k, the only path that scales past ~10k),
    or "auto" (partial above n=2048). Both return the same matrix to
    solver accuracy (pinned by tests).

    Return-type contract: for a DENSE input up to n=65536 (and, on the
    card, up to a quarter of its memory: 64,800 in f32 on 80 GB, not in
    f64) the repaired matrix comes back dense (a tensor on the call's
    device). For a
    CALLABLE operator, or a dense input past that guard, the result is
    the factored :class:`LowRankPSD`: densifying it would allocate the
    n x n array (269 GB at 259,200) that the matvec path exists to avoid;
    call ``.to_dense()`` explicitly if the allocation is truly wanted, or
    use :func:`explained_variance_clip_lowrank` directly.
    """
    if not callable(cov):
        cov = _on_device(cov, device)
    out = _partial_clip(
        "explained_variance_clip", explained_variance_clip_lowrank, cov,
        spectrum, device,
        dict(target_variance_fraction=target_variance_fraction,
             **partial_kwargs))
    if out is not None:
        return out
    if not 0.0 < target_variance_fraction <= 1.0:
        raise ValueError("'target_variance_fraction' must be (0, 1.0]")
    eigvals, eigvecs = _eigh(cov)
    keep_i = _find_index_explained_variance(
        eigvals, target=target_variance_fraction
    )
    return _eigenvalue_clip(eigvals, eigvecs, keep_i)


def laloux_clip(
    cov,
    num_grid_pts: int | None = None,
    num_time_pts: int = 40,
    spectrum: Spectrum = "auto",
    device=None,
    **partial_kwargs,
):
    """RMT (Laloux 2000) clip on the correlation matrix.

    Standardise to correlation, clip eigenvalues below the random-matrix
    ceiling (1 + sqrt(q))^2, rescale back to covariance with the original
    variances. ``spectrum`` as in :func:`explained_variance_clip`,
    including the return-type contract: callable operators and dense
    inputs past n=65536 come back as the factored :class:`LowRankPSD`
    (never an implicit n x n materialisation).
    """
    if not callable(cov):
        cov = _on_device(cov, device)
    out = _partial_clip(
        "laloux_clip", laloux_clip_lowrank, cov, spectrum, device,
        dict(num_grid_pts=num_grid_pts, num_time_pts=num_time_pts,
             **partial_kwargs))
    if out is not None:
        return out
    num_grid_pts = num_grid_pts or cov.shape[0]
    variances = torch.diagonal(cov)
    eigvals, eigvecs = _eigh(cov_2_cor(cov))
    keep_i = _find_index_aspect_ratio(
        eigvals, num_grid_pts=num_grid_pts, num_times=num_time_pts,
    )
    clipped_cor = _eigenvalue_clip(eigvals, eigvecs, keep_i)
    return cor_2_cov(clipped_cor, variances)


def eigenvalue_clip(
    cov,
    method: Literal["explained_variance", "Laloux_2000"] = (
        "explained_variance"
    ),
    **kwargs,
):
    """Denoise a damaged covariance by eigenvalue clipping (recommended)."""
    match method:
        case "explained_variance":
            return explained_variance_clip(cov, **kwargs)
        case "Laloux_2000":
            return laloux_clip(cov, **kwargs)
        case _:
            raise ValueError("Unknown clipping method")


def simple_clipping(
    cov,
    threshold: float | Literal["auto", "statsmodels_default"] = "auto",
    method: Literal["iterative", "direct"] = "iterative",
    device=None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Raise eigenvalues below a threshold to the threshold.

    'auto' threshold = 5 * dtype resolution * max|lambda| (the LAPACK
    eigenvalue accuracy bound); 'statsmodels_default' = 1e-15 (unsuitable
    for f32 inputs, kept for comparison). Not trace-preserving. Returns
    (adjusted covariance, summary dict with threshold / smallest_eigv /
    determinant / total_variance). The reference's iterative rank-1 route
    and its direct route coincide here (both synthesise V diag(w_new) V'),
    so `method` changes nothing.
    """
    cov = _on_device(cov, device)
    eigvals, eigvecs = _eigh(cov)
    max_abs = float(np.max(np.abs(eigvals)))

    if threshold == "auto":
        threshold = float(5.0 * np.finfo(eigvals.dtype).resolution * max_abs)
    elif threshold == "statsmodels_default":
        threshold = 1e-15
    if not isinstance(threshold, (float, int)):
        raise TypeError(
            "threshold must either be number, auto or statsmodels_default. "
            f"Got {threshold = }."
        )

    n_below = int(np.sum(eigvals < threshold))
    if n_below == len(eigvals):
        warn("Input has all negative eigenvalues")
    logger.info("Minimum eigenvalue threshold = %s", threshold)
    logger.info("Eigenvalues below threshold = %s", n_below)

    new_eigvals = torch.as_tensor(np.maximum(eigvals, threshold),
                                  dtype=cov.dtype, device=cov.device)
    cov_adj = _resynthesise(eigvecs, new_eigvals)
    meta = {
        "threshold": threshold,
        "smallest_eigv": float(torch.linalg.eigvalsh(cov_adj).min()),
        "determinant": float(torch.linalg.det(cov_adj)),
        "total_variance": float(torch.sum(torch.diagonal(cov_adj))),
    }
    return cov_adj, meta


def perturb_cov_to_positive_definite(
    cov, threshold: float | Literal["auto"] = 1e-15, device=None
):
    """Deprecated statsmodels-based clip; delegates to simple_clipping."""
    warn(
        "This function is deprecated in favour of 'simple_clipping'",
        DeprecationWarning,
    )
    cov = _on_device(cov, device)
    if cov.dim() != 2 or cov.shape[0] != cov.shape[1] or not (
            check_symmetric(cov)):
        raise ValueError("Matrix is not square and/or symmetric.")
    if float(torch.linalg.eigvalsh(cov).min()) >= 0.0:
        return cov
    adj, _ = simple_clipping(cov, threshold=threshold)
    return adj
