"""``EllipseBuilder.fit_cells``, the fit of a chosen set of cells, on the
CPU in f64: it is ``compute_params``' fit of those cells, its lanes are
padded and trimmed, it refuses indices outside the unmasked points, and
it records its spans and counters (``utils/profiling``) as declared.

The cube is drawn on a 5-degree regional grid (8 x 10 cells) from a
planar anisotropic exponential covariance; each fit keeps its 48 nearest
columns, so the top-k gather is on the path.
"""

import numpy as np
import pytest
import torch

from glomargridding_tpu_torch import CellFits, EllipseBuilder, EllipseModel
from glomargridding_tpu_torch.models.ellipse import estimate
from glomargridding_tpu_torch.ops import optim
from glomargridding_tpu_torch.utils import profiling
from glomargridding_tpu_torch.utils.profiling import COUNTS, spans_on

torch.set_num_threads(2)

LATS = np.arange(-17.5, 22.5, 5.0)  # 8 rows
LONS = np.arange(2.5, 52.5, 5.0)  # 10 columns
MODEL_KW = dict(anisotropic=True, rotated=True, physical_distance=True,
                v=1.5, unit_sigma=True)
FIT_KW = dict(
    max_distance=6000.0,
    guesses=[800.0, 800.0, 0.0],
    bounds=[(100.0, 20000.0), (100.0, 20000.0), (-2 * np.pi, 2 * np.pi)],
    tol=1e-5,
    max_train_cols=48,
)
CHUNK = 32
SPANS = ("mle.fit", "mle.build", "mle.solve", "nm.evaluate", "nm.read")


@pytest.fixture(scope="module")
def builder():
    rng = np.random.default_rng(160)
    la, lo = np.meshgrid(LATS, LONS, indexing="ij")
    x = 111.2 * lo.ravel() * np.cos(np.radians(2.5))
    y = 111.2 * la.ravel()
    c, s = np.cos(0.4), np.sin(0.4)
    u = (c * (x[:, None] - x[None, :]) + s * (y[:, None] - y[None, :]))
    v = (-s * (x[:, None] - x[None, :]) + c * (y[:, None] - y[None, :]))
    cov = np.exp(-np.sqrt((u / 1500.0) ** 2 + (v / 700.0) ** 2))
    cube = (np.linalg.cholesky(cov + 1e-9 * np.eye(x.size))
            @ rng.normal(size=(x.size, 60))).T.reshape(60, LATS.size,
                                                        LONS.size)
    return EllipseBuilder(cube, {"time": np.arange(60), "latitude": LATS,
                                 "longitude": LONS}, device="cpu")


def model():
    return EllipseModel(**MODEL_KW)


def fit(builder, cells, **kw):
    return builder.fit_cells(cells, model(), **{**FIT_KW, **kw})


def test_fit_cells_is_compute_params_on_those_cells(builder):
    """A strided selection, padded to compute_params' chunk, fits each of
    its cells as the whole-grid fit does: the same lane in a batch of the
    same shape, so the same bits."""
    fields = builder.compute_params([-1.0] * 6, model(), chunk_size=CHUNK,
                                    **FIT_KW)
    cells = np.arange(3, LATS.size * LONS.size, 5)
    fits = fit(builder, cells, chunk_size=CHUNK)
    assert isinstance(fits, CellFits)
    assert all(t.shape[0] == cells.size for t in fits)
    assert fits.fun.dtype == torch.float64 and bool(fits.has_data.all())
    _, bounds_out = model()._fit_setup(FIT_KW["guesses"], FIT_KW["bounds"],
                                      torch.float64)[1:]
    pm, score, _ = estimate._postprocess_fits(
        fits.x.numpy(), fits.success.numpy(), model(), bounds_out, 3)
    rows, cols = np.unravel_index(cells, (LATS.size, LONS.size))
    for k, name in enumerate(("Lx", "Ly", "theta")):
        np.testing.assert_array_equal(pm[:, k], fields[name].values[rows,
                                                                    cols])
    np.testing.assert_array_equal(score, fields["qc_code"].values[rows,
                                                                   cols])
    np.testing.assert_array_equal(
        fits.nit.numpy(), fields["number_of_iterations"].values[rows, cols])
    assert (score == 0).mean() > 0.8


def test_padding_a_single_cell_and_refusals(builder):
    """Padding adds lanes and drops them again; a cell alone, and the
    cell among others, reach one optimum. Not bitwise: the batch's shape
    changes how the sum over a lane's columns is vectorised (to 1e-10 in
    f64, test_torch_ellipse_estimate's chunking test), and the simplex
    may take a comparison the other way at the last bits, so the optimum
    is held to the fit's own tolerance, 1e-5 relative."""
    cells = np.array([11, 4, 57])
    padded = fit(builder, cells, chunk_size=8)
    bare = fit(builder, cells)
    alone = fit(builder, [57])
    assert padded.x.shape == (3, 3) and alone.x.shape == (1, 3)
    np.testing.assert_allclose(padded.x.numpy(), bare.x.numpy(), rtol=1e-5)
    np.testing.assert_allclose(alone.x.numpy()[0], bare.x.numpy()[2],
                               rtol=1e-5)
    np.testing.assert_allclose(alone.fun.numpy()[0], bare.fun.numpy()[2],
                               rtol=1e-12)
    n = LATS.size * LONS.size
    with pytest.raises(IndexError, match="unmasked points"):
        fit(builder, [0, n])
    with pytest.raises(IndexError, match="unmasked points"):
        fit(builder, [-1])
    with pytest.raises(ValueError, match="non-empty"):
        fit(builder, [])
    with pytest.raises(ValueError, match="exceed chunk_size"):
        fit(builder, cells, chunk_size=2)
    with pytest.raises(ValueError, match="opt_method"):
        fit(builder, cells, opt_method="Powell")


def test_the_five_spans_are_emitted(builder):
    with spans_on(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fit(builder, [1, 2, 3])
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPANS:
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(spans) == set(SPANS)
    (a, b), = spans["mle.fit"]
    for name in SPANS[1:]:
        assert all(a <= s and e <= b for s, e in spans[name]), name
    assert len(spans["nm.read"]) > 1
    # off, a span is the shared null context
    assert profiling.span("mle.fit") is profiling.span("nm.read")


def test_the_counters_count_the_loop(builder):
    """Trips: the longest-active lane is active in every trip but the
    last, which finds no lane active, so trips = max(nit) + 1; each trip
    evaluates 4 candidates, the start and each shrink d + 1 points."""
    before = {k: COUNTS[k] for k in ("nm.iterations", "nm.points",
                                     "nm.shrinks", "mle.lanes")}
    fits = fit(builder, np.arange(0, 80, 3), chunk_size=CHUNK)
    delta = {k: COUNTS[k] - v for k, v in before.items()}
    trips = int(fits.nit.max()) + 1
    d = fits.x.shape[1]
    assert delta["nm.iterations"] == trips
    assert delta["nm.shrinks"] >= 1
    assert delta["nm.points"] == (d + 1) * (1 + delta["nm.shrinks"]) \
        + 4 * trips
    assert delta["mle.lanes"] == CHUNK
    # compute_params hands the optimiser one padded chunk at a time
    before = COUNTS["mle.lanes"]
    builder.compute_params([-1.0] * 6, model(), chunk_size=CHUNK, **FIT_KW)
    assert COUNTS["mle.lanes"] - before == 3 * CHUNK


def test_the_nelder_mead_lane_hands_k5_every_call(builder, monkeypatch):
    """Where K5 takes the fit (forced here, on the CPU), every objective
    call of the simplex goes to its wrapper, with the model's order and
    sigma flag and the call's lane mask; a stand-in that computes the
    plain twin on the mask's lanes and NaN on the others gives the plain
    fit's bits, so the fit reads no lane it skips."""
    cells = np.arange(0, 80, 3)
    want = fit(builder, cells, chunk_size=CHUNK)
    twin = optim.stacked_objective(model()._nll_fit_z, 3)
    calls = []

    def stand_in(points, X, z_y, w, mask, *, v, fit_sigma):
        calls.append((v, fit_sigma, int(mask.sum())))
        return torch.where(mask, twin(points, X, z_y, w, mask), torch.nan)

    monkeypatch.setattr(estimate, "_k5_takes", lambda *a: True)
    monkeypatch.setattr(estimate.ellipse_nll, "fisher_z_nll", stand_in)
    names = ("nm.iterations", "nm.shrinks", "nm.lanes_offered",
             "nm.lanes_evaluated")
    before = {k: COUNTS[k] for k in names}
    got = fit(builder, cells, chunk_size=CHUNK)
    delta = {k: COUNTS[k] - v for k, v in before.items()}
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert len(calls) == 1 + delta["nm.iterations"] + delta["nm.shrinks"]
    assert {c[:2] for c in calls} == {(MODEL_KW["v"], False)}
    assert delta["nm.lanes_offered"] == CHUNK * len(calls)
    assert delta["nm.lanes_evaluated"] == sum(c[2] for c in calls)
    assert delta["nm.lanes_evaluated"] < delta["nm.lanes_offered"]
