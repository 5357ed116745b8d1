"""The port's raw-observation binning (``native/gridbin``,
``grid.aggregate_observations``) against the JAX package's on the same
seeded numpy inputs (mirrors ``tests/test_native.py``): indices, boxes
and counts exactly, means to 1e-12 relative (the card's atomics add in an
order of their own; on the CPU the two agree to rounding as well).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from glomargridding_tpu.grid import grid as jgrid
from glomargridding_tpu.native import gridbin as jgb
from glomargridding_tpu_torch.core.labeled import Coordinates, DataArray
from glomargridding_tpu_torch.grid import grid as tgrid
from glomargridding_tpu_torch.native import gridbin as tgb

GRID_5 = (-87.5, 5.0, 36, -177.5, 5.0, 72)
MEAN_RTOL = 1e-12


def _positions(rng, n, edge=False):
    lats = rng.uniform(-95, 95, n)
    lons = rng.uniform(-185, 185, n)
    if edge:  # exact half-steps: round half to even, as np.rint
        lats[: n // 4] = -87.5 + 2.5 * rng.integers(-2, 75, n // 4)
        lons[: n // 4] = -177.5 + 2.5 * rng.integers(-2, 147, n // 4)
    return lats, lons


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("grid", [GRID_5, (-89.5, 1.0, 180, -179.5, 1.0, 360),
                                  (10.0, 0.25, 40, 30.0, 0.5, 17)])
def test_snap_to_grid(rng, grid, edge):
    lats, lons = _positions(rng, 4000, edge)
    ours = tgb.snap_to_grid(lats, lons, *grid, device="cpu")
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(),
                                  jgb.snap_to_grid(lats, lons, *grid))
    # f32 positions are promoted to f64 before the snap, as in numpy
    lats32 = lats.astype(np.float32)
    np.testing.assert_array_equal(
        tgb.snap_to_grid(torch.as_tensor(lats32), lons, *grid).numpy(),
        jgb.snap_to_grid(lats32, lons, *grid))


def test_snap_to_grid_matches_map_to_grid(rng):
    grid = tgrid.grid_from_resolution(5, [(-87.5, 90), (-177.5, 180)],
                                      ["lat", "lon"])
    lats, lons = rng.uniform(-86, 86, 500), rng.uniform(-176, 176, 500)
    mapped = tgrid.map_to_grid(pd.DataFrame({"lat": lats, "lon": lons}),
                               grid, grid_coords=["lat", "lon"], sort=False)
    np.testing.assert_array_equal(
        tgb.snap_to_grid(lats, lons, *GRID_5, device="cpu").numpy(),
        mapped["grid_idx"].to_numpy())


@pytest.mark.parametrize("n,boxes", [(10_000, 100), (5_000, 2592), (1, 3),
                                     (0, 7)])
def test_bin_mean(rng, n, boxes):
    idx = rng.integers(0, boxes, n)
    vals = rng.normal(size=n)
    u, m, c = tgb.bin_mean(idx, vals, boxes, device="cpu")
    ru, rm, rc = jgb.bin_mean(idx, vals, boxes)
    assert (u.dtype, m.dtype, c.dtype) == (torch.int64, torch.float64,
                                           torch.int64)
    np.testing.assert_array_equal(u.numpy(), ru)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_allclose(m.numpy(), rm, rtol=MEAN_RTOL)
    ref = pd.DataFrame({"i": idx, "v": vals}).groupby("i")["v"].mean()
    np.testing.assert_allclose(m.numpy(), ref.to_numpy(), rtol=MEAN_RTOL)


def test_bin_mean_range_check():
    for idx in ([5], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            tgb.bin_mean(np.array(idx), np.array([1.0]), 3, device="cpu")


def test_aggregate_observations(rng):
    kw = (5, [(-87.5, 90), (-177.5, 180)], ["lat", "lon"])
    lats, lons = _positions(rng, 20_000, edge=True)
    vals = rng.normal(size=20_000)
    ours = tgrid.aggregate_observations(
        lats, lons, vals, tgrid.grid_from_resolution(*kw), device="cpu")
    ref = jgrid.aggregate_observations(lats, lons, vals,
                                       jgrid.grid_from_resolution(*kw))
    np.testing.assert_array_equal(ours[0].numpy(), ref[0])
    np.testing.assert_allclose(ours[1].numpy(), ref[1], rtol=MEAN_RTOL)
    np.testing.assert_array_equal(ours[2].numpy(), ref[2])
    assert int(ours[2].sum()) == 20_000


def test_aggregate_observations_coords_and_irregular_grids(rng):
    grid = DataArray(coords=Coordinates({
        "latitude": np.arange(10.0, 20.0, 2.0),
        "longitude": np.arange(0.0, 6.0)}))
    lats, lons = rng.uniform(9, 19, 300), rng.uniform(-1, 6, 300)
    vals = rng.normal(size=300)
    u, m, c = tgrid.aggregate_observations(torch.as_tensor(lats), lons, vals,
                                           grid)
    assert u.device.type == "cpu"  # a tensor input keeps its device
    ref = jgb.bin_mean(jgb.snap_to_grid(lats, lons, 10.0, 2.0, 5, 0.0, 1.0,
                                        6), vals, 30)
    np.testing.assert_array_equal(u.numpy(), ref[0])
    np.testing.assert_array_equal(c.numpy(), ref[2])
    irregular = DataArray(coords=Coordinates(
        {"lat": np.array([0.0, 1.0, 5.0]), "lon": np.array([0.0, 1.0])}))
    with pytest.raises(ValueError, match="not regular"):
        tgrid.aggregate_observations(lats, lons, vals, irregular,
                                     device="cpu")
    single = DataArray(coords=Coordinates({"lat": np.array([0.0]),
                                           "lon": np.array([0.0, 1.0])}))
    out = tgrid.aggregate_observations(lats, lons, vals, single,
                                       device="cpu")
    np.testing.assert_array_equal(
        out[0].numpy(), jgrid.aggregate_observations(
            lats, lons, vals, _jax_grid(single))[0])


def _jax_grid(grid):
    from glomargridding_tpu.core import labeled as jlab

    return jlab.DataArray(coords=jlab.Coordinates(dict(grid.coords.items())))
