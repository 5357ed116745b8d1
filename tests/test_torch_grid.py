"""The port's ``grid/{grid,mask,climatology}`` against the JAX package's
on the same seeded numpy inputs (mirrors ``tests/test_grid.py`` and
``tests/test_mask_climatology.py``). Host functions agree exactly; the
distance matrix (f64, on the device) to the port's haversine bound,
rtol 1e-8.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from glomargridding_tpu.core import labeled as jlab
from glomargridding_tpu.grid import climatology as jclim
from glomargridding_tpu.grid import grid as jgrid
from glomargridding_tpu.grid import mask as jmask
from glomargridding_tpu.io import save_dataset as jsave_dataset
from glomargridding_tpu_torch.core import labeled as tlab
from glomargridding_tpu_torch.grid import climatology as tclim
from glomargridding_tpu_torch.grid import grid as tgrid
from glomargridding_tpu_torch.grid import mask as tmask

GLOBAL_5 = (5, [(-87.5, 90), (-177.5, 180)])


def _grids(resolution, bounds, names=("lat", "lon")):
    return (tgrid.grid_from_resolution(resolution, bounds, list(names)),
            jgrid.grid_from_resolution(resolution, bounds, list(names)))


def _same_array(ours, ref):
    assert ours.dims == ref.dims and ours.shape == ref.shape
    for k in ref.coords:
        np.testing.assert_array_equal(ours.coords[k], ref.coords[k])
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


@pytest.mark.parametrize("resolution,bounds", [
    GLOBAL_5,
    ([5, 10], [(-87.5, 90), (-175.0, 180)]),
    (1, [(1, 21), (1, 21)]),
    (0.25, [(-10.0, 10.0), (30.0, 40.0)]),
])
def test_grid_from_resolution(resolution, bounds):
    ours, ref = _grids(resolution, bounds)
    _same_array(ours, ref)
    with pytest.raises(ValueError, match="same length"):
        tgrid.grid_from_resolution([5], bounds, ["lat", "lon"])


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("bounds", [None, [(-40, 40), (-100, 100)]])
def test_map_to_grid(rng, sort, bounds):
    ours_g, ref_g = _grids(*GLOBAL_5, names=("latitude", "longitude"))
    obs = pd.DataFrame({"lat": rng.uniform(-90, 90, 400),
                        "lon": rng.uniform(-180, 180, 400),
                        "val": rng.normal(size=400)})
    # exact midpoints and repeated boxes: the stable sort keeps frame order
    obs.loc[:9, "lat"] = 2.5
    obs.loc[:9, "lon"] = -175.0
    kw = dict(sort=sort, bounds=bounds)
    ours = tgrid.map_to_grid(obs, ours_g, **kw)
    ref = jgrid.map_to_grid(obs, ref_g, **kw)
    pd.testing.assert_frame_equal(ours, ref)
    if sort:
        assert (np.diff(ours["grid_idx"].to_numpy()) >= 0).all()
    if sort and bounds is None:
        box = ours[ours["grid_idx"] == (92 // 5 * 72 + 0)]
        np.testing.assert_array_equal(box["val"].to_numpy()[:10],
                                      obs["val"].to_numpy()[:10])


def test_map_to_grid_options():
    ours_g, ref_g = _grids(1, [(1, 21), (1, 21)])
    obs = pd.DataFrame({"y": [5.0, 15.0, 10.0], "x": [5.0, 10.0, 15.0],
                        "val": [1.0, 0.0, 1.0]})
    kw = dict(obs_coords=["y", "x"], grid_coords=["lat", "lon"],
              add_grid_pts=False, grid_prefix="g_")
    ours = tgrid.map_to_grid(obs, ours_g, **kw)
    pd.testing.assert_frame_equal(ours, jgrid.map_to_grid(obs, ref_g, **kw))
    assert list(ours["g_idx"]) == sorted([84, 289, 194])


def test_assign_to_grid(rng):
    ours_g, ref_g = _grids(1, [(1, 21), (1, 21)])
    idx = rng.choice(400, 37, replace=False)
    vals = rng.normal(size=37)
    ref = jgrid.assign_to_grid(vals, idx, ref_g)
    _same_array(tgrid.assign_to_grid(vals, idx, ours_g), ref)
    # a result on its device is brought to the host
    _same_array(tgrid.assign_to_grid(torch.as_tensor(vals),
                                     torch.as_tensor(idx), ours_g), ref)
    _same_array(tgrid.assign_to_grid(vals, idx, ours_g, fill_value=-1.0),
                jgrid.assign_to_grid(vals, idx, ref_g, fill_value=-1.0))


def test_cross_coords():
    ours_g, ref_g = _grids(1, [(0, 3), (4, 6)])
    ours = tgrid.cross_coords(ours_g.coords, "lat", "lon")
    ref = jgrid.cross_coords(ref_g.coords, "lat", "lon")
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert tgrid.cross_coords(ours_g, "lat", "lon").dims == ours.dims
    with pytest.raises(KeyError, match="latitude"):
        tgrid.cross_coords(ours_g.coords, "latitude", "lon")
    with pytest.raises(KeyError, match="longitude"):
        tgrid.cross_coords(ours_g.coords, "lat", "longitude")
    three = tlab.Coordinates({"a": [0], "b": [1], "c": [2]})
    with pytest.raises(ValueError, match="2 indexes"):
        tgrid.cross_coords(three, "a", "b")


@pytest.mark.parametrize("resolution,bounds", [
    GLOBAL_5, (30, [(-75, 90), (-165, 180)])])
def test_grid_to_distance_matrix(resolution, bounds):
    ours_g, ref_g = _grids(resolution, bounds, ("latitude", "longitude"))
    kw = dict(lat_coord="latitude", lon_coord="longitude")
    ours = tgrid.grid_to_distance_matrix(ours_g, device="cpu", **kw)
    ref = jgrid.grid_to_distance_matrix(ref_g, **kw)
    assert isinstance(ours.values, torch.Tensor)
    assert ours.values.dtype == torch.float64 and ours.name == ref.name
    assert ours.dims == ref.dims == ("index_1", "index_2")
    # the port's haversine bound (tests/test_torch_device.py); the
    # near-antipodal arcsin is where the two differ most
    np.testing.assert_allclose(ours.values.numpy(), np.asarray(ref.values),
                               rtol=1e-8, atol=1e-10)
    assert set(ours.attrs["crossed_coords"]) == \
        set(ref.attrs["crossed_coords"])
    for k, v in ref.attrs["crossed_coords"].items():
        np.testing.assert_array_equal(ours.attrs["crossed_coords"][k], v)


def test_grid_to_distance_matrix_other_functions():
    from glomargridding_tpu.ops import distances as jdist
    from glomargridding_tpu_torch.ops import distances as tdist

    ours_g, ref_g = _grids(30, [(-75, 90), (-165, 180)])
    ours = tgrid.grid_to_distance_matrix(
        ours_g, dist_func=tdist.euclidean_distance, device="cpu",
        radius=1.0)
    ref = jgrid.grid_to_distance_matrix(
        ref_g, dist_func=jdist.euclidean_distance, radius=1.0)
    assert ours.values.device.type == "cpu"
    np.testing.assert_allclose(ours.values.numpy(), np.asarray(ref.values),
                               rtol=1e-12, atol=1e-14)


# --- masks ------------------------------------------------------------
def _mask(module):
    coords = module.Coordinates({"latitude": np.array([0.0, 1.0, 2.0]),
                                 "longitude": np.array([0.0, 1.0])})
    vals = np.array([[True, False], [False, True], [False, False]])
    return module.DataArray(vals, coords, name="mask")


def _obs(rng, n=40):
    return pd.DataFrame({"lat": rng.uniform(-0.4, 2.4, n),
                         "lon": rng.uniform(-0.4, 1.4, n),
                         "sst": rng.normal(size=n),
                         "day": rng.integers(0, 3, n)})


@pytest.mark.parametrize("kw", [
    {}, {"drop": True}, {"align_to_mask": True}, {"masked_value": -9.0},
    {"mask_value": False}, {"varnames": ["sst", "day"]},
])
def test_mask_observations(rng, kw):
    obs = _obs(rng)
    kw = {"varnames": "sst", **kw}
    pd.testing.assert_frame_equal(
        tmask.mask_observations(obs, _mask(tlab), **kw),
        jmask.mask_observations(obs, _mask(jlab), **kw))


def test_mask_observations_warns_on_an_existing_column(rng):
    obs = _obs(rng).assign(_mask_grid_idx=0)
    with pytest.warns(UserWarning, match="will be overwritten"):
        tmask.mask_observations(obs, _mask(tlab), "sst")


@pytest.mark.parametrize("values", ["numpy", "tensor"])
def test_mask_array_and_dataset(rng, values):
    data = rng.normal(size=(3, 2))

    def grid(module, wrap=np.asarray):
        return module.DataArray(wrap(data.copy()), _mask(module).coords)

    wrap = torch.as_tensor if values == "tensor" else np.asarray
    ours = tmask.mask_array(grid(tlab, wrap), _mask(tlab))
    ref = jmask.mask_array(grid(jlab), _mask(jlab))
    np.testing.assert_array_equal(np.asarray(ours), ref.values)
    ds_t = tlab.Dataset({"sst": grid(tlab, wrap), "t": grid(tlab, wrap)},
                        _mask(tlab).coords)
    ds_j = jlab.Dataset({"sst": grid(jlab), "t": grid(jlab)},
                        _mask(jlab).coords)
    ours = tmask.mask_dataset(ds_t, _mask(tlab), ["sst"], masked_value=0.0)
    ref = jmask.mask_dataset(ds_j, _mask(jlab), ["sst"], masked_value=0.0)
    for k in ("sst", "t"):
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k].values)
    with pytest.raises(TypeError):
        tmask.mask_array(np.zeros((3, 2)), _mask(tlab))
    with pytest.raises(TypeError):
        tmask.mask_dataset(np.zeros((3, 2)), _mask(tlab), "sst")
    bad = tlab.DataArray(np.zeros((3, 2)), {"latitude": [5.0, 6.0, 7.0],
                                            "longitude": [0.0, 1.0]})
    with pytest.raises(ValueError):
        tmask.mask_array(bad, _mask(tlab))


@pytest.mark.parametrize("with_grid", [True, False])
def test_mask_from_obs_frame(rng, with_grid):
    obs = _obs(rng, 12).rename(columns={"day": "datetime"})
    if with_grid:
        ours_g, ref_g = _grids(1, [(0, 3), (0, 2)])
        args_t = (obs, ["lat", "lon"], "sst", "datetime", ours_g,
                  ["lat", "lon"])
        args_j = (obs, ["lat", "lon"], "sst", "datetime", ref_g,
                  ["lat", "lon"])
    else:
        obs = obs.assign(lat=np.round(obs["lat"]), lon=np.round(obs["lon"]))
        obs.loc[0, "sst"] = np.nan
        args_t = args_j = (obs.drop(columns="datetime"), "lat", "sst")
    pd.testing.assert_frame_equal(tmask.mask_from_obs_frame(*args_t),
                                  jmask.mask_from_obs_frame(*args_j))
    with pytest.raises(ValueError, match="grid_coords"):
        tmask.mask_from_obs_frame(obs, "lat", "sst", grid=object())


def test_mask_from_obs_array_and_get_mask_idx(rng):
    data = rng.random((3, 3, 2))
    data[:, 0, 0] = np.nan
    data[0, 1, 1] = np.nan
    np.testing.assert_array_equal(tmask.mask_from_obs_array(data, 0),
                                  jmask.mask_from_obs_array(data, 0))
    coords = {"t": [0, 1, 2], "latitude": [0.0, 1.0, 2.0],
              "longitude": [0.0, 1.0]}
    ours = tmask.mask_from_obs_array(tlab.DataArray(data, coords), 0)
    ref = jmask.mask_from_obs_array(jlab.DataArray(data, coords), 0)
    _same_array(ours, ref)
    for kw in ({"mask_val": True}, {"mask_val": True, "masked": False},
               {}):
        src = (_mask(tlab), _mask(jlab)) if kw else (data[0], data[0])
        np.testing.assert_array_equal(tmask.get_mask_idx(src[0], **kw),
                                      jmask.get_mask_idx(src[1], **kw))
    np.testing.assert_array_equal(
        tmask.get_mask_idx(torch.as_tensor(data[0])),
        jmask.get_mask_idx(data[0]))


# --- climatology ------------------------------------------------------
def _climatology(module, doy_dates=False):
    doy_axis = (np.arange("2009-01-01", "2010-01-01", dtype="datetime64[D]")
                if doy_dates else np.arange(1, 366))
    coords = module.Coordinates({"doy": doy_axis,
                                 "latitude": np.array([0.0, 10.0]),
                                 "longitude": np.array([0.0, 10.0])})
    doy, lat, lon = np.meshgrid(np.arange(1, 366), np.array([0.0, 10.0]),
                                np.array([0.0, 10.0]), indexing="ij")
    arr = module.DataArray(273.15 + doy + lat / 100.0 + lon / 1000.0,
                           coords, name="climatology")
    return module.Dataset({"climatology": arr}, coords)


@pytest.mark.parametrize("doy_dates", [False, True])
@pytest.mark.parametrize("kelvin", [True, False])
def test_join_climatology_by_doy(rng, doy_dates, kelvin):
    n = 30
    days = pd.to_datetime("2007-12-20") + pd.to_timedelta(
        rng.integers(0, 800, n), unit="D")
    obs = pd.DataFrame({"lat": rng.uniform(-3, 13, n),
                        "lon": rng.uniform(-3, 13, n),
                        "date": days, "sst": rng.normal(15, 5, n)})
    obs.loc[0, "date"] = pd.Timestamp("2008-02-29")
    obs.loc[1, "date"] = pd.Timestamp("2008-03-01")
    kw = dict(temp_from_kelvin=kelvin)
    ours = tclim.join_climatology_by_doy(obs, _climatology(tlab, doy_dates),
                                         **kw)
    ref = jclim.join_climatology_by_doy(obs, _climatology(jlab, doy_dates),
                                        **kw)
    pd.testing.assert_frame_equal(ours, ref)
    if kelvin:
        assert ours["sst_climatology"].iloc[0] == pytest.approx(
            59.5 + np.round(obs["lat"].iloc[0], -1) / 100
            + np.round(obs["lon"].iloc[0], -1) / 1000)


def test_read_climatology(tmp_path):
    coords = jlab.Coordinates({"lat": np.arange(-80.0, 90.0, 20.0),
                               "lon": np.arange(-170.0, 180.0, 40.0)})
    data = np.arange(81.0).reshape(9, 9)
    jsave_dataset(jlab.Dataset({"clim": jlab.DataArray(data, coords)},
                               coords), str(tmp_path / "clim_03.nc"))
    kw = dict(min_lat=-45, max_lat=45, min_lon=-100, max_lon=130, month=3)
    path = str(tmp_path / "clim_{month:02d}.nc")
    ours = tclim.read_climatology(path, **kw)["clim"]
    ref = jclim.read_climatology(path, **kw)["clim"]
    _same_array(ours, ref)
