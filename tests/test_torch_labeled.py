"""The port's labeled containers against the JAX package's
(``core/labeled.py``) on the same numpy inputs: the same dims, shapes,
selections and frames, exactly. A tensor may stand in for ``values``.
"""

import numpy as np
import pytest
import torch

from glomargridding_tpu.core import labeled as jlab
from glomargridding_tpu_torch.core import labeled as tlab

LAT = np.array([-10.0, 0.0, 10.0])
LON = np.array([100.0, 110.0, 120.0, 130.0])


def _pair(module, values=None):
    coords = module.Coordinates({"lat": LAT, "lon": LON})
    data = np.arange(12.0).reshape(3, 4) if values is None else values
    return coords, module.DataArray(data, coords, name="sst",
                                    attrs={"units": "K"})


def test_coordinates_behave_like_the_reference():
    ours, _ = _pair(tlab)
    ref, _ = _pair(jlab)
    assert ours.dims == ref.dims == ("lat", "lon")
    assert ours.shape == ref.shape == (3, 4)
    assert list(ours.keys()) == list(ref.keys()) and len(ours) == 2
    assert "lat" in ours and "time" not in ours
    assert repr(ours) == repr(ref)
    assert ours.equals(tlab.Coordinates({"lat": LAT, "lon": LON}))
    assert not ours.equals(tlab.Coordinates({"lon": LON, "lat": LAT}))
    assert not ours.equals(tlab.Coordinates({"lat": LAT, "lon": LON + 1}))
    assert ours.to_index().equals(ref.to_index())


def test_data_array_properties_and_copy():
    _, ours = _pair(tlab)
    _, ref = _pair(jlab)
    for name in ("dims", "shape", "size", "name", "attrs"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    dup = ours.copy()
    dup.values[0, 0] = -1.0
    dup.attrs["units"] = "degC"
    assert ours.values[0, 0] == 0.0 and ours.attrs == {"units": "K"}
    empty = tlab.DataArray(coords={"lat": LAT, "lon": LON})
    assert empty.shape == (3, 4) and np.isnan(empty.values).all()
    with pytest.raises(ValueError, match="does not match coords"):
        tlab.DataArray(np.zeros((4, 3)), {"lat": LAT, "lon": LON})


@pytest.mark.parametrize("bounds,dims", [
    ([(-5, 10), (105, 125)], ["lat", "lon"]),
    ([(110, 130)], ["lon"]),
    ([(50, 60)], ["lat"]),
])
def test_selection_by_bounds(bounds, dims):
    _, ours = _pair(tlab)
    _, ref = _pair(jlab)
    got, want = ours.sel_bounds(bounds, dims), ref.sel_bounds(bounds, dims)
    np.testing.assert_array_equal(got.values, want.values)
    for d in got.dims:
        np.testing.assert_array_equal(got.coords[d], want.coords[d])
    np.testing.assert_array_equal(
        tlab.select_bounds(ours, bounds, dims).values, want.values)


def test_to_dataframe_matches():
    _, ours = _pair(tlab)
    _, ref = _pair(jlab)
    assert ours.to_dataframe().equals(ref.to_dataframe())
    assert list(ours.to_dataframe("t").columns) == ["lat", "lon", "t"]


def test_tensor_values_stay_tensors():
    """A tensor is kept as it is (on its device); the host views, the
    selections and the frame read it as numpy."""
    values = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    _, ours = _pair(tlab, values)
    _, ref = _pair(jlab, values.numpy())
    assert ours.values is values and ours.shape == (3, 4)
    assert ours.size == 12 and ours.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(ours), ref.values)
    np.testing.assert_array_equal(
        ours.sel_bounds([(0, 10)], ["lat"]).values,
        ref.sel_bounds([(0, 10)], ["lat"]).values)
    assert ours.to_dataframe().equals(ref.to_dataframe())
    dup = ours.copy()
    dup.values[0, 0] = 5.0
    assert values[0, 0] == 0.0


def test_dataset_mapping_and_selection():
    def build(module):
        coords, arr = _pair(module)
        ds = module.Dataset({"sst": arr}, coords, attrs={"source": "test"})
        ds["ice"] = np.ones((3, 4))
        return ds

    ours, ref = build(tlab), build(jlab)
    assert list(ours) == list(ref) == ["sst", "ice"]
    assert "ice" in ours and "wind" not in ours
    assert list(ours.keys()) == list(ours.data_vars) == ["sst", "ice"]
    assert isinstance(ours["ice"], tlab.DataArray)
    assert ours["ice"].name == "ice" and repr(ours) == repr(ref)
    got = ours.sel_bounds([(0, 10)], ["lat"])
    want = ref.sel_bounds([(0, 10)], ["lat"])
    for name, arr in got.items():
        np.testing.assert_array_equal(arr.values, want[name].values)
    assert got.coords.shape == want.coords.shape == (2, 4)
    assert got.attrs == {"source": "test"}
    assert tlab.Dataset().sel_bounds([(0, 1)], ["lat"]).coords.shape == ()


def test_align_exact():
    _, a = _pair(tlab)
    _, b = _pair(tlab)
    tlab.align_exact(a, b)
    _, ref = _pair(jlab)
    tlab.align_exact(a, ref)  # duck-typed through .coords
    with pytest.raises(ValueError, match="'lon' does not align"):
        tlab.align_exact(a, tlab.DataArray(
            np.zeros((3, 4)), {"lat": LAT, "lon": LON + 0.5}))
    with pytest.raises(ValueError, match="Dims do not align"):
        tlab.align_exact(a, tlab.DataArray(np.zeros((4, 3)),
                                           {"lon": LON, "lat": LAT}))
