"""The port's variogram ``fit``/``covariance`` and
``variogram_to_covariance`` hand back the container they were given,
held against the JAX package on the same inputs (f64, 1e-12 of the
largest value).

- A labelled ``DataArray`` comes back a ``DataArray`` with the input's
  coords and a copy of its attrs, named "variogram" by ``fit`` and
  "covariance" by the other two, as the reference names them; the
  reference's own path, grid -> distance matrix -> variogram, included.
- An ndarray comes back an ndarray, a tensor a tensor.
"""

import numpy as np
import pytest
import torch

from glomargridding_tpu.core.labeled import DataArray as JDataArray
from glomargridding_tpu.grid import grid_from_resolution as jgrid
from glomargridding_tpu.grid import grid_to_distance_matrix as jdist
from glomargridding_tpu.ops import variogram as jvar
from glomargridding_tpu_torch.core.labeled import DataArray
from glomargridding_tpu_torch.grid import (
    grid_from_resolution,
    grid_to_distance_matrix,
)
from glomargridding_tpu_torch.ops import variogram as tvar

TOL = 1e-12
GRID = (30.0, [(-60, 60), (-180, 180)], ["lat", "lon"])
MODELS = {
    "matern": dict(psill=1.2, nugget=0.1, range=1200.0, nu=1.5),
    "exponential": dict(psill=0.8, nugget=0.05, range=900.0),
}
CALLS = ("fit", "covariance", "variogram_to_covariance")


def _call(module, model, kind, call, x):
    vario = getattr(module, f"{model.capitalize()}Variogram")(**MODELS[model])
    if call == "fit":
        return vario.fit(x)
    if call == "covariance":
        return vario.covariance(x)
    return module.variogram_to_covariance(x, 1.3)


def _values(a):
    v = a.values if hasattr(a, "coords") else a
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(ours, ref):
    ours, ref = _values(ours), _values(ref)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) <= TOL * np.max(np.abs(ref))


def test_grid_distance_variogram_returns_a_dataarray():
    """The call that raised ``Could not infer dtype of DataArray``."""
    dist = grid_to_distance_matrix(grid_from_resolution(*GRID),
                                   device="cpu")
    ours = tvar.MaternVariogram(**MODELS["matern"]).fit(dist)
    ref = jvar.MaternVariogram(**MODELS["matern"]).fit(
        jdist(jgrid(*GRID)))
    assert isinstance(ours, DataArray) and isinstance(ref, JDataArray)
    assert ours.name == ref.name == "variogram"
    assert isinstance(ours.values, torch.Tensor)
    assert ours.values.dtype == torch.float64
    assert ours.coords.dims == ref.coords.dims
    for name in ref.coords.dims:
        np.testing.assert_array_equal(np.asarray(ours.coords[name]),
                                      np.asarray(ref.coords[name]))
    assert set(ours.attrs) == set(ref.attrs) == {"crossed_coords"}
    _close(ours, ref)


def _container(kind, d, coords, attrs):
    """The distances `d` as a container of `kind`."""
    if kind == "dataarray":
        return DataArray(d.copy(), coords, name="dist", attrs=attrs)
    if kind == "dataarray_tensor":
        return DataArray(torch.from_numpy(d.copy()), coords, name="dist",
                         attrs=attrs)
    if kind == "ndarray":
        return d.copy()
    return torch.from_numpy(d.copy())


def _check_labelled(ours, ref, x, kind, call, attrs):
    """A DataArray in, a DataArray out: named, labelled, attrs copied."""
    assert isinstance(ours, DataArray)
    assert ours.name == ref.name
    assert ours.name == ("variogram" if call == "fit" else "covariance")
    assert ours.coords.dims == ("index_1", "index_2")
    assert ours.attrs == attrs and ours.attrs is not x.attrs
    assert isinstance(ours.values, torch.Tensor) == (
        kind == "dataarray_tensor")
    assert x.name == "dist"


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["dataarray", "dataarray_tensor",
                                  "ndarray", "tensor"])
def test_container_in_is_container_out(rng, kind, model, call):
    d = rng.uniform(0.0, 4000.0, size=(7, 9))
    d[0, 0] = 0.0
    coords = {"index_1": np.arange(7), "index_2": np.arange(9)}
    attrs = {"units": "km"}
    x = _container(kind, d, coords, attrs)
    ref = _call(jvar, model, kind, call,
                JDataArray(d.copy(), coords, name="dist", attrs=attrs)
                if kind.startswith("dataarray") else d.copy())
    ours = _call(tvar, model, kind, call, x)
    _close(ours, ref)
    if kind.startswith("dataarray"):
        _check_labelled(ours, ref, x, kind, call, attrs)
    elif kind == "ndarray":
        assert isinstance(ours, np.ndarray)
    else:
        assert isinstance(ours, torch.Tensor)
