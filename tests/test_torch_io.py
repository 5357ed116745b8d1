"""The port's netCDF ``io`` against the JAX package's (mirrors
``tests/test_io.py``): the same files decode to the same values, dims,
coordinates and attributes, and a file written by either package is read
by the other, with ``_FillValue``, ``scale_factor``/``add_offset``,
string attributes and dimension scales. Exact throughout.
"""

import h5py
import numpy as np
import pytest
import torch

from glomargridding_tpu import io as jio
from glomargridding_tpu.core import labeled as jlab
from glomargridding_tpu.ops import covariance_tools as jct
from glomargridding_tpu_torch import io as tio
from glomargridding_tpu_torch.core import labeled as tlab
from glomargridding_tpu_torch.ops import covariance_tools as tct

from conftest import reference_data_path

EXAMPLES = reference_data_path("../../examples/data")
VENDORED = [
    reference_data_path("Atlantic_Ocean_07.nc"),
    reference_data_path("cov_no_hfix.nc"),
    f"{EXAMPLES}/esa_cci_sst_5deg_monthly_1982-2022_03.nc",
    f"{EXAMPLES}/HadSST.4.0.1.0_ensemble_member_71_2014_03.nc",
    f"{EXAMPLES}/HadCRUT.5.0.2.0.uncorrelated_1876_03.nc",
]


def _same_attrs(ours, ref):
    assert list(ours) == list(ref)
    for k, v in ref.items():  # NaN fills compare equal
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
        assert type(ours[k]) is type(v), k


def _same_dataset(ours, ref):
    assert list(ours.keys()) == list(ref.keys())
    assert list(ours.coords) == list(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(ours.coords[k], ref.coords[k])
    _same_attrs(ours.attrs, ref.attrs)
    for k in ref.keys():
        o, r = ours[k], ref[k]
        assert o.dims == r.dims and o.name == r.name
        _same_attrs(o.attrs, r.attrs)
        assert np.asarray(o.values).dtype == np.asarray(r.values).dtype
        np.testing.assert_array_equal(np.asarray(o.values),
                                      np.asarray(r.values))
        for c in r.coords:
            np.testing.assert_array_equal(o.coords[c], r.coords[c])


@pytest.mark.parametrize("path", VENDORED)
def test_vendored_files_decode_alike(path):
    _same_dataset(tio.open_dataset(path), jio.open_dataset(path))


def _write_cf_file(path):
    """A file the way netCDF tools write one: dimension scales, packed
    ints with fill and valid range, a NaN fill, string attributes."""
    with h5py.File(path, "w") as f:
        lat = f.create_dataset("lat", data=np.array([-10.0, 0.0, 10.0]))
        lat.make_scale("lat")
        lat.attrs["units"] = b"degrees_north"
        t = f.create_dataset("time", data=np.arange(2, dtype=np.int64))
        t.make_scale("time")
        raw = np.array([[-32768, -32767, 0], [20000, 32000, 5]], np.int16)
        sst = f.create_dataset("sst", data=raw)
        sst.dims[0].attach_scale(t)
        sst.dims[1].attach_scale(lat)
        sst.attrs["_FillValue"] = np.int16(-32768)
        sst.attrs["valid_range"] = np.array([-32767, 30000], np.int16)
        sst.attrs["scale_factor"] = np.float64(0.01)
        sst.attrs["add_offset"] = np.float64(273.15)
        sst.attrs["long_name"] = "sea surface temperature"
        sst.attrs["comment"] = np.bytes_(b"packed")
        x = f.create_dataset("x", data=np.array([[np.nan, 2.0, 1.0]] * 2,
                                                np.float32))
        x.dims[0].attach_scale(t)
        x.dims[1].attach_scale(lat)
        x.attrs["_FillValue"] = np.float32(np.nan)
        x.attrs["missing_value"] = np.float32(1.0)
        u = f.create_dataset("counts", data=np.array([-1, 5], np.int8))
        u.attrs["_Unsigned"] = b"true"
        near = f.create_dataset("near", data=np.array([-999.0, -998.995]))
        near.attrs["_FillValue"] = np.float64(-999.0)
        f.attrs["title"] = "cf test"
        f.attrs["_NCProperties"] = "hidden"


def test_cf_decoding(tmp_path):
    path = str(tmp_path / "cf.nc")
    _write_cf_file(path)
    ours = tio.open_dataset(path)
    _same_dataset(ours, jio.open_dataset(path))
    sst = ours["sst"].values
    assert np.isnan(sst[0, 0]) and np.isnan(sst[1, 1])
    np.testing.assert_allclose(sst[0, 1], 273.15 - 327.67)
    assert ours["sst"].dims == ("time", "lat")
    assert ours["sst"].attrs["comment"] == "packed"
    assert ours["counts"].values.tolist() == [255, 5]
    assert ours["near"].values[1] == -998.995
    assert ours.attrs == {"title": "cf test"}


def _dataset(module, rng, values=None):
    coords = module.Coordinates({"lat": np.arange(-80.0, 90.0, 20.0),
                                 "lon": np.arange(0.0, 360.0, 40.0)})
    data = rng.random(coords.shape) if values is None else values
    sst = module.DataArray(data, coords, name="sst",
                           attrs={"units": "K", "scale": 2.5,
                                  "flags": [1, 2]})
    cnt = module.DataArray(np.arange(9, dtype=np.int32),
                           module.Coordinates({"lon": coords["lon"]}),
                           name="count", dims=("lon",))
    return module.Dataset({"sst": sst, "count": cnt}, coords,
                          attrs={"title": "test", "month": 3})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_between_the_packages(tmp_path, rng, writer):
    path = str(tmp_path / "cross.nc")
    data = rng.random((9, 9))
    if writer == "port":
        tio.save_dataset(_dataset(tlab, rng, torch.as_tensor(data)), path)
    else:
        jio.save_dataset(_dataset(jlab, rng, data), path)
    ours, ref = tio.open_dataset(path), jio.open_dataset(path)
    _same_dataset(ours, ref)
    np.testing.assert_array_equal(ours["sst"].values, data)
    assert ours["sst"].dims == ("lat", "lon")
    assert ours["count"].dims == ("lon",)
    assert ours["sst"].attrs["units"] == "K"
    assert ours.attrs["title"] == "test"
    with h5py.File(path) as f:  # real dimension scales
        assert h5py.h5ds.is_scale(f["lat"].id)
        assert f["sst"].dims[1][0].name == "/lon"


def test_cf_encoded_file_written_by_hand_then_rewritten(tmp_path):
    """A CF file decodes in the port and is written back by the port; the
    JAX reader reads the rewritten file as the port does, with the decoded
    values where no packing attribute travels with them (both packages
    keep ``scale_factor``/``add_offset`` among a variable's attributes, so
    a decoded packed variable written back is scaled again on reading; an
    anonymous dimension comes back as a numbered scale)."""
    src = str(tmp_path / "cf.nc")
    _write_cf_file(src)
    out = str(tmp_path / "rewritten.nc")
    decoded = tio.open_dataset(src)
    tio.save_dataset(decoded, out)
    back = jio.open_dataset(out)
    _same_dataset(tio.open_dataset(out), back)
    for k in ("x", "counts", "near"):
        np.testing.assert_array_equal(back[k].values, decoded[k].values)
    assert back["counts"].dims == ("dim_0",)
    assert back["sst"].attrs["long_name"] == "sea surface temperature"


def test_format_string_paths_and_covariances(tmp_path, rng):
    cov = rng.normal(size=(5, 4))
    tio.save_covariance(torch.as_tensor(cov), str(tmp_path / "cov_{m:02d}.nc"),
                        m=3)
    for reader in (tio.load_covariance, jio.load_covariance):
        np.testing.assert_array_equal(
            reader(str(tmp_path / "cov_{month:02d}.nc"), month=3), cov)
    jio.save_covariance(cov, str(tmp_path / "jcov.nc"), "c")
    np.testing.assert_array_equal(
        tio.load_covariance(str(tmp_path / "jcov.nc"), "c"), cov)
    with pytest.raises(FileNotFoundError, match="not found"):
        tio.load_dataset(str(tmp_path / "missing_{month:02d}.nc"), month=4)
    with pytest.raises(FileNotFoundError, match="not found"):
        tio.load_dataset(str(tmp_path / "nodir" / "x_{m}.nc"), m=1)
    with pytest.raises(FileNotFoundError, match="Cannot determine"):
        tio.load_dataset(str(tmp_path / "nope.nc"))
    arr = tio.load_array(str(tmp_path / "cov_03.nc"))
    assert arr.dims == ("index_1", "index_2")


def test_add_empty_layers(tmp_path, rng):
    data = rng.random((4, 3, 2))
    coords = {"t": np.arange(4), "y": np.arange(3.0), "x": np.arange(2.0)}
    for name, io, lab in (("port", tio, tlab), ("jax", jio, jlab)):
        path = str(tmp_path / f"{name}.nc")
        io.save_dataset(lab.Dataset({"a": lab.DataArray(data, coords),
                                     "b": lab.DataArray(data, coords)},
                                    coords), path)
        io.add_empty_layers(path, "a", [1, 3], (3, 2))
        io.add_empty_layers(path, ["b"], 0, (3, 2))
    for var in ("a", "b"):
        np.testing.assert_array_equal(
            tio.load_array(str(tmp_path / "jax.nc"), var).values,
            jio.load_array(str(tmp_path / "port.nc"), var).values)
    got = tio.load_array(str(tmp_path / "port.nc"), "a").values
    assert (got[[1, 3]] == 0).all() and (got[[0, 2]] == data[[0, 2]]).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lowrank_roundtrip(tmp_path, rng, writer, dtype):
    import jax.numpy as jnp

    n, r = 60, 5
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    parts = (Q.astype(dtype), np.linspace(4.0, 1.0, r).astype(dtype),
             rng.uniform(0.05, 0.2, n).astype(dtype))
    path = str(tmp_path / "psd_{month:02d}.nc")
    if writer == "port":
        tio.save_lowrank(tct.LowRankPSD(*map(torch.as_tensor, parts)), path,
                         month=3)
    else:
        jio.save_lowrank(jct.LowRankPSD(*map(jnp.asarray, parts)), path,
                         month=3)
    ours = tio.load_lowrank(path, device="cpu", month=3)
    ref = jio.load_lowrank(path, month=3)
    for name, want in zip(("vectors", "gains", "floor"), parts):
        got = getattr(ours, name)
        assert got.device.type == "cpu" and got.numpy().dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(ours.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=1e-5)


def test_io_exports_match_the_reference():
    assert set(jio.__all__) == set(tio.__all__)


def test_to_xarray_is_optional(rng):
    from glomargridding_tpu_torch.io import netcdf

    try:
        import xarray  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="xarray"):
            netcdf.to_xarray(_dataset(tlab, rng))
    else:
        xr_ds = netcdf.to_xarray(_dataset(tlab, rng))
        assert set(xr_ds.data_vars) == {"sst", "count"}
