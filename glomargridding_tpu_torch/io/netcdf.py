"""netCDF4 reading/writing over raw HDF5 (h5py).

Port of ``glomargridding_tpu/io/netcdf.py:21-281``. netCDF4 files are
HDF5 files following the dimension-scale convention; this module reads
and writes them directly with h5py, which is imported inside the
functions that touch a file. It covers the subset of netCDF that
gridding workflows use: N-d float/int variables over named 1-d dimension
coordinates, CF attribute decoding (``_FillValue``/``missing_value`` ->
NaN, ``scale_factor``/``add_offset``), and format-string path templating
for monthly products. Values come back as numpy on the host; the writer
brings tensors on any device to the host first.
"""

import os

import numpy as np

from ..core.labeled import Coordinates, DataArray, Dataset, _host

_NC_DIM_PREFIX = "This is a netCDF dimension but not a netCDF variable"


def _resolve_path(path: str, **kwargs) -> str:
    """Resolve a literal path or a str.format template with kwargs."""
    if os.path.isfile(path):
        return path
    if kwargs:
        dirname = os.path.dirname(path) or "."
        filename = path.format(**kwargs)
        if not os.path.isdir(dirname):
            raise FileNotFoundError(f"Array path: {path} not found")
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"Array file: {filename} not found")
        return filename
    raise FileNotFoundError("Cannot determine filename")


def _decode_attr(val):
    if isinstance(val, bytes):
        return val.decode("utf-8", errors="replace")
    if isinstance(val, np.ndarray) and val.size == 1:
        return _decode_attr(val.reshape(-1)[0])
    if isinstance(val, np.generic):
        return val.item() if not isinstance(val, np.bytes_) else _decode_attr(
            bytes(val)
        )
    return val


def _is_phony_dim(ds) -> bool:
    name_attr = ds.attrs.get("NAME")
    if name_attr is None:
        return False
    if isinstance(name_attr, (bytes, np.bytes_)):
        return bytes(name_attr).startswith(_NC_DIM_PREFIX.encode())
    return str(name_attr).startswith(_NC_DIM_PREFIX)


def _var_dims(f, ds) -> tuple[str, ...]:
    """Dimension names of a variable via its DIMENSION_LIST references."""
    dims = []
    dim_list = ds.attrs.get("DIMENSION_LIST")
    if dim_list is not None:
        for axis_refs in dim_list:
            refs = list(axis_refs) if np.iterable(axis_refs) else [axis_refs]
            if refs:
                target = f[refs[0]]
                dims.append(target.name.split("/")[-1])
            else:
                dims.append(f"dim_{len(dims)}")
    else:
        dims = [f"dim_{i}" for i in range(ds.ndim)]
    return tuple(dims)


def _scalar_attr(val):
    return np.asarray(val).reshape(-1)[0]


def _decode_values(ds) -> np.ndarray:  # noqa: C901
    """CF-decode a variable's raw values.

    netCDF semantics (CF conventions 2.5.1 / NUG): ``_FillValue`` matches
    by EXACT equality, never a tolerance, which would NaN legitimate data
    near the fill; ``_FillValue`` / ``missing_value`` / ``valid_range``
    / ``valid_min`` / ``valid_max`` are all expressed in the PACKED (raw)
    domain, so masks are computed before ``scale_factor``/``add_offset``
    are applied. ``_Unsigned = "true"`` reinterprets classic-model signed
    storage as the unsigned type of the same width.
    """
    data = ds[()]
    if data.dtype.kind in "SU":
        return data
    attrs = ds.attrs

    unsigned = attrs.get("_Unsigned")
    if (
        unsigned is not None
        and str(_decode_attr(unsigned)).lower() == "true"
        and data.dtype.kind == "i"
    ):
        data = data.view(np.dtype(f"u{data.dtype.itemsize}"))

    fill = attrs.get("_FillValue", attrs.get("missing_value"))
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    valid_min = attrs.get("valid_min")
    valid_max = attrs.get("valid_max")
    valid_range = attrs.get("valid_range")
    if valid_range is not None:
        vr = np.asarray(valid_range).reshape(-1)
        valid_min, valid_max = vr[0], vr[-1]

    mask = np.zeros(data.shape, dtype=bool)
    if fill is not None:
        fv = _scalar_attr(fill)
        if data.dtype.kind == "f" and np.isnan(fv):
            mask |= np.isnan(data)
        else:
            mask |= data == fv
    if valid_min is not None:
        mask |= data < _scalar_attr(valid_min)
    if valid_max is not None:
        mask |= data > _scalar_attr(valid_max)

    has_mask = bool(mask.any())
    if not (has_mask or scale is not None or offset is not None):
        return data

    if data.dtype.kind in "iu":
        data = data.astype(np.float64)
    else:
        data = np.array(data, copy=True)
    if scale is not None:
        data = data * _scalar_attr(scale)
    if offset is not None:
        data = data + _scalar_attr(offset)
    if has_mask:
        data[mask] = np.nan
    return data


def open_dataset(path: str) -> Dataset:
    """Read a netCDF4 (HDF5) file into a Dataset.

    1-d dimension-scale datasets become coordinates; everything else becomes
    a variable with named dims.
    """
    import h5py

    with h5py.File(path, "r") as f:
        coords: dict[str, np.ndarray] = {}
        variables: dict[str, tuple[tuple[str, ...], np.ndarray, dict]] = {}

        def visit(name: str, obj) -> None:
            if not isinstance(obj, h5py.Dataset):
                return
            short = name.split("/")[-1]
            cls = obj.attrs.get("CLASS")
            is_scale = cls is not None and bytes(cls) == b"DIMENSION_SCALE"
            if is_scale:
                if _is_phony_dim(obj):
                    return  # anonymous dimension, no coordinate values
                coords[short] = _decode_values(obj)
                return
            attrs = {
                k: _decode_attr(v)
                for k, v in obj.attrs.items()
                if not k.startswith("_Netcdf4")
                and k not in (
                    "DIMENSION_LIST", "CLASS", "NAME",
                    "REFERENCE_LIST",
                )
            }
            variables[short] = (_var_dims(f, obj), _decode_values(obj), attrs)

        f.visititems(visit)
        global_attrs = {
            k: _decode_attr(v)
            for k, v in f.attrs.items()
            if not k.startswith("_NC")
        }

    ds_coords = Coordinates(coords)
    out_vars: dict[str, DataArray] = {}
    for vname, (dims, values, attrs) in variables.items():
        var_coords = Coordinates(
            {
                d: coords.get(d, np.arange(values.shape[i]))
                for i, d in enumerate(dims)
            }
        )
        out_vars[vname] = DataArray(
            values, var_coords, name=vname, attrs=attrs, dims=dims
        )
    return Dataset(out_vars, ds_coords, attrs=global_attrs)


def load_dataset(path: str, **kwargs) -> Dataset:
    """Load a Dataset, resolving format-string paths with kwargs.

    e.g. ``load_dataset("/data/cov_{month:02d}.nc", month=3)``.
    """
    return open_dataset(_resolve_path(path, **kwargs))


def load_array(path: str, var: str = "covariance", **kwargs) -> DataArray:
    """Load a single variable from a netCDF file (format-string path)."""
    return load_dataset(path, **kwargs)[var]


def save_dataset(ds: Dataset, path: str, mode: str = "w") -> None:
    """Write a Dataset to a netCDF4-compatible HDF5 file.

    Dimension coordinates are written as HDF5 dimension scales so standard
    netCDF4 readers see proper named dimensions. Variables may hold
    tensors on any device; they are written from the host.
    """
    import h5py

    with h5py.File(path, mode) as f:
        written_dims: dict = {}

        def ensure_dim(name: str, values):
            if name in written_dims:
                return written_dims[name]
            d = f.create_dataset(name, data=_host(values))
            d.make_scale(name)
            written_dims[name] = d
            return d

        for cname, cvals in ds.coords.items():
            ensure_dim(cname, cvals)
        for vname, var in ds.items():
            if vname in written_dims:
                continue
            v = f.create_dataset(vname, data=_host(var.values))
            for i, dname in enumerate(var.dims):
                if dname in var.coords:
                    scale = ensure_dim(dname, var.coords[dname])
                    v.dims[i].attach_scale(scale)
            for k, val in var.attrs.items():
                try:
                    v.attrs[k] = val
                except TypeError:
                    v.attrs[k] = str(val)
        for k, val in ds.attrs.items():
            try:
                f.attrs[k] = val
            except TypeError:
                f.attrs[k] = str(val)


def add_empty_layers(
    path: str,
    variables: list[str] | str,
    timestamps: list[int] | int,
    shape: tuple[int, int],
) -> None:
    """Zero-fill time layers of variables in an existing netCDF file, for
    the precompute-and-persist workflow of writing monthly layers one at a
    time."""
    import h5py

    variables = [variables] if isinstance(variables, str) else list(variables)
    timestamps = (
        [timestamps] if isinstance(timestamps, int) else list(timestamps)
    )
    empty = np.zeros(shape, dtype=np.float32)
    with h5py.File(path, "a") as f:
        for vname in variables:
            v = f[vname]
            for t in timestamps:
                v[t, :, :] = empty


def to_xarray(ds: Dataset):
    """Convert to an xarray.Dataset if xarray is installed (optional)."""
    try:
        import xarray as xr
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError("xarray is not available in this environment") from e
    data_vars = {
        k: (list(v.dims), _host(v.values), v.attrs) for k, v in ds.items()
    }
    coords = {k: np.asarray(v) for k, v in ds.coords.items()}
    return xr.Dataset(data_vars=data_vars, coords=coords, attrs=ds.attrs)
