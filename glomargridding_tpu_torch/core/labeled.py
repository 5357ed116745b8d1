"""Minimal labeled-array containers.

Port of ``glomargridding_tpu/core/labeled.py``: a small stand-in for
``xarray.DataArray``/``Dataset`` (grids, masks, distance matrices and
ellipse parameter fields) covering the subset of behaviour the framework
needs:

- named dimension coordinates (1-d, ordered),
- `.values`, `.shape`, `.dims`, `.coords`,
- label-based bound selection (`select_bounds`, like ``.sel(slice)``),
- exact-alignment checks,
- conversion to a flat pandas DataFrame (pandas is imported inside the
  two functions that build one).

Coordinates are numpy on the host. A ``DataArray``'s ``values`` is numpy,
or a tensor, which stays on its device (``__array__`` and the selections
bring it to the host). Helpers accept xarray objects wherever a DataArray
is accepted (duck-typed through ``.values`` / ``.coords`` / ``.dims``).
"""

from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


class Coordinates(Mapping[str, np.ndarray]):
    """Ordered mapping of dimension name -> 1-d coordinate array."""

    def __init__(self, coords: Mapping[str, Any] | None = None):
        self._coords: dict[str, np.ndarray] = {}
        if coords:
            for k, v in coords.items():
                self._coords[k] = np.asarray(v)

    def __getitem__(self, key: str) -> np.ndarray:
        return self._coords[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._coords)

    def __len__(self) -> int:
        return len(self._coords)

    def __contains__(self, key) -> bool:
        return key in self._coords

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {len(v)}" for k, v in self._coords.items())
        return f"Coordinates({inner})"

    def keys(self):
        return self._coords.keys()

    def items(self):
        return self._coords.items()

    def values(self):
        return self._coords.values()

    @property
    def dims(self) -> tuple[str, ...]:
        return tuple(self._coords)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(v) for v in self._coords.values())

    def equals(self, other: "Coordinates") -> bool:
        if self.dims != tuple(other.keys()):
            return False
        return all(
            np.array_equal(self[k], np.asarray(other[k])) for k in self.dims
        )

    def to_index(self):
        """Row-major ('C' order) cross-product ``pandas.MultiIndex`` of
        the coordinates."""
        import pandas as pd

        return pd.MultiIndex.from_product(
            [np.asarray(v) for v in self._coords.values()],
            names=list(self._coords),
        )


class DataArray:
    """A named N-d array with per-dimension 1-d coordinates."""

    def __init__(
        self,
        data: np.ndarray | None = None,
        coords: Coordinates | Mapping[str, Any] | None = None,
        name: str | None = None,
        attrs: dict | None = None,
        dims: tuple[str, ...] | None = None,
    ):
        if not isinstance(coords, Coordinates):
            coords = Coordinates(coords or {})
        if data is None:
            data = np.full(coords.shape, np.nan)
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
        if coords.shape and tuple(data.shape) != coords.shape:
            raise ValueError(
                f"data shape {data.shape} does not match coords {coords.shape}"
            )
        self.values = data
        self.coords = coords
        self.name = name
        self.attrs = attrs or {}
        self._dims = dims or coords.dims

    @property
    def dims(self) -> tuple[str, ...]:
        return self._dims

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.values.shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def __array__(self, dtype=None, copy=None):
        return np.asarray(_host(self.values), dtype=dtype)

    def __repr__(self) -> str:
        return (
            f"<DataArray {self.name or ''} {self.shape} "
            f"dims={self.dims}>\n{self.values!r}"
        )

    def copy(self) -> "DataArray":
        return DataArray(
            self.values.clone() if isinstance(self.values, torch.Tensor)
            else self.values.copy(),
            Coordinates(dict(self.coords.items())),
            name=self.name,
            attrs=dict(self.attrs),
            dims=self._dims,
        )

    def sel_bounds(
        self, bounds: list[tuple[float, float]], dims: list[str]
    ) -> "DataArray":
        """Label-based inclusive bound selection along the given dims."""
        indexers = {}
        for (lo, hi), d in zip(bounds, dims):
            c = self.coords[d]
            indexers[d] = (c >= lo) & (c <= hi)
        # Apply one boolean mask per axis via successive indexing
        data = _host(self.values)
        new_coords = {}
        for axis, d in enumerate(self.dims):
            m = indexers.get(d)
            if m is None:
                new_coords[d] = self.coords[d]
                continue
            data = np.compress(m, data, axis=axis)
            new_coords[d] = self.coords[d][m]
        return DataArray(
            data, new_coords, name=self.name, attrs=dict(self.attrs)
        )

    def to_dataframe(self, name: str | None = None):
        """Flatten (row-major) to a ``pandas.DataFrame`` with coordinate
        columns."""
        import pandas as pd

        name = name or self.name or "value"
        idx = self.coords.to_index()
        return pd.DataFrame(
            {name: _host(self.values).reshape(-1)}, index=idx
        ).reset_index()


class Dataset:
    """A mapping of variable name -> DataArray sharing coordinates."""

    def __init__(
        self,
        variables: Mapping[str, DataArray] | None = None,
        coords: Coordinates | Mapping[str, Any] | None = None,
        attrs: dict | None = None,
    ):
        if not isinstance(coords, Coordinates):
            coords = Coordinates(coords or {})
        self.coords = coords
        self.attrs = attrs or {}
        self._variables: dict[str, DataArray] = dict(variables or {})

    def __getitem__(self, key: str) -> DataArray:
        return self._variables[key]

    def __setitem__(self, key: str, value: DataArray | np.ndarray) -> None:
        if not isinstance(value, DataArray):
            value = DataArray(value, self.coords, name=key)
        self._variables[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._variables

    def __iter__(self):
        return iter(self._variables)

    def keys(self):
        return self._variables.keys()

    def items(self):
        return self._variables.items()

    @property
    def data_vars(self):
        # property, as in xarray.Dataset.data_vars
        return self._variables

    def __repr__(self) -> str:
        return (
            f"<Dataset coords={list(self.coords)} "
            f"vars={list(self._variables)}>"
        )

    def sel_bounds(
        self, bounds: list[tuple[float, float]], dims: list[str]
    ) -> "Dataset":
        out_vars = {
            k: v.sel_bounds(bounds, dims) for k, v in self._variables.items()
        }
        coords = (
            next(iter(out_vars.values())).coords if out_vars else self.coords
        )
        return Dataset(out_vars, coords, attrs=dict(self.attrs))


def select_bounds(
    x,
    bounds: list[tuple[float, float]] = [(-90, 90), (-180, 180)],
    variables: list[str] = ["lat", "lon"],
):
    """Filter a DataArray/Dataset by inclusive coordinate bounds.

    Works on this module's containers and on xarray objects.
    """
    if isinstance(x, (DataArray, Dataset)):
        return x.sel_bounds(bounds, variables)
    # xarray path (sel with slices)
    bnd_map = {v: slice(*b) for v, b in zip(variables, bounds)}
    return x.sel(bnd_map)


def align_exact(a, b) -> None:
    """Raise if two arrays' coordinate systems are not identical."""
    a_coords = a.coords
    b_coords = b.coords
    a_dims = tuple(a_coords.keys()) if hasattr(a_coords, "keys") else ()
    b_dims = tuple(b_coords.keys()) if hasattr(b_coords, "keys") else ()
    if a_dims != b_dims:
        raise ValueError(f"Dims do not align: {a_dims} vs {b_dims}")
    for d in a_dims:
        if not np.array_equal(np.asarray(a_coords[d]), np.asarray(b_coords[d])):
            raise ValueError(f"Coordinate '{d}' does not align exactly")
