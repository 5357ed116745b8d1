"""Labeled-array containers."""

from .labeled import (
    Coordinates,
    DataArray,
    Dataset,
    align_exact,
    select_bounds,
)

__all__ = [
    "Coordinates",
    "DataArray",
    "Dataset",
    "align_exact",
    "select_bounds",
]
