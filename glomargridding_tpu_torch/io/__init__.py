"""I/O: h5py-backed netCDF4, format-string paths, config recursion.

h5py is imported by the functions that open a file, so importing this
package needs neither h5py nor pandas.
"""

from ..utils.frames import get_recurse
from .covariance import (
    load_covariance,
    load_lowrank,
    save_covariance,
    save_lowrank,
)
from .netcdf import (
    add_empty_layers,
    load_array,
    load_dataset,
    open_dataset,
    save_dataset,
)

__all__ = [
    "add_empty_layers",
    "get_recurse",
    "load_array",
    "load_covariance",
    "load_lowrank",
    "load_dataset",
    "open_dataset",
    "save_covariance",
    "save_lowrank",
    "save_dataset",
]
