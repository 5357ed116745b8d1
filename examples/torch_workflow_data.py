"""The netCDF inputs of the PyTorch workflow examples, and a bundle of
them for machines without h5py.

``torch_hadsst_workflow.py`` and ``torch_esa_months_scan.py`` read the
vendored files in ``examples/data`` through the port's ``io.load_array``
by default. ``bundle_inputs`` reads every variable they use the same way
and stores values, dimensions and coordinates in one compressed ``.npz``
(``examples/data/torch_workflow_inputs.npz``); ``bundle_loader`` returns
a function with ``load_array``'s signature that serves them from it, so a
run on a machine that has numpy but no h5py reads the same arrays.

Write the bundle (needs h5py):

    python examples/torch_workflow_data.py
"""

import os
import sys

import numpy as np

try:  # prefer the installed package; fall back to a repo checkout
    import glomargridding_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from glomargridding_tpu_torch.core.labeled import Coordinates, DataArray

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BUNDLE = os.path.join(DATA, "torch_workflow_inputs.npz")
MONTH = 3
# (file, variable) of every input the two examples read
INPUTS = [
    (f"esa_cci_sst_5deg_monthly_1982-2022_{MONTH:02d}.nc", "sst_anomaly"),
    *((f"HadCRUT.5.0.2.0.error_covariance.{year}_{MONTH:02d}.nc", "tas_cov")
      for year in (2014, 1876)),
    *((f"HadCRUT.5.0.2.0.uncorrelated_{year}_{MONTH:02d}.nc", "tas_unc")
      for year in (2014, 1876)),
    *((f"HadSST.4.0.1.0_ensemble_member_{member}_{year}_{MONTH:02d}.nc",
       "tos") for member, year in ((71, 2014), (94, 1876))),
]
_SEP = "::"


def _key(path, var):
    return os.path.basename(path) + _SEP + var


def bundle_inputs(out_path: str = BUNDLE, data_dir: str = DATA) -> str:
    """Read every input through the port's ``load_array`` and store it in
    one compressed ``.npz`` at `out_path`."""
    from glomargridding_tpu_torch.io import load_array

    arrays = {}
    for fname, var in INPUTS:
        arr = load_array(os.path.join(data_dir, fname), var)
        key = _key(fname, var)
        arrays[key + _SEP + "values"] = np.asarray(arr.values)
        arrays[key + _SEP + "dims"] = np.array(arr.dims)
        for i, name in enumerate(arr.coords):
            arrays[f"{key}{_SEP}coord{_SEP}{i}{_SEP}{name}"] = np.asarray(
                arr.coords[name])
    np.savez_compressed(out_path, **arrays)
    return out_path


def bundle_loader(path: str = BUNDLE):
    """A function ``load(path, var)`` serving the bundle's arrays as the
    port's ``load_array`` would (only the file's base name is looked at)."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}

    def load(file_path, var):
        key = _key(file_path, var)
        if key + _SEP + "values" not in stored:
            raise FileNotFoundError(f"{key} is not in the bundle {path}")
        prefix = key + _SEP + "coord" + _SEP
        coords = sorted(
            (int(k[len(prefix):].split(_SEP)[0]),
             k[len(prefix):].split(_SEP, 1)[1], v)
            for k, v in stored.items() if k.startswith(prefix))
        return DataArray(stored[key + _SEP + "values"],
                         Coordinates({name: v for _, name, v in coords}),
                         name=var,
                         dims=tuple(str(d) for d in stored[key + _SEP
                                                           + "dims"]))

    return load


if __name__ == "__main__":
    out = bundle_inputs()
    print(f"{out}: {os.path.getsize(out) / 1e6:.2f} MB")
