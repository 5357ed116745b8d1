"""Carry the JAX package's model parameters into the port's objects.

Parameters arrive as plain values, never as JAX objects, so this module
imports nothing of the JAX package:

    variogram_from_params(kind, dataclasses.asdict(jax_variogram))
    kernel_from_params(dataclasses.asdict(jax_kernel.variogram),
                       jax_kernel.distance, jax_kernel.var, jax_kernel.radius)
    ellipse_builder_from_inputs(Lx, Ly, theta, stdev, lats, lons, v=...,
                                delta_x_method=..., ...)
    lowrank_psd_from_arrays(np.asarray(jax_psd.vectors),
                            np.asarray(jax_psd.gains),
                            np.asarray(jax_psd.floor))
    ellipse_model_from_params(vars(jax_ellipse_model))
    dataset_from_arrays({k: v.values for k, v in jax_dataset.items()},
                        dict(jax_dataset.coords.items()), jax_dataset.attrs)
    ellipse_builder_from_dataset(params, lats, lons, v=...)
"""

from typing import Any, Mapping

import numpy as np
import torch

from .core.labeled import Coordinates, DataArray, Dataset
from .models.ellipse import EllipseCovarianceBuilder, EllipseModel
from .models.kernel_kriging import VariogramKernel
from .ops.covariance_tools import LowRankPSD
from .ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
    Variogram,
)
from .utils.device import resolve_device

VARIOGRAMS = {
    cls.kind: cls
    for cls in (
        SphericalVariogram,
        GaussianVariogram,
        ExponentialVariogram,
        MaternVariogram,
    )
}


def _plain(value):
    """Numbers (including numpy scalars and 0-d arrays) to float;
    strings and None unchanged."""
    if value is None or isinstance(value, str):
        return value
    return float(np.asarray(value))


def variogram_from_params(kind: str, params: Mapping[str, Any]) -> Variogram:
    """A port variogram from the reference's kind and field values.

    `kind` is the reference's ``_kind`` ("matern", "exponential", ...);
    `params` is ``dataclasses.asdict`` of the reference dataclass, whose
    own ``_kind`` entry, if present, must agree.
    """
    if kind not in VARIOGRAMS:
        raise ValueError(f"Unknown variogram kind: {kind}")
    fields = dict(params)
    own = fields.pop("_kind", kind)
    if own != kind:
        raise ValueError(f"params are for kind {own!r}, not {kind!r}")
    return VARIOGRAMS[kind](**{k: _plain(v) for k, v in fields.items()})


def kernel_from_params(
    variogram_params: Mapping[str, Any],
    distance: str,
    variance,
    radius,
) -> VariogramKernel:
    """A port kernel from the reference kernel's variogram fields
    (including ``_kind``), ``.distance``, ``.var`` and ``.radius``."""
    vario = variogram_from_params(variogram_params["_kind"], variogram_params)
    return VariogramKernel(vario, distance, _plain(variance), _plain(radius))


def ellipse_builder_from_inputs(
    Lx,
    Ly,
    theta,
    stdev,
    lats,
    lons,
    v,
    delta_x_method: str = "Modified_Met_Office",
    max_dist=None,
    precision=np.float32,
    covariance_method: str = "array",
    batch_size=None,
    use_pallas="auto",
    device=None,
) -> EllipseCovarianceBuilder:
    """The port's ``EllipseCovarianceBuilder`` from the inputs of a
    reference ``EllipseCovarianceBuilder``, as numpy: the (masked) `Lx`,
    `Ly`, `theta`, `stdev` fields, `lats`, `lons`, and the same `v`,
    `delta_x_method`, `max_dist`, `precision`, `covariance_method`,
    `batch_size` and `use_pallas`. Numpy scalars become Python numbers;
    `device` places the covariance (by default the card)."""
    return EllipseCovarianceBuilder(
        *(np.ma.asarray(a) for a in (Lx, Ly, theta, stdev)),
        np.asarray(lats),
        np.asarray(lons),
        v=_plain(v),
        delta_x_method=delta_x_method,
        max_dist=_plain(max_dist),
        precision=np.dtype(precision).type,
        covariance_method=covariance_method,
        batch_size=None if batch_size is None else int(batch_size),
        use_pallas=use_pallas,
        device=device,
    )


def lowrank_psd_from_arrays(vectors, gains, floor, device=None) -> LowRankPSD:
    """The port's ``LowRankPSD`` from the three arrays of a reference
    ``LowRankPSD`` (as numpy): `vectors` (n, r), `gains` (r,), `floor`
    (n,), in the dtype of `vectors`. `device` places the factors (by
    default the card; tensors keep their device)."""
    device = resolve_device(device, vectors, gains, floor)
    V = torch.as_tensor(vectors, device=device)
    if V.dim() != 2:
        raise ValueError(f"vectors must be (n, r), got {tuple(V.shape)}")
    g = torch.as_tensor(gains, dtype=V.dtype, device=device)
    f = torch.as_tensor(floor, dtype=V.dtype, device=device)
    if g.shape != (V.shape[1],) or f.shape != (V.shape[0],):
        raise ValueError(
            f"gains {tuple(g.shape)} and floor {tuple(f.shape)} do not "
            f"match vectors {tuple(V.shape)}")
    return LowRankPSD(vectors=V, gains=g, floor=f)


_MODEL_ATTRIBUTES = ("anisotropic", "rotated", "physical_distance", "v",
                     "unit_sigma")


def ellipse_model_from_params(params: Mapping[str, Any]) -> EllipseModel:
    """The port's ``EllipseModel`` from a reference model's plain
    attributes (``vars(model)`` will do): `anisotropic`, `rotated`,
    `physical_distance`, `v` and `unit_sigma`; anything else in the
    mapping is derived from these and ignored."""
    missing = [k for k in _MODEL_ATTRIBUTES if k not in params]
    if missing:
        raise ValueError(f"ellipse model parameters lack {missing}")
    return EllipseModel(
        anisotropic=bool(params["anisotropic"]),
        rotated=bool(params["rotated"]),
        physical_distance=bool(params["physical_distance"]),
        v=_plain(params["v"]),
        unit_sigma=bool(params["unit_sigma"]),
    )


def dataset_from_arrays(fields: Mapping[str, Any], coords: Mapping[str, Any],
                        attrs: Mapping[str, Any] | None = None) -> Dataset:
    """The port's ``Dataset`` from a reference dataset taken apart:
    `fields` maps a variable's name to its array, or to an (array, attrs)
    pair; `coords` maps each dimension, in order, to its 1-d coordinate."""
    coords = Coordinates({k: np.asarray(v) for k, v in coords.items()})
    out = Dataset({}, coords, attrs=dict(attrs or {}))
    for name, field in fields.items():
        values, field_attrs = field if isinstance(field, tuple) else (
            field, None)
        out[name] = DataArray(np.asarray(values), coords, name=name,
                              attrs=dict(field_attrs or {}))
    return out


def ellipse_builder_from_dataset(
    params,
    lats,
    lons,
    v,
    mask=None,
    delta_x_method: str = "Modified_Met_Office",
    max_dist=None,
    precision=np.float32,
    covariance_method: str = "array",
    batch_size=None,
    use_pallas="auto",
    device=None,
) -> EllipseCovarianceBuilder:
    """The port's ``EllipseCovarianceBuilder`` from the parameter fields
    that ``EllipseBuilder.compute_params`` returns.

    `params` holds (lat, lon) fields "Lx", "Ly", "theta" and
    "standard_deviation" (a ``Dataset``, or a mapping to arrays), and,
    where it also holds "qc_code", every point whose fit did not converge
    (code 9) is masked out of the covariance, with the points of `mask`
    (True = leave out) and those without a positive Lx. The remaining
    arguments are ``EllipseCovarianceBuilder``'s."""
    def field(name):
        values = params[name]
        return np.asarray(getattr(values, "values", values), dtype=float)

    Lx = field("Lx")
    drop = ~(Lx > 0)
    if "qc_code" in params:
        drop |= field("qc_code") == 9
    if mask is not None:
        drop |= np.asarray(mask, dtype=bool)
    return ellipse_builder_from_inputs(
        *(np.ma.masked_where(drop, a) for a in (
            Lx, field("Ly"), field("theta"), field("standard_deviation"))),
        lats, lons, v, delta_x_method=delta_x_method, max_dist=max_dist,
        precision=precision, covariance_method=covariance_method,
        batch_size=batch_size, use_pallas=use_pallas, device=device)
