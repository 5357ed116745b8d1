"""Carry the JAX package's model parameters into the port's objects.

Parameters arrive as plain values, never as JAX objects, so this module
imports nothing of the JAX package:

    variogram_from_params(kind, dataclasses.asdict(jax_variogram))
    kernel_from_params(dataclasses.asdict(jax_kernel.variogram),
                       jax_kernel.distance, jax_kernel.var, jax_kernel.radius)
"""

from typing import Any, Mapping

import numpy as np

from .models.kernel_kriging import VariogramKernel
from .ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
    Variogram,
)

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
