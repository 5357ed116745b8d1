r"""Stationary variogram models -> covariance, on tensors.

Port of ``glomargridding_tpu/ops/variogram.py:37-272``: Spherical,
Gaussian, Exponential and Matern (sklearn/gstat/karspeck conventions),
``fit``/``covariance`` and ``variogram_to_covariance``. Each returns the
container it was given: an ndarray for an ndarray, a tensor for a tensor,
and for a ``core.labeled.DataArray`` (or an ``xarray.DataArray``, where
xarray is installed) a DataArray with the input's coords and a copy of
its attrs, named "variogram" (``fit``) or "covariance" (``covariance``,
``variogram_to_covariance``). A DataArray whose values are a tensor keeps
them a tensor on their device.
"""

import math
from dataclasses import dataclass
from typing import ClassVar, Literal

import numpy as np
import torch

from ..core.labeled import DataArray
from .special import gamma_fn, xv_kv

MaternModel = Literal["sklearn", "gstat", "karspeck"]


def matern_scale(nu: float, method: str) -> float:
    """Factor on d / range in the Matern argument, per convention."""
    if method == "sklearn":
        return math.sqrt(2.0 * nu)
    if method == "gstat":
        return 1.0
    if method == "karspeck":
        return 2.0 * math.sqrt(nu)
    raise ValueError("Unexpected 'method' value")


def matern_left(nu: float) -> float:
    """The Matern normalisation 1 / (Gamma(nu) 2^(nu-1))."""
    return 1.0 / (gamma_fn(nu) * (2.0 ** (nu - 1.0)))


def _vario_kernel(
    d: torch.Tensor,
    psill: float,
    nugget: float,
    range_: float,
    variance: float,
    kind: str,
    nu: float | None = None,
    method: str | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """Every variogram family, elementwise; with `fused` the value is
    ``variance - gamma(d)`` (covariance)."""
    if kind == "spherical":
        out = 0.5 * psill * (3.0 * d / range_ - (d / range_) ** 3) + nugget
        out = torch.where(d >= range_, nugget + psill, out)
    elif kind == "gaussian":
        out = psill * (1.0 - torch.exp(-((d / range_) ** 2))) + nugget
    elif kind == "exponential":
        out = psill * (1.0 - torch.exp(-(d / range_))) + nugget
    elif kind == "matern":
        scale = matern_scale(nu, method)
        inner = scale * (d / range_)
        corr = matern_left(nu) * xv_kv(nu, inner)
        # d == 0 takes the nugget below; a finite corr there keeps the
        # NaN of K_nu(0) out of the gradient in psill (the reference's
        # gradient is NaN when a distance is exactly 0)
        corr = torch.where(d == 0.0, 1.0, corr)
        out = psill * (1.0 - corr) + nugget
        out = torch.where(d == 0.0, torch.full_like(out, 1.0) * nugget, out)
    else:
        raise ValueError(f"Unknown variogram kind: {kind}")
    if fused:
        return variance - out
    return out


def _unwrap(x):
    """(tensor, rewrap) for DataArray / ndarray / tensor / array-like
    inputs; rewrap gives back the input's container type."""
    if isinstance(x, DataArray):
        values = x.values
        if isinstance(values, torch.Tensor):
            return values, lambda v: DataArray(
                v, x.coords, name="variogram", attrs=dict(x.attrs))
        return torch.as_tensor(np.asarray(values)), lambda v: DataArray(
            v.cpu().numpy(), x.coords, name="variogram",
            attrs=dict(x.attrs))
    try:  # optional xarray support
        import xarray as xr

        if isinstance(x, xr.DataArray):
            return torch.as_tensor(np.asarray(x.values)), lambda v: (
                xr.DataArray(v.cpu().numpy(), coords=x.coords,
                             name="variogram"))
    except ImportError:
        pass
    if isinstance(x, torch.Tensor):
        return x, lambda v: v
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x), lambda v: v.cpu().numpy()
    return torch.as_tensor(x), lambda v: v


def _renamed(out, name):
    """`out` named `name` where it is a labelled array."""
    if not isinstance(out, (torch.Tensor, np.ndarray)):
        out.name = name
    return out


@dataclass()
class Variogram:
    """Abstract variogram model."""

    kind: ClassVar[str] = "abstract"

    def _static_kwargs(self) -> dict:
        return {"kind": self.kind, "nu": None, "method": None}

    def _kernel(self, d, variance=0.0, fused: bool = False):
        """Variogram (or fused covariance) values at distances."""
        if self.kind == "abstract":
            raise NotImplementedError(
                "Not implemented for base Variogram class"
            )
        return _vario_kernel(
            d,
            self.psill,
            self.nugget,
            self.range,
            variance,
            fused=fused,
            **self._static_kwargs(),
        )

    def fit(self, distance_matrix):
        """Variogram at each entry of a distance matrix (same container
        type out as in; a DataArray comes back named "variogram")."""
        d, rewrap = _unwrap(distance_matrix)
        return rewrap(self._kernel(d))

    def covariance(self, distance_matrix, variance=None):
        """Fused ``variance - variogram(d)``; `variance` defaults to the
        sill ``psill + nugget``."""
        d, rewrap = _unwrap(distance_matrix)
        if variance is None:
            variance = self.psill + self.nugget
        return _renamed(rewrap(self._kernel(d, variance=variance,
                                            fused=True)), "covariance")


def _resolve_ranges(range_, effective_range, eff_over_range: float):
    if range_ is None and effective_range is None:
        raise ValueError("One of range and effective_range must be specified")
    if range_ is None:
        range_ = effective_range / eff_over_range
    elif effective_range is None:
        effective_range = range_ * eff_over_range
    return range_, effective_range


@dataclass()
class SphericalVariogram(Variogram):
    """Spherical model; range == effective_range."""

    kind: ClassVar[str] = "spherical"
    psill: float = 1.0
    nugget: float = 0.0
    effective_range: float | None = None
    range: float | None = None

    def __post_init__(self):
        self.range, self.effective_range = _resolve_ranges(
            self.range, self.effective_range, 1.0
        )


@dataclass()
class GaussianVariogram(Variogram):
    """Gaussian model; range = effective_range / 2."""

    kind: ClassVar[str] = "gaussian"
    psill: float = 1.0
    nugget: float = 0.0
    effective_range: float | None = None
    range: float | None = None

    def __post_init__(self):
        self.range, self.effective_range = _resolve_ranges(
            self.range, self.effective_range, 2.0
        )


@dataclass()
class ExponentialVariogram(Variogram):
    """Exponential model; range = effective_range / 3."""

    kind: ClassVar[str] = "exponential"
    psill: float = 1.0
    nugget: float = 0.0
    range: float | None = None
    effective_range: float | None = None

    def __post_init__(self):
        self.range, self.effective_range = _resolve_ranges(
            self.range, self.effective_range, 3.0
        )


@dataclass()
class MaternVariogram(Variogram):
    """Matern model in three conventions (argument scale sqrt(2 nu),
    1 or 2 sqrt(nu) on d / range); range = effective_range / 2 for
    0.5 <= nu <= 10, else / 3. The value at d = 0 is the nugget."""

    kind: ClassVar[str] = "matern"
    psill: float = 1.0
    nugget: float = 0.0
    effective_range: float | None = None
    range: float | None = None
    nu: float = 0.5
    method: MaternModel = "sklearn"

    def __post_init__(self):
        factor = 2.0 if 0.5 <= self.nu <= 10 else 3.0
        self.range, self.effective_range = _resolve_ranges(
            self.range, self.effective_range, factor
        )

    def _static_kwargs(self) -> dict:
        return {
            "kind": "matern",
            "nu": float(self.nu),
            "method": self.method.lower(),
        }


def variogram_to_covariance(variogram, variance):
    """covariance = variance - variogram."""
    d, rewrap = _unwrap(variogram)
    return _renamed(rewrap(variance - d), "covariance")
