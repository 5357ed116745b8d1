"""Observation binning on the device (the reference's native host
kernels)."""

from .gridbin import bin_mean, snap_to_grid

__all__ = ["bin_mean", "snap_to_grid"]
