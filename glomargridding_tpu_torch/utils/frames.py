"""Unit conversions and the column check of the frame-level wrappers.

Port of ``glomargridding_tpu/utils/frames.py``: ``deg_to_nm``,
``deg_to_km``, ``km_to_deg`` (``:79-92``), and ``check_cols`` with its
error (``:17-27``), which ``ops.distances``' frame forms call. The
observation-frame helpers (``filter_bounds``, ``batched``,
``get_recurse``) belong to the host-side modules that are not ported yet.
"""

from ..constants import KM_TO_NM, NM_PER_LAT


class ColumnNotFoundError(Exception):
    """A required DataFrame column is missing."""


def check_cols(df, cols: list[str]) -> None:
    """Raise ColumnNotFoundError listing any of `cols` missing from `df`."""
    missing = [c for c in cols if c not in df.columns]
    if missing:
        raise ColumnNotFoundError(
            "DataFrame is missing required columns: " + ", ".join(missing)
        )


def deg_to_nm(deg: float) -> float:
    """Degrees latitude -> nautical miles."""
    return NM_PER_LAT * deg


def deg_to_km(deg: float) -> float:
    """Degrees latitude -> kilometres."""
    return KM_TO_NM * deg_to_nm(deg)


def km_to_deg(km: float) -> float:
    """Meridional kilometres -> degrees latitude."""
    return (km / KM_TO_NM) / NM_PER_LAT
