"""Host-side utilities (arrays, calendars, frames, logging, profiling,
roofline accounting) and the entry points' device rule."""

from ..core.labeled import select_bounds
from .arrays import (
    adjust_small_negative,
    cor_2_cov,
    cov_2_cor,
    find_nearest,
    get_spatial_mean,
    intersect_mtlb,
    is_iter,
    mask_array,
    sizeof_fmt,
    uncompress_masked,
)
from .calendar import (
    MonthName,
    days_since_by_month,
    get_date_index,
    get_month_midpoint,
    get_pentad_range,
)
from .device import resolve_device
from .frames import (
    ColumnNotFoundError,
    batched,
    check_cols,
    deg_to_km,
    deg_to_nm,
    filter_bounds,
    km_to_deg,
)
from .logging import init_logging
from .profiling import hbm_budget_check, hbm_estimate, stage_timer

__all__ = [
    "ColumnNotFoundError",
    "MonthName",
    "adjust_small_negative",
    "batched",
    "check_cols",
    "cor_2_cov",
    "cov_2_cor",
    "days_since_by_month",
    "deg_to_km",
    "deg_to_nm",
    "filter_bounds",
    "find_nearest",
    "get_date_index",
    "get_month_midpoint",
    "get_pentad_range",
    "get_spatial_mean",
    "hbm_budget_check",
    "hbm_estimate",
    "init_logging",
    "intersect_mtlb",
    "is_iter",
    "km_to_deg",
    "mask_array",
    "resolve_device",
    "select_bounds",
    "sizeof_fmt",
    "stage_timer",
    "uncompress_masked",
]
