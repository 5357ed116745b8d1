"""Grid construction, observation-grid alignment, masks, climatology."""

from .grid import (
    aggregate_observations,
    assign_to_grid,
    cross_coords,
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)

__all__ = [
    "aggregate_observations",
    "assign_to_grid",
    "cross_coords",
    "grid_from_resolution",
    "grid_to_distance_matrix",
    "map_to_grid",
]
