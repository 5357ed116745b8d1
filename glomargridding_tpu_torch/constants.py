"""Physical constants shared with the JAX package (same values)."""

RADIUS_OF_EARTH_M: float = 6371000.0  # Average radius of Earth (m)
RADIUS_OF_EARTH_KM: float = 6371.0  # Average radius of Earth (km)
KM_TO_M: float = 1000.0
