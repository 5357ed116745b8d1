"""Physical constants shared with the JAX package (same values)."""

RADIUS_OF_EARTH_M: float = 6371000.0  # Average radius of Earth (m)
RADIUS_OF_EARTH_KM: float = 6371.0  # Average radius of Earth (km)
KM_TO_M: float = 1000.0

# Each degree of latitude equals 60 nautical miles.
NM_PER_LAT: float = 60.0
KM_TO_NM: float = 1.852  # km per nautical mile
