"""Device choice and precision, the device mesh and its collectives,
wall-clock stage timing."""
