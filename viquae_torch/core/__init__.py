"""Device choice and precision, wall-clock stage timing."""
