"""Host-side dataset utilities (copies of the JAX package's)."""
