"""Host-side helpers (background prefetch)."""
