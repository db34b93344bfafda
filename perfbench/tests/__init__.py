"""CPU tests of the benchmark at a tiny size, and card tests marked cuda."""
