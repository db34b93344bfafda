"""Packing, exact MIPS and the fused score+segmax kernel wrapper."""
