"""Packing, MIPS engines, the kernel wrappers and late fusion."""
