"""Seed discipline (counterpart of viquae_tpu/core/prng.py).

All randomness flows from one integer seed. Host-side draws (batch order,
passage sampling, ICT sentence masking in the collators) use a numpy
``Generator`` seeded exactly as the JAX package seeds its own, so the
host streams of both packages are bitwise the same. Device-side draws
(dropout) take a ``torch.Generator`` per named purpose, derived from the
seed and the name's stable FNV hash; JAX's counter-based PRNG cannot be
reproduced, so those streams are the port's own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_SEED = 42


@dataclasses.dataclass
class SeedBundle:
    seed: int

    def __post_init__(self):
        self.host = np.random.default_rng(
            np.uint64(self.seed) ^ np.uint64(0x9E3779B97F4A7C15))

    def split(self, name: str) -> torch.Generator:
        """Deterministic named generator (stable across runs): a CPU
        ``torch.Generator`` seeded from (seed, FNV hash of ``name``)."""
        gen = torch.Generator()
        gen.manual_seed(((self.seed & 0xFFFFFFFF) << 31) | _stable_hash(name))
        return gen


def _stable_hash(name: str) -> int:
    h = 2166136261
    for c in name.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF
