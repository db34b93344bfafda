"""Device choice and float32 precision for the whole port.

Entry points run on the GPU unless the caller asks for the CPU; there is
no silent fallback. TF32 is switched off here, once, for every importer:
a float32 product on TF32 keeps ~10 mantissa bits, which breaks the
float32 parity contract with the JAX reference (the JAX package pins
``precision=HIGHEST`` on its float32 products for the same reason).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, else what
    the caller names. Raises when no device was given and there is no
    GPU — the CPU is only ever used when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")
