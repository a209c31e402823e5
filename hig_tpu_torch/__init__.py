"""PyTorch/CUDA port of hig_tpu for NVIDIA Hopper.

The JAX package ``hig_tpu`` is the reference; this package imports neither
it nor JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hig_tpu_torch runs on a CUDA device; no GPU is visible "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    return device
