"""The device an entry point runs on, and its float32 settings."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card fails
    loudly instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return device


def full_fp32() -> None:
    """Full float32 on the card: cuDNN runs float32 convolutions in TF32 by
    default, which would change the encoder's result."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
