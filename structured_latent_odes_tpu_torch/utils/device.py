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


def full_fp32(deterministic: bool = False) -> None:
    """Full float32 on the card: cuDNN runs float32 convolutions in TF32 by
    default, which would change the encoder's result.

    ``deterministic`` also asks cuDNN for convolution algorithms whose sums
    come out in the same order from run to run. Training needs it: under Adam
    a gradient element that sums to nearly zero turns that roundoff into a
    visible difference, and a sweep member would no longer reproduce the
    sequential run of its seed within tests/test_ensemble.py's bound (rtol
    2e-4, atol 1e-6). Serving does not, and keeps cuDNN's fastest
    algorithms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
