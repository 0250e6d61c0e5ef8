"""The device an entry point runs on, and its float32 settings."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card fails
    loudly instead of falling back to the CPU. In a rank of a process group
    (``parallel/launch.py``), CUDA without an index is the card of the
    rank's local index: one card per rank."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if device.type == "cuda" and device.index is None and dist.is_available() and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def full_fp32(deterministic: bool = False) -> None:
    """Full float32 on the card: matrix products, and cuDNN's float32
    convolutions, which run in TF32 by default.

    The port itself runs no cuDNN operation: the encoder's conv runs in its
    own kernels (ops/conv_encoder.py), float32 and summed in a fixed order.
    The cuDNN settings hold for a caller that runs a convolution beside the
    port, such as the benchmark's plain reference (port_bench/reference/),
    which trains through ``F.conv1d``: ``deterministic`` asks cuDNN for
    algorithms whose sums come out in the same order from run to run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
