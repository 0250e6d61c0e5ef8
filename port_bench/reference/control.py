"""The control of each cell's comparison: the reference put in the
program's place, in the nearest precision below the configuration's
float32 with TF32 off, which is TF32 (float32 products on the tensor cores'
10-bit mantissa); and the faults that a training step can have, planted in
the reference put in the program's place. The benchmark's own runs run none
of this: ``port_bench/tools/readings.py`` reads them, and
``port_bench/tests/`` holds them at a small size."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    """Matrix products and cuDNN convolutions in TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def half_batch(batches):
    """Each minibatch with its second half left out: masked, so the losses
    are the mean over the rest."""
    out = []
    for b in batches:
        mask = b["mask"].clone()
        mask[mask.shape[0] // 2:] = 0.0
        out.append({**b, "mask": mask})
    return out
