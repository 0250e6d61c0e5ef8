"""Parameter initializers (the JAX package's ``nn/init.py``), drawn from an
explicit CPU ``torch.Generator`` so a seed gives the same weights on any
device and at any intra-op thread count (:func:`orthogonal`'s QR runs at
one thread).

Layout: linear weights are PyTorch's ``(out, in)``, so a layer is
``F.linear(x, W, b)``; the JAX package stores them ``(in, out)`` and
``interop.py`` transposes between the two.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor


def orthogonal(gen: torch.Generator, shape: Sequence[int]) -> Tensor:
    """Orthogonal init (torch semantics: rows orthonormal when rows <= cols);
    trailing dims are flattened as ``torch.nn.init.orthogonal_`` does.

    The QR runs at one intra-op thread: LAPACK blocks it by the thread
    count, so at another count it rounds otherwise, and a seed's weights
    would depend on the host that drew them (tests/test_torch_init_threads.py)."""
    rows = shape[0]
    cols = math.prod(shape[1:])
    n = max(rows, cols)
    a = torch.randn((n, n), generator=gen)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        q, r = torch.linalg.qr(a)
    finally:
        torch.set_num_threads(threads)
    q = q * torch.sign(torch.diagonal(r))
    return q[:rows, :cols].reshape(tuple(shape)).contiguous()


def uniform(gen: torch.Generator, shape: Sequence[int], bound: float) -> Tensor:
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * bound


def xavier_uniform(gen: torch.Generator, fan_in: int, fan_out: int, gain: float = 1.0) -> Tensor:
    """Xavier/Glorot uniform ``(out, in)`` weight."""
    return uniform(gen, (fan_out, fan_in), gain * math.sqrt(6.0 / (fan_in + fan_out)))


def torch_linear_default(gen: torch.Generator, fan_in: int, fan_out: int) -> Tuple[Tensor, Tensor]:
    """torch.nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)) for W ``(out, in)`` and b."""
    bound = 1.0 / math.sqrt(fan_in)
    return uniform(gen, (fan_out, fan_in), bound), uniform(gen, (fan_out,), bound)


def small_normal(gen: torch.Generator, fan_in: int, fan_out: int, std: float = 0.001):
    """N(0, std^2) W ``(out, in)`` and b: the hidden layers' init of ``mlp_init``."""
    return (
        torch.randn((fan_out, fan_in), generator=gen) * std,
        torch.randn((fan_out,), generator=gen) * std,
    )
