"""Per-sample reparameterized normal draws for serving (the sampling half of
the JAX package's ``prob/distributions.py``; the log-probs and the ``Trace``
belong to the training slice).

The JAX package folds each sample's identity into the site key
(``per_sample_keys``), so a draw depends only on (key, site, sample_id) and
never on the batch size, padding or the other samples. The port keeps that
property with a counter-based generator: a 32-bit integer hash of
(seed, site, sample_id, element) feeds Box-Muller, computed elementwise on
integer tensors on the caller's device. It does not reproduce JAX's threefry
bits; tests feed both packages the same draws instead.
"""

from __future__ import annotations

import math
import zlib
from typing import Sequence

import torch

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """Low 32 bits of x * c for x, c < 2**32, without overflowing int64."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _MASK32


def _mix32(x: Tensor) -> Tensor:
    """A 32-bit integer finalizer (the 'lowbias32' constants): a bijection on
    [0, 2**32) with full avalanche, on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _site_word(seed: int, site: str) -> int:
    words = (seed & _MASK32, (seed >> 32) & _MASK32, zlib.crc32(site.encode()))
    h = torch.tensor(0x9E3779B9, dtype=torch.int64)
    for w in words:
        h = _mix32(h ^ w)
    return int(h)


def standard_normal_ps(seed: int, site: str, sample_ids: Tensor, event_shape: Sequence[int],
                       dtype=torch.float32) -> Tensor:
    """Standard-normal draws of shape ``(B, *event_shape)`` on
    ``sample_ids``' device; row b depends only on (seed, site, sample_ids[b])."""
    n = math.prod(event_shape)
    sid = sample_ids.to(torch.int64).reshape(-1, 1) & _MASK32
    key = _mix32(sid ^ _site_word(seed, site))
    # counters 2j and 2j+1 feed the two uniforms of element j's Box-Muller
    # pair; one tensor for both keeps the number of small launches down
    counter = torch.arange(2 * n, device=sample_ids.device, dtype=torch.int64)[None, :]
    u = ((_mix32(key ^ counter) >> 8).to(torch.float64) + 0.5) / 16777216.0  # (0, 1)
    u1, u2 = u[:, 0::2], u[:, 1::2]
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.to(dtype).reshape(sid.shape[0], *event_shape)


def sample_normal_ps(seed: int, site: str, sample_ids: Tensor, loc: Tensor, scale: Tensor,
                     eps: Tensor | None = None) -> Tensor:
    """``loc + scale * eps`` with per-sample draws; ``loc``/``scale`` are
    ``(B, ...)``. ``eps`` replaces the generated standard-normal draws (tests
    feed both packages the same ones)."""
    if eps is None:
        eps = standard_normal_ps(seed, site, sample_ids.to(loc.device), loc.shape[1:], loc.dtype)
    return loc + scale * eps
