"""The draws' arithmetic, frozen for the reference: a copy of
``structured_latent_odes_tpu_torch/prob/distributions.py:80-170``
(``_mul32``, ``_mix32``, ``_site_word``, ``fold_seed``, ``seed_tensor``,
``uniform_words_ps``, ``uniform_ps``, ``standard_normal_ps``).

The program documents its draws as a function of (seed, site, sample_id):
a 32-bit integer hash of (seed, site, sample_id, element) feeds Box-Muller.
The reference works every draw out again from the seeds with this copy, and
the step and eval seeds with :func:`fold_seed`, so it takes no draw that the
program made. Integer arithmetic on int64 tensors: the words are equal on
every device.
"""

from __future__ import annotations

import math
import zlib
from typing import Sequence

import torch

MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """Low 32 bits of x * c for x, c < 2**32, without overflowing int64."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & MASK32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _site_word(seed: int, site: str) -> int:
    words = (seed & MASK32, (seed >> 32) & MASK32, zlib.crc32(site.encode()))
    h = 0x9E3779B9
    for w in words:
        h = _mix32(h ^ w)
    return h


def fold_seed(seed: int, *words) -> int:
    """A 64-bit seed from ``seed`` and ``words`` (ints or strings)."""
    for w in words:
        seed = (_site_word(seed, f"fold/{w}") << 32) | _site_word(seed, f"fold/{w}/lo")
    return seed


def signed64(seed: int) -> int:
    """A 64-bit seed as the signed int that an int64 tensor holds."""
    return seed - (1 << 64) if seed >= 1 << 63 else seed


def standard_normal(seed: int, site: str, sample_ids: torch.Tensor, event_shape: Sequence[int],
                    dtype=torch.float32) -> torch.Tensor:
    """Standard-normal draws ``(B, *event_shape)`` on ``sample_ids``' device;
    row b depends only on (seed, site, sample_ids[b])."""
    n = math.prod(event_shape)
    sid = sample_ids.to(torch.int64)[:, None] & MASK32
    key = _mix32(sid ^ _site_word(seed, site))
    counter = torch.arange(2 * n, device=sample_ids.device, dtype=torch.int64)
    words = _mix32(key ^ counter) >> 8
    u = (words.to(torch.float64) + 0.5) / 16777216.0
    u1, u2 = u[:, 0::2], u[:, 1::2]
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.to(dtype).reshape(sample_ids.shape[0], *event_shape)


def normal(seed: int, site: str, sample_ids: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``loc + scale * eps`` with the per-sample draws of ``site``."""
    return loc + scale * standard_normal(seed, site, sample_ids, loc.shape[1:], loc.dtype)
