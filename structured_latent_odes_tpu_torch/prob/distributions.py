"""Distribution log-probabilities and per-sample reparameterized normal draws
(the JAX package's ``prob/distributions.py``).

The log-probs are elementwise, broadcast like torch, and keep the JAX
package's 1e-7 clips; ``sum_event`` applies Pyro's ``to_event`` reduction.

The JAX package folds each sample's identity into the site key
(``per_sample_keys``), so a draw depends only on (key, site, sample_id) and
never on the batch size, padding or the other samples. The port keeps that
property with a counter-based generator: a 32-bit integer hash of
(seed, site, sample_id, element) feeds Box-Muller, computed elementwise on
integer tensors on the caller's device. It does not reproduce JAX's threefry
bits; tests feed both packages the same draws instead.

JAX threads keys by splitting them; here a seed for each (step, loss) or
(epoch, split) comes from :func:`fold_seed`, through the same hash, so a
training draw depends only on (seed, step, site, sample_id). The JAX key-based
samplers ``sample_laplace``, ``sample_bernoulli`` and
``sample_onehot_categorical`` are on no path of the port yet (ROADMAP).
"""

from __future__ import annotations

import math
import zlib
from typing import Sequence

import torch

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_LOG_2PI = math.log(2.0 * math.pi)
_EPS = 1e-7


def normal_logpdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    z = (x - loc) / scale
    return -0.5 * (z * z) - torch.log(scale) - 0.5 * _LOG_2PI


def laplace_logpdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)


def bernoulli_logpmf(x: Tensor, probs: Tensor) -> Tensor:
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


def onehot_categorical_logpmf(x: Tensor, probs: Tensor) -> Tensor:
    """Elementwise ``x * log p`` of a one-hot ``x`` under normalized class
    ``probs``; summing the trailing dim gives the categorical log-pmf."""
    return x * torch.log(torch.clamp(probs, _EPS, 1.0))


def kl_normal_normal(loc_q: Tensor, scale_q: Tensor, loc_p: Tensor, scale_p: Tensor) -> Tensor:
    """Analytic KL(q || p) between diagonal normals (elementwise)."""
    var_ratio = (scale_q / scale_p) ** 2
    t1 = ((loc_q - loc_p) / scale_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def sum_event(logp: Tensor, event_dims: int = 1) -> Tensor:
    """Sum the trailing ``event_dims`` axes (Pyro's ``.to_event``)."""
    if event_dims == 0:
        return logp
    return torch.sum(logp, dim=tuple(range(-event_dims, 0)))


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
    """32-bit hash of (seed, site); _mix32 on Python ints, host-side."""
    words = (seed & _MASK32, (seed >> 32) & _MASK32, zlib.crc32(site.encode()))
    h = 0x9E3779B9
    for w in words:
        h = _mix32(h ^ w)
    return h


def fold_seed(seed: int, *words) -> int:
    """A 64-bit seed from ``seed`` and ``words`` (ints or strings), e.g. the
    training step and the loss, through the draws' own hash."""
    for w in words:
        seed = (_site_word(seed, f"fold/{w}") << 32) | _site_word(seed, f"fold/{w}/lo")
    return seed


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
