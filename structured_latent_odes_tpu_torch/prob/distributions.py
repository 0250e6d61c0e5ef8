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
training draw depends only on (seed, step, site, sample_id). Seeds are host
integers; an ensemble (``train/ensemble.py``) hands its members' seeds to the
draws as one int64 tensor (:func:`seed_tensor`), and the hash then runs on the
device, member s drawing exactly what it would draw alone.

The arithmetic below (``_mix32``, ``_site_word``, :func:`fold_seed_plain`,
:func:`standard_normal_plain`) is the plain version of the kernels of
``ops/counter_normal.py``: on the CPU :func:`standard_normal_ps` and
:func:`fold_seed` run it, and on the card they launch one kernel a draw site
(float32 draws) and one a fold of a seed tensor, bit for bit the same.

The samplers the JAX package keys by a plain key (``sample_laplace``,
``sample_bernoulli``, ``sample_onehot_categorical``) draw here from the same
counter hash, per sample: :func:`uniform_words_ps` gives each (seed, site,
sample_id, counter) a 24-bit word, integer arithmetic only, so the words are
equal on every device. No caller in either package uses these three; they
are public API.
"""

from __future__ import annotations

import math
import zlib
from typing import Sequence

import torch

from structured_latent_odes_tpu_torch.ops import counter_normal as _kernels

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


def _site_word(seed, site: str):
    """32-bit hash of (seed, site); _mix32 on Python ints, host-side, or on
    an int64 tensor of seeds (:func:`seed_tensor`) on its device."""
    words = (seed & _MASK32, (seed >> 32) & _MASK32, zlib.crc32(site.encode()))
    h = 0x9E3779B9
    for w in words:
        h = _mix32(h ^ w)
    return h


def fold_seed_plain(seed, *words):
    """Plain version of :func:`fold_seed`, on ints or int64 tensors."""
    for w in words:
        seed = (_site_word(seed, f"fold/{w}") << 32) | _site_word(seed, f"fold/{w}/lo")
    return seed


def fold_seed(seed, *words):
    """A 64-bit seed from ``seed`` and ``words`` (ints or strings), e.g. the
    training step and the loss, through the draws' own hash. ``seed`` is an
    int, or an int64 tensor of seeds (their bits, :func:`seed_tensor`); a
    tensor on the card is folded in one launch
    (``ops/counter_normal.py::counter_fold``)."""
    if isinstance(seed, Tensor):
        return _kernels.counter_fold(seed, *words)
    return fold_seed_plain(seed, *words)


def seed_tensor(seeds, device=None) -> Tensor:
    """64-bit seeds (Python ints, as :func:`fold_seed` returns them) as an
    int64 tensor holding the same bits, for draws of several models at once:
    an ensemble's S members draw in one set of device operations what each
    would draw alone at its own seed."""
    return torch.tensor([s - (1 << 64) if s >= 1 << 63 else s for s in seeds], dtype=torch.int64, device=device)


def uniform_words_ps(seed, site: str, sample_ids: Tensor, n: int) -> Tensor:
    """``(..., B, n)`` int64 words in [0, 2**24) on ``sample_ids``' device:
    word j of row b depends only on (seed, site, sample_ids[b], j). ``seed``
    is an int or an int64 tensor of seeds, as for :func:`standard_normal_ps`."""
    sid = sample_ids.to(torch.int64)[..., None] & _MASK32
    word = _site_word(seed, site)
    if isinstance(word, Tensor) and word.ndim:
        word = word.to(sid.device)[:, None, None]
    key = _mix32(sid ^ word)
    counter = torch.arange(n, device=sample_ids.device, dtype=torch.int64)
    return _mix32(key ^ counter) >> 8


def uniform_ps(seed, site: str, sample_ids: Tensor, event_shape: Sequence[int]) -> Tensor:
    """float64 uniforms in (0, 1) of shape ``(..., B, *event_shape)``, per
    sample as :func:`uniform_words_ps`."""
    words = uniform_words_ps(seed, site, sample_ids, math.prod(event_shape))
    return ((words.to(torch.float64) + 0.5) / 16777216.0).reshape(*words.shape[:-1], *event_shape)


def standard_normal_plain(seed, site: str, sample_ids: Tensor, event_shape: Sequence[int],
                          dtype=torch.float32) -> Tensor:
    """Plain version of :func:`standard_normal_ps`: the hash in int64 and
    Box-Muller in float64 tensor arithmetic, cast to ``dtype``."""
    n = math.prod(event_shape)
    # counters 2j and 2j+1 feed the two uniforms of element j's Box-Muller
    # pair; one tensor for both keeps the number of small launches down
    u = uniform_ps(seed, site, sample_ids, (2 * n,))
    u1, u2 = u[..., 0::2], u[..., 1::2]
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.to(dtype).reshape(*u.shape[:-1], *event_shape)


def standard_normal_ps(seed, site: str, sample_ids: Tensor, event_shape: Sequence[int],
                       dtype=torch.float32) -> Tensor:
    """Standard-normal draws of shape ``(..., B, *event_shape)`` on
    ``sample_ids``' device; row b depends only on (seed, site, sample_ids[b]).

    ``seed`` is an int, or an int64 tensor of seeds (:func:`seed_tensor`):
    of shape ``(S,)``, the draws gain a leading member axis, member s's
    equal to the draws at ``seeds[s]`` alone (``sample_ids`` ``(B,)`` or
    ``(S, B)``); 0-d, the form it has under ``torch.func.vmap``, they are
    those of that one seed. float32 draws are one kernel launch on the card
    (``ops/counter_normal.py``); other types are drawn on the CPU alone, by
    the plain version."""
    if dtype != torch.float32:
        if sample_ids.device.type != "cpu":
            raise ValueError(f"draws on {sample_ids.device} are float32 (ops/counter_normal.py), not {dtype}")
        return standard_normal_plain(seed, site, sample_ids, event_shape, dtype)
    n = math.prod(event_shape)
    if isinstance(seed, Tensor) and seed.ndim:
        eps = _kernels.counter_normal_members(seed, site, sample_ids, n)
    else:
        eps = _kernels.counter_normal(seed, site, sample_ids, n)
    return eps.reshape(*eps.shape[:-1], *event_shape)


def sample_normal_ps(seed, site: str, sample_ids: Tensor, loc: Tensor, scale: Tensor,
                     eps: Tensor | None = None) -> Tensor:
    """``loc + scale * eps`` with per-sample draws; ``loc``/``scale`` are
    ``(B, ...)``. ``eps`` replaces the generated standard-normal draws (tests
    feed both packages the same ones)."""
    if eps is None:
        eps = standard_normal_ps(seed, site, sample_ids.to(loc.device), loc.shape[1:], loc.dtype)
    return loc + scale * eps


def sample_laplace(seed, site: str, sample_ids: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    """Per-sample Laplace draws ``loc - scale * sign(u) * log1p(-2|u|)``,
    u uniform in (-1/2, 1/2); ``loc``/``scale`` are ``(B, ...)``."""
    u = uniform_ps(seed, site, sample_ids.to(loc.device), loc.shape[1:]) - 0.5
    return loc - scale * (torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))).to(loc.dtype)


def sample_bernoulli(seed, site: str, sample_ids: Tensor, probs: Tensor) -> Tensor:
    """Per-sample Bernoulli draws (0 or 1, in ``probs``' dtype); ``probs`` is
    ``(B, ...)``."""
    u = uniform_ps(seed, site, sample_ids.to(probs.device), probs.shape[1:])
    return (u < probs.to(torch.float64)).to(probs.dtype)


def sample_onehot_categorical(seed, site: str, sample_ids: Tensor, probs: Tensor) -> Tensor:
    """Per-sample one-hot categorical draws over ``probs``' trailing axis
    (clipped to [1e-7, 1] and normalized, as the JAX sampler's logits are),
    by inverting the CDF at one uniform per row; ``probs`` is ``(B, ..., K)``."""
    K = probs.shape[-1]
    p = torch.clamp(probs.to(torch.float64), _EPS, 1.0)
    cdf = torch.cumsum(p / p.sum(-1, keepdim=True), dim=-1)
    u = uniform_ps(seed, site, sample_ids.to(probs.device), (*probs.shape[1:-1], 1))
    idx = torch.clamp(torch.sum(cdf < u, dim=-1), max=K - 1)
    return torch.nn.functional.one_hot(idx, K).to(probs.dtype)
