"""The draws' counter hash and Box-Muller as one launch a draw site, and the
seed folds of a seed held on the card as one launch a fold
(``csrc/counter_normal.cu``).

It replaces no TPU kernel: the JAX package draws with ``jax.random``
(threefry) inside XLA's fusions. The port's draws are a counter hash of
(seed, site, sample_id, element) feeding Box-Muller
(``prob/distributions.py``), whose plain version is int64 and float64
tensor arithmetic: on a seed held on the card (the graphed eval functions,
every member's seed in a stacked step) about 115 elementwise kernels a draw
site and about 120 a fold, each a launch slot on a few thousand elements.
The kernels compute the same words and the same float32 draws, bit for bit
on the card.

:func:`counter_normal` draws for one seed (an int, or an int64 tensor of
one seed: 0-d, the form it has under ``torch.func.vmap``) at sample ids of
any shape; :func:`counter_normal_members` for S seeds ``(S,)`` at ids
``(B,)`` (shared) or ``(S, B)``, members on ``blockIdx.y``. Under
``torch.func.vmap`` over an ensemble's members (the stacked step, the
members' val ELBO, the prior refit) :func:`counter_normal` reaches the
member-batched launch. :func:`counter_fold` folds up to :data:`MAX_FOLDS`
words into int64 seeds of any shape. The plain versions are ``prob/distributions.py``'s
(``standard_normal_plain``, ``fold_seed_plain``): the wrappers take them for
a tensor on the CPU, and on a CUDA tensor launch the kernel or raise. Each
wrapper counts its launches (``launches``). Draws carry no gradient.
"""

from __future__ import annotations

import ctypes
import zlib

import torch

from structured_latent_odes_tpu_torch.ops import _build
from structured_latent_odes_tpu_torch.ops.recurrence import _to_front
from structured_latent_odes_tpu_torch.utils.graphs import counted

Tensor = torch.Tensor

# word pairs a fold launch carries as kernel arguments (kMaxFolds)
MAX_FOLDS = 8
# threads a block (kThreads), and the most blocks grid.x and grid.y take
_THREADS = 256
_MAX_GRID_X, _MAX_GRID_Y = (1 << 31) - 1, 65535

# (seeds, seed_ms, site, sids, sid_bytes, sid_ms, out, S, B, n, stream)
_NORMAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# (seeds, out, count, crcs, n_folds, stream)
_FOLD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint), ctypes.c_int,
                  ctypes.c_void_p]


def _distributions():
    # the plain versions' module imports this one (imported here: no cycle)
    from structured_latent_odes_tpu_torch.prob import distributions

    return distributions


def _crc(site: str) -> int:
    return zlib.crc32(site.encode())


def _sids(t: Tensor) -> Tensor:
    """Sample ids as the kernel reads them: int32 or int64 (others become
    int64; the low 32 bits are what the hash reads)."""
    return t if t.dtype in (torch.int32, torch.int64) else t.to(torch.int64)


def _member_major(t: Tensor):
    """``t`` with a leading member axis: (tensor, member stride in elements),
    each member's slice contiguous; an expand keeps stride 0."""
    if t[0].is_contiguous():
        return t, t.stride(0)
    t = t.contiguous()
    return t, t[0].numel()


def check_shape(S: int, B: int, n: int) -> None:
    """Raise unless one launch draws S members' B rows of n: n below 2^31
    (a row's counters 2j and 2j + 1 then fit the hash's 32 bits), B below
    2^31, the S * B * n threads within the grid (B * n of them in grid.x's
    blocks of 256, S members on grid.y)."""
    if n >= 1 << 31 or B >= 1 << 31 or -(-B * n // _THREADS) > _MAX_GRID_X or S > _MAX_GRID_Y:
        raise ValueError(f"counter_normal: {S} members of {B} rows of {n} draws pass a launch's limits "
                         f"(n and B below 2^31, B * n in {_MAX_GRID_X} blocks of {_THREADS}, "
                         f"at most {_MAX_GRID_Y} members)")


def _normal_launch(seeds, site: str, sids: Tensor, n: int) -> Tensor:
    """The draws of ``site`` at S members' seeds: ``seeds`` an int (one
    seed, given on the host, for every member) or an int64 CUDA tensor
    ``(S,)``; ``sids`` ``(S, B)`` -> float32 ``(S, B, n)``."""
    S, B = sids.shape
    check_shape(S, B, n)
    sids, sid_ms = _member_major(_sids(sids))
    out = torch.empty((S, B, n), dtype=torch.float32, device=sids.device)
    if isinstance(seeds, Tensor):
        if seeds.dtype != torch.int64 or seeds.device != sids.device:
            raise ValueError(f"counter_normal takes int64 seeds on the ids' device {sids.device}, not "
                             f"{seeds.dtype} on {seeds.device}")
        seeds, seed_ms = _member_major(seeds)
        site_arg = _crc(site)
    else:
        site_arg, seed_ms = _distributions()._site_word(int(seeds), site), 0
    fn = _build.function("counter_normal", "counter_normal", _NORMAL_ARGTYPES)
    _build.launch("counter_normal", fn, seeds if isinstance(seeds, Tensor) else None, seed_ms, site_arg, sids,
                  sids.element_size(), sid_ms, out, S, B, n)
    return out


def _on_ids_device(seed, sids: Tensor):
    """A seed as the launch takes it: a host int stays, a CPU tensor of one
    seed becomes its int, a tensor elsewhere moves to the ids' device."""
    if not isinstance(seed, Tensor):
        return int(seed)
    if seed.device.type == "cpu" and seed.ndim == 0:
        return int(seed)
    return seed.to(sids.device)


def counter_normal_members(seeds: Tensor, site: str, sample_ids: Tensor, n: int) -> Tensor:
    """Float32 standard-normal draws ``(S, B, n)`` of ``site`` for S
    members: ``seeds`` int64 ``(S,)``, ``sample_ids`` ``(B,)`` (shared) or
    ``(S, B)``; member s's rows equal :func:`counter_normal` at ``seeds[s]``.
    One launch on the card."""
    if seeds.ndim != 1 or sample_ids.ndim not in (1, 2) or (sample_ids.ndim == 2
                                                            and sample_ids.shape[0] != seeds.shape[0]):
        raise ValueError(f"counter_normal_members: seeds {tuple(seeds.shape)}, sample ids "
                         f"{tuple(sample_ids.shape)}; expected (S,) and (B,) or (S, B)")
    if sample_ids.device.type == "cpu":
        return _distributions().standard_normal_plain(seeds, site, sample_ids, (n,))
    sids = sample_ids if sample_ids.ndim == 2 else sample_ids.expand(seeds.shape[0], *sample_ids.shape)
    return _members_launch(seeds, site, sids, n)


counted(counter_normal_members)


def _members_launch(seeds, site: str, sids: Tensor, n: int) -> Tensor:
    out = _normal_launch(_on_ids_device(seeds, sids), site, sids, n)
    counter_normal_members.launches += 1
    return out


def _normal_one(seed, site: str, sample_ids: Tensor, n: int) -> Tensor:
    seed = _on_ids_device(seed, sample_ids)
    if isinstance(seed, Tensor):
        seed = seed.reshape(1)
    out = _normal_launch(seed, site, sample_ids.reshape(1, -1), n)
    counter_normal.launches += 1
    return out.view(*sample_ids.shape, n)


class _CounterNormal(torch.autograd.Function):
    """The draws as a function that ``torch.func.vmap`` batches into one
    member-batched launch; its output carries no gradient."""

    @staticmethod
    def forward(seed, sample_ids, site, n):
        return _normal_one(seed, site, sample_ids, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, seed, sample_ids, site, n):
        seed_dim, sid_dim = in_dims[:2]
        if seed_dim is None and sid_dim is None:
            return _normal_one(seed, site, sample_ids, n), None
        S = info.batch_size
        if sid_dim is not None:
            sample_ids = sample_ids.movedim(sid_dim, 0)
            rows = sample_ids.shape[1:]
            sample_ids = sample_ids.reshape(S, -1)
        else:
            rows = sample_ids.shape
            sample_ids = sample_ids.reshape(1, -1).expand(S, -1)
        if isinstance(seed, Tensor):
            seed = _to_front(seed, seed_dim, S)
        return _members_launch(seed, site, sample_ids, n).view(S, *rows, n), 0


def counter_normal(seed, site: str, sample_ids: Tensor, n: int) -> Tensor:
    """Float32 standard-normal draws ``(*sample_ids.shape, n)`` of ``site``
    at one seed (an int, or a 0-d int64 tensor): row b depends only on
    (seed, site, sample_ids[b]). The arguments and result of
    ``prob/distributions.py::standard_normal_plain`` at event shape
    ``(n,)``; on the card one launch, member-batched under
    ``torch.func.vmap``."""
    if isinstance(seed, Tensor) and seed.ndim:
        raise ValueError(f"counter_normal takes one seed, not {tuple(seed.shape)}: counter_normal_members")
    if sample_ids.device.type == "cpu":
        return _distributions().standard_normal_plain(seed, site, sample_ids, (n,))
    return _CounterNormal.apply(seed, sample_ids, site, n)


counted(counter_normal)


def _fold_launch(seed: Tensor, crcs) -> Tensor:
    if seed.dtype != torch.int64:
        raise ValueError(f"counter_fold takes int64 seeds, not {seed.dtype}")
    src = seed.contiguous()
    out = torch.empty_like(src)
    fn = _build.function("counter_normal", "counter_fold", _FOLD_ARGTYPES)
    words = (ctypes.c_uint * (2 * len(crcs)))(*(c for pair in crcs for c in pair))
    _build.launch("counter_fold", fn, src, out, src.numel(), words, len(crcs))
    counter_fold.launches += 1
    return out


class _CounterFold(torch.autograd.Function):
    """The fold as a function that ``torch.func.vmap`` batches: elementwise,
    so a member-batched seed is one launch over all members."""

    @staticmethod
    def forward(seed, crcs):
        return _fold_launch(seed, crcs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, seed, crcs):
        return _fold_launch(seed, crcs), in_dims[0]


def counter_fold(seed: Tensor, *words) -> Tensor:
    """``prob/distributions.py::fold_seed_plain`` of an int64 tensor of seeds
    (any shape) and up to :data:`MAX_FOLDS` ``words`` (ints or strings): on
    the card one launch."""
    if len(words) > MAX_FOLDS:
        raise ValueError(f"counter_fold folds up to {MAX_FOLDS} words a call, not {len(words)}")
    if seed.device.type == "cpu":
        return _distributions().fold_seed_plain(seed, *words)
    crcs = tuple((_crc(f"fold/{w}"), _crc(f"fold/{w}/lo")) for w in words)
    if not crcs:
        return seed
    return _CounterFold.apply(seed, crcs)


counted(counter_fold)
