"""One Adam update of many leaves as one launch (``csrc/multi_adam.cu``).

It replaces no TPU kernel: the JAX package's optimizer is jnp arithmetic
that XLA fuses into the step. The port's plain version,
``train/svi.py::adam_plain``, steps one leaf at a time in float32 tensor
arithmetic: about 15 elementwise kernels a leaf, which inside a replayed
dual step are some 700 (CVS) to 1,200 (a ten-member proc sweep) launch
slots of the card. The kernel computes the same float32 operations in the
same order, bit for bit on the card.

:func:`multi_adam` takes the stepped leaves as lists (params, gradients and
moments, one tensor each, any shape: a leading member axis is only more
elements), the lr (a host number or a 0-d float32 tensor on the params'
device), the update's bias corrections ``(2, L)`` with each leaf's column,
and each leaf's lr multiplier; it returns new tensors and changes none. On
the CPU it runs the plain version; on a CUDA device it launches the kernel
(:func:`plan` splits a tree of more than :data:`MAX_LEAVES` leaves over
several launches) or raises. ``launches`` counts the launches, ``leaves``
the leaf updates they made.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from structured_latent_odes_tpu_torch.ops import _build
from structured_latent_odes_tpu_torch.utils.graphs import counted

Tensor = torch.Tensor

# leaves a launch's table holds (kMaxLeaves) and elements a block (kChunk)
MAX_LEAVES = 52
CHUNK = 1024
_MAX_BLOCKS = (1 << 31) - 1

# (leaves, ptrs, counts, block_start, cols, scales, lr, corr, rs, cs, b1, omb1, b2, omb2, eps, stream)
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _svi():
    # the plain version's module imports this one (imported here: no cycle)
    from structured_latent_odes_tpu_torch.train import svi

    return svi


def plan(counts: Sequence[int]) -> List[Tuple[int, int, List[int]]]:
    """The launches of one update over leaves of ``counts`` elements: each
    ``(first, stop, block_start)``, the leaves ``first:stop`` (at most
    :data:`MAX_LEAVES`) and the prefix of their blocks of :data:`CHUNK`
    elements, ``stop - first + 1`` offsets from 0. A launch ends where the
    next leaf would pass its table or grid.x's 2^31 - 1 blocks."""
    launches, first, starts = [], 0, [0]
    for i, n in enumerate(counts):
        blocks = -(-int(n) // CHUNK)
        if blocks > _MAX_BLOCKS:
            raise ValueError(f"multi_adam: a leaf of {n} elements passes a launch's {_MAX_BLOCKS} blocks")
        if i > first and (i - first == MAX_LEAVES or starts[-1] + blocks > _MAX_BLOCKS):
            launches.append((first, i, starts))
            first, starts = i, [0]
        starts.append(starts[-1] + blocks)
    if len(counts) > first:
        launches.append((first, len(counts), starts))
    return launches


def _check(params, grads, mu, nu, lr, corrections: Tensor, cols) -> None:
    """Raise unless the kernel takes the update: every tensor float32 and
    contiguous on one CUDA device, each leaf's four of one shape, the lr a
    host number or a 0-d float32 tensor there, each column one of the
    ``(2, L)`` corrections'."""
    leaves = [*params, *grads, *mu, *nu]
    tensors = leaves + [corrections] + ([lr] if isinstance(lr, Tensor) else [])
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"multi_adam takes tensors on one device, not {sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"multi_adam takes float32 off the CPU, not {sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() for t in leaves):
        raise ValueError("multi_adam takes contiguous params, gradients and moments")
    if isinstance(lr, Tensor) and lr.ndim:
        raise ValueError(f"multi_adam takes a 0-d lr tensor, not {tuple(lr.shape)}")
    for p, g, m, n in zip(params, grads, mu, nu):
        if not p.shape == g.shape == m.shape == n.shape:
            raise ValueError(f"multi_adam: a leaf's params, gradient and moments differ in shape: "
                             f"{tuple(p.shape)}, {tuple(g.shape)}, {tuple(m.shape)}, {tuple(n.shape)}")
    if corrections.ndim != 2 or corrections.shape[0] != 2 or max(cols) >= corrections.shape[1] or min(cols) < 0:
        raise ValueError(f"multi_adam: columns {min(cols)}..{max(cols)} of corrections {tuple(corrections.shape)}")
    if device.type != "cuda":
        raise ValueError(f"multi_adam runs on cuda or cpu, not {device}")


def multi_adam(params: Sequence[Tensor], grads: Sequence[Tensor], mu: Sequence[Tensor], nu: Sequence[Tensor], lr,
               corrections: Tensor, cols: Sequence[int], scales: Sequence[float], b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """One Adam step of each leaf: ``(params', mu', nu')`` as new tensors.
    Leaf i is divided by the bias corrections ``corrections[:, cols[i]]``
    and stepped by ``lr * scales[i]``; ``lr`` is a host number or a 0-d
    tensor. The arguments and results of ``train/svi.py::adam_plain``,
    which runs for tensors on the CPU; on the card one launch for up to
    :data:`MAX_LEAVES` leaves."""
    if not params:
        return [], [], []
    on_cpu = [t.device.type == "cpu" for t in [*params, *grads, *mu, *nu, corrections]]
    if all(on_cpu) and not (isinstance(lr, Tensor) and lr.device.type != "cpu"):
        return _svi().adam_plain(params, grads, mu, nu, lr, corrections, cols, scales, b1, b2, eps)
    _check(params, grads, mu, nu, lr, corrections, cols)
    new_p, new_m, new_n = ([torch.empty_like(p) for p in params] for _ in range(3))
    f32 = np.float32
    # a host lr: each leaf's step is the float32 of the double lr * scale, as
    # ATen rounds a Python scalar; a tensor lr: the kernel multiplies it by
    # the float32 scale on the card, as the plain version's 0-d product does
    steps = [float(f32(lr * s)) for s in scales] if not isinstance(lr, Tensor) else [float(f32(s)) for s in scales]
    fn = _build.function("multi_adam", "multi_adam", _ARGTYPES)
    rs, cs = corrections.stride()
    for first, stop, starts in plan([p.numel() for p in params]):
        k = stop - first
        leaves = range(first, stop)
        ptrs = (ctypes.c_void_p * (7 * k))(*(t.data_ptr() for i in leaves for t in (
            params[i], grads[i], mu[i], nu[i], new_p[i], new_m[i], new_n[i])))
        _build.launch("multi_adam", fn, k, ptrs, (ctypes.c_longlong * k)(*(params[i].numel() for i in leaves)),
                      (ctypes.c_int * (k + 1))(*starts), (ctypes.c_int * k)(*(int(cols[i]) for i in leaves)),
                      (ctypes.c_float * k)(*(steps[i] for i in leaves)),
                      lr if isinstance(lr, Tensor) else None, corrections, rs, cs, float(f32(b1)),
                      float(f32(1.0 - b1)), float(f32(b2)), float(f32(1.0 - b2)), float(f32(eps)))
        multi_adam.launches += 1
        multi_adam.leaves += k
    return new_p, new_m, new_n


counted(multi_adam, ints=("launches", "leaves"))
