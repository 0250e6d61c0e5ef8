"""A step captured once as a CUDA graph and replayed.

PyTorch launches every operation from the host, and a dual step of the
port's models is some 1,600 small operations: the host, not the card, sets
its pace. A CUDA graph records the operations once and launches them all in
one call, the counterpart of the JAX package's ``jax.jit``. ``train/svi.py``
captures the training step, the eval epochs and the eval functions (which
serving's predict functions are) with :class:`Graph`.

A captured body must read and write only tensors that outlive it (static
buffers that the caller fills before each call) and must not read a value on
the host: a graph replays the operations with the addresses and the Python
numbers of the capture. A body that refers to the object holding its graph
makes a reference cycle, which only the garbage collector frees: an evicted
graph then keeps its pool until a collection.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable

import torch

from structured_latent_odes_tpu_torch.utils.profiling import span
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves


def _counted():
    """The kernel wrappers, whose launch counters (``launches``, ``leaves``
    where a wrapper counts what its launches covered, and ``variants`` by
    (method, H, D) or, for the conv encoder's, by shape, where a wrapper
    keeps them) a graph keeps true: a wrapper's Python runs once, at the
    capture, so each replay adds what the capture counted. The shared Adam's
    count of the leaf updates asked for (``svi.shared_adam_update.leaves``)
    is kept alike. (Imported here: the solvers, which the ops import, replay
    graphs of their own.)"""
    from structured_latent_odes_tpu_torch.ops import conv_encoder, counter_normal, fused_step, multi_adam, recurrence
    from structured_latent_odes_tpu_torch.train import svi

    return (recurrence.affine_scan_fwd, recurrence.affine_scan_bwd, fused_step.fused_semilinear_fwd,
            fused_step.fused_semilinear_fwd_members, fused_step.fused_semilinear_bwd,
            fused_step.fused_semilinear_bwd_members, conv_encoder.conv_pool_fwd,
            conv_encoder.conv_pool_fwd_members, conv_encoder.conv_pool_wgrad, conv_encoder.conv_pool_wgrad_members,
            counter_normal.counter_normal, counter_normal.counter_normal_members, counter_normal.counter_fold,
            multi_adam.multi_adam, svi.shared_adam_update)


_INTS = ("launches", "leaves")


def _counts():
    return [({k: getattr(w, k) for k in _INTS if hasattr(w, k)}, collections.Counter(getattr(w, "variants", ())))
            for w in _counted()]


def _add(counts, sign: int = 1) -> None:
    for w, (ints, variants) in zip(_counted(), counts):
        for k, n in ints.items():
            setattr(w, k, getattr(w, k) + sign * n)
        for key, m in variants.items():
            w.variants[key] += sign * m


class Graph:
    """``body()``, which returns a tree of tensors or None, run on a CUDA
    device as one graph: the first ``warm`` calls run it eagerly on a side
    stream (they absorb the kernels' first-use builds, cuBLAS's handles and
    the kernels' shared-memory attributes, which a capture may not make),
    the next call captures it and every call replays it. A replay returns the
    tensors that the capture returned, overwritten in place, and adds the
    launches that the capture counted to the kernel wrappers' counters, so
    the counts are the eager run's. A failed capture raises.

    ``plain=True`` is the plain version: every call runs ``body()`` eagerly
    on the same buffers, on any device (the CPU tests). Without it the
    device must be a CUDA device.

    Each eager first call, the capture and each replay is a span
    (``utils/profiling.py``): ``graph.warm``, ``graph.capture``,
    ``graph.replay``; the plain version records none. ``Graph.replays``
    counts the replays of every graph, as the kernel wrappers count their
    launches."""

    replays = 0

    def __init__(self, body: Callable, device, warm: int = 1, plain: bool = False):
        device = torch.device(device)
        if not plain and device.type != "cuda":
            raise ValueError(f"a CUDA graph captures work on a CUDA device, not {device}")
        self.body, self.device, self.warm, self.plain = body, device, warm, plain
        self.graph = self.out = self.captured = None

    def __call__(self):
        if self.plain:
            return self.body()
        if self.graph is not None:
            with span("graph.replay"):
                self.graph.replay()
                _add(self.captured)
                Graph.replays += 1
                return self.out
        if self.warm > 0:
            with span("graph.warm"):
                self.warm -= 1
                main = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    out = self.body()
                main.wait_stream(side)
                for t in tree_leaves(out):
                    if t is not None:
                        t.record_stream(main)  # read on the main stream, freed on the side one
                return out
        with span("graph.capture"):
            before = _counts()
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            # no garbage collection inside the capture: a dead cycle that holds a
            # graph would destroy it there, which a capture forbids
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    out = self.body()
            finally:
                if collecting:
                    gc.enable()
            after = _counts()
            self.captured = [({k: n[k] - n0[k] for k in n}, v - v0) for (n, v), (n0, v0) in zip(after, before)]
            _add(self.captured, -1)  # nothing ran
            self.graph, self.out = graph, out
        return self()
