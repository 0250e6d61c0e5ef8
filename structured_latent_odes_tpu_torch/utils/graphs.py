"""Work captured once as a CUDA graph and replayed.

PyTorch launches every operation from the host, and a dual step of the
port's models is some 1,600 small operations: the host, not the card, sets
its pace. A CUDA graph records the operations once and launches them all in
one call, the counterpart of the JAX package's ``jax.jit``.

:class:`Graph` captures and replays a body. :class:`Replayed` runs a body
``body(inputs)`` as a graph over buffers, clones of an example of its
inputs: every captured path of the port (the training step, the eval
epochs, the eval functions that serving's predict functions are, the
sweep's stacked step, val ELBO and prior refit, an adaptive solver's loop
trip) is one. :func:`replayed` memoizes the paths' graphs in one
process-wide memo, :data:`GRAPHS`; a solver keeps its trip's itself.

A captured body must read and write only tensors that outlive it (static
buffers that the caller fills before each call) and must not read a value on
the host: a graph replays the operations with the addresses and the Python
numbers of the capture. A body that refers to the object holding its graph
makes a reference cycle, which only the garbage collector frees: an evicted
graph then keeps its pool until a collection.

A kernel wrapper registers its launch counters with :func:`counted`, where
it is defined; a replay adds the launches that its capture counted.
"""

from __future__ import annotations

import collections
import gc
import weakref
from typing import Callable, Tuple

import torch

from structured_latent_odes_tpu_torch.utils.memo import BoundedMemo
from structured_latent_odes_tpu_torch.utils.profiling import span
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map

# the wrappers whose counters a graph keeps true, each with its int counters
_COUNTED: "weakref.WeakKeyDictionary[Callable, Tuple[str, ...]]" = weakref.WeakKeyDictionary()


def counted(fn: Callable, ints: Tuple[str, ...] = ("launches",), variants: bool = False) -> Callable:
    """Register the kernel wrapper ``fn``'s counters, each set to 0: the
    ints ``ints`` (``launches``, and ``leaves`` where a wrapper counts what
    its launches covered) and, with ``variants``, a ``collections.Counter``
    of launches by variant (:func:`count`). A wrapper's Python runs once, at
    a graph's capture, so each replay adds what the capture counted."""
    for k in ints:
        setattr(fn, k, 0)
    if variants:
        fn.variants = collections.Counter()
    _COUNTED[fn] = tuple(ints)
    return fn


def count(fn: Callable, variant) -> None:
    """One launch of the kernel of ``fn`` (registered with ``variants``):
    its count and its ``variant``'s."""
    fn.launches += 1
    fn.variants[variant] += 1


def _counts() -> dict:
    """Every registered counter by (wrapper, name), and every variant's by
    (wrapper, 'variants', variant)."""
    out = {(fn, k): getattr(fn, k) for fn, ints in _COUNTED.items() for k in ints}
    out.update(((fn, "variants", v), n) for fn in _COUNTED for v, n in getattr(fn, "variants", {}).items())
    return out


def _add(counts: dict, sign: int = 1) -> None:
    for (fn, k, *variant), n in counts.items():
        if variant:
            fn.variants[variant[0]] += sign * n
        else:
            setattr(fn, k, getattr(fn, k) + sign * n)


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
            self.captured = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
            _add(self.captured, -1)  # nothing ran
            self.graph, self.out = graph, out
        return self()


def _pairs(dst, src, out: list) -> list:
    """(buffer, value) for each leaf of the tree ``src`` in its place in the
    congruent tree ``dst`` (dict keys matched by name), skipping a subtree of
    ``src`` that is ``dst``'s own."""
    if dst is src:
        return out
    if isinstance(dst, dict):
        for k in dst:
            _pairs(dst[k], src[k], out)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _pairs(d, s, out)
    else:
        out.append((dst, src))
    return out


def copy_in(dst, src) -> None:
    """Each tensor of the tree ``src`` into its buffer in ``dst`` (skipping
    a buffer given itself) as multi-tensor copies: a graph's params are some
    40 small leaves, and a launch for each cost the host more than the
    replay (and, as a captured step's write-back, the card a node each). One
    copy a dtype, and one for the pairs whose strides differ: a multi-tensor
    copy takes its one-launch route only over one source dtype and equal
    strides, and copies tensor by tensor otherwise."""
    groups: dict = {}
    for d, s in _pairs(dst, src, []):
        groups.setdefault((s.dtype, d.stride() == s.stride()), []).append((d, s))
    for pairs in groups.values():
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class Replayed:
    """``body(inputs)`` over buffers: clones of ``example``, a tree of
    tensors shaped as the inputs of every call, run by a :class:`Graph`
    (``warm`` and ``plain`` as there). A call copies the inputs that are not
    already the buffers into them (:func:`copy_in`) and returns the body's
    outputs, which are the graph's own: its next call overwrites them. The
    buffers are plain tensors even where the caller runs in inference mode."""

    def __init__(self, body: Callable, example, device, plain: bool = False, warm: int = 1):
        with torch.inference_mode(False):
            self.inputs = inputs = tree_map(lambda t: t.detach().clone(), example)
        self.graph = Graph(lambda: body(inputs), device, warm=warm, plain=plain)  # no reference to self

    def __call__(self, inputs):
        with torch.inference_mode(False):
            copy_in(self.inputs, inputs)
            return self.graph()


def signature(tree):
    """A tree's structure, shapes and dtypes: what tells apart the graphs
    of one body."""
    if isinstance(tree, dict):
        return tuple((k, signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return tuple(tree.shape), tree.dtype


# every memoized graph of the process. Its size is the sum of the six memos of
# eight that it replaced (the training step's, the eval epochs', the eval
# functions', the sweep's step, val ELBO and refit), so that no process that
# kept a graph in one of those evicts it here: a test or chip_smoke.py's
# phases walk many recipes, each graph pinning a pool on the card.
GRAPHS = BoundedMemo(48)


def replayed(key, body: Callable, example, device, plain: bool = False) -> Replayed:
    """The :class:`Replayed` of ``key`` in :data:`GRAPHS`, made of ``body``
    and ``example`` where the memo lacks it. ``key`` starts with the name of
    the captured path that asks (:func:`graphs_of`)."""
    graph = GRAPHS.get(key)
    if graph is None:
        graph = GRAPHS[key] = Replayed(body, example, device, plain)
    return graph


def graphs_of(path: str) -> dict:
    """The graphs in :data:`GRAPHS` that the path ``path`` asked for, by
    key."""
    return {k: g for k, g in GRAPHS._d.items() if k[0] == path}
