"""Rank grids for data, time and member parallelism (the JAX package's
``parallel/mesh.py``).

The JAX package runs one process over a ``jax.sharding.Mesh`` of devices and
lets GSPMD partition each program. The port takes PyTorch's idiom instead:
one process per rank under ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU; ``parallel/launch.py`` starts them), each rank holding its own slice of
the batch. A :class:`Grid` is the mesh's counterpart: a row-major grid of
ranks with two named axes, this rank's coordinates on it, and the process
group of the ranks that differ from it along each axis, over which the
collectives of that axis run.

- :func:`make_mesh` builds the ``(data, model)`` grid of the trainers: the
  data group sums the gradients, the model (time) group shares a solve's
  horizon (``parallel/timepar.py``). ``train/ensemble.py::member_mesh`` builds
  the ``(ens, data)`` grid of the sweeps the same way.
- :func:`shard_batch` and :func:`shard_stacked` are "this rank's slice of the
  batch axis": axis 0 of a batch, axis 1 of a stacked ``(n_batches, B, ...)``
  epoch. A batch without ``sample_id`` gets the global position of each row
  first, so that a rank's draws are the single-device run's for its rows.
- :func:`pad_batch_to_multiple` keeps the loader's pad-and-mask contract.

``replicated`` and ``batch_sharded`` have no counterpart: they name a
placement of a global array on a mesh, and here every rank holds its own
tensors. Parameters are replicated because every rank starts from the same
seed and applies the same summed update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Grid:
    """A ``shape[0] x shape[1]`` grid of ranks, ``ranks`` in row-major order
    (rank ``ranks[i0 * shape[1] + i1]`` sits at ``(i0, i1)``), seen from one
    of them: ``coords`` is its place and ``groups[axis]`` the process group
    of the ranks that share its other coordinate."""

    axis_names: Tuple[str, str]
    shape: Tuple[int, int]
    ranks: Tuple[int, ...]
    coords: Tuple[int, int]
    groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1]


def make_grid(shape: Tuple[int, int], axis_names: Tuple[str, str], *, ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None) -> Optional[Grid]:
    """The grid of ``ranks`` (default: the whole world, which must hold
    exactly ``shape[0] * shape[1]`` ranks) with one process group per row and
    per column, created with ``backend`` (default: the world's).

    Every rank of the world must call this with the same arguments, in the
    same order as its other calls that create groups: ``dist.new_group`` is
    collective over the world even for a rank outside the new group. Returns
    None on a rank outside ``ranks``."""
    n0, n1 = int(shape[0]), int(shape[1])
    if n0 < 1 or n1 < 1:
        raise ValueError(f"grid shape {shape} must be positive")
    ranks = tuple(range(dist.get_world_size())) if ranks is None else tuple(int(r) for r in ranks)
    if len(ranks) != n0 * n1:
        raise ValueError(f"a {n0} x {n1} grid needs {n0 * n1} ranks, got {len(ranks)}")
    rows = [[ranks[i0 * n1 + i1] for i0 in range(n0)] for i1 in range(n1)]  # along axis 0
    cols = [[ranks[i0 * n1 + i1] for i1 in range(n1)] for i0 in range(n0)]  # along axis 1
    me = dist.get_rank()
    groups = {}
    for axis, members in ((axis_names[0], rows), (axis_names[1], cols)):
        for m in members:
            g = dist.new_group(m, backend=backend)
            if me in m:
                groups[axis] = g
    if me not in ranks:
        return None
    pos = ranks.index(me)
    return Grid(tuple(axis_names), (n0, n1), ranks, (pos // n1, pos % n1), groups)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *, ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None) -> Optional[Grid]:
    """The ``(data, model)`` grid: ``n_data`` batch shards by ``n_model``
    time shards (default ``n_data``: the world over ``n_model``), as the JAX
    package's ``make_mesh``. See :func:`make_grid`."""
    if n_data is None:
        n_data = (dist.get_world_size() if ranks is None else len(ranks)) // n_model
    return make_grid((n_data, n_model), ("data", "model"), ranks=ranks, backend=backend)


def _rows(v, lo: int, hi: int, axis: int):
    index = (slice(None),) * axis + (slice(lo, hi),)
    if isinstance(v, torch.Tensor):
        return v[index].contiguous()
    return np.ascontiguousarray(np.asarray(v)[index])


def _slice_axis(grid: Grid, batch, axis: int, along: str):
    n, i = grid.size(along), grid.index(along)
    lead = batch["observations"].shape[:axis + 1]
    width = lead[axis]
    if width % n:
        raise ValueError(f"batch axis of {width} rows does not divide over {n} {along!r} ranks")
    if "sample_id" not in batch:
        obs = batch["observations"]
        if isinstance(obs, torch.Tensor):
            ids = torch.arange(width, dtype=torch.int32, device=obs.device).expand(lead)
        else:
            ids = np.broadcast_to(np.arange(width, dtype=np.int32), lead)
        batch = dict(batch, sample_id=ids)
    lo, hi = i * width // n, (i + 1) * width // n
    return {k: _rows(v, lo, hi, axis) if np.ndim(v) > axis else v for k, v in batch.items()}


def shard_batch(grid: Grid, batch, axis: str = "data"):
    """This rank's rows of a batch (numpy arrays or tensors): its slice of
    axis 0 along the grid's ``axis``; scalars (an ``aux_mult`` override)
    pass whole."""
    return _slice_axis(grid, batch, 0, axis)


def shard_stacked(grid: Grid, batches, axis: str = "data"):
    """This rank's rows of a stacked epoch ``(n_batches, B, ...)``: its slice
    of the batch axis (axis 1); per-step values ``(n_batches,)`` pass
    whole."""
    return _slice_axis(grid, batches, 1, axis)


def pad_batch_to_multiple(batch, multiple: int):
    """Pad a batch so its leading axis divides over ``multiple`` ranks (the
    loader's padding and mask contract)."""
    from structured_latent_odes_tpu_torch.data.loader import pad_to

    n = batch["observations"].shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n and "mask" in batch:
        return batch
    return pad_to(batch, target)


def all_reduce_tree(tree, group):
    """The sum over ``group`` of every tensor leaf of a tree (nested dicts,
    lists, tuples), in one collective: the leaves are flattened into one
    buffer, so they must share one dtype (a mixed tree would be promoted,
    an integer count rounded): it raises TypeError otherwise. Returns the
    tree with the summed leaves (lists for tuples)."""
    leaves = tree_leaves(tree)
    dtypes = {t.dtype for t in leaves}
    if len(dtypes) > 1:
        raise TypeError(f"all_reduce_tree sums leaves of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return tree_unflatten(tree, out)


def data_reduce(grid: Optional[Grid]):
    """The sum over the grid's ``data`` group (:func:`all_reduce_tree`) as a
    one-argument function, or None where there is no grid: the ``reduce``
    hook of ``train/svi.py``'s steps and eval epoch. It names the group's
    ``backend`` and says whether a CUDA graph can capture it
    (``capturable``, read by ``svi.epoch_dispatch``): an NCCL sum is a kernel
    on the card, which a graph records and replays; a gloo sum runs on the
    host. Inside a capture the flat buffer comes from the graph's pool."""
    if grid is None:
        return None
    group = grid.group("data")

    def reduce(tree):
        return all_reduce_tree(tree, group)

    reduce.backend = dist.get_backend(group)
    reduce.capturable = reduce.backend == "nccl"
    return reduce
