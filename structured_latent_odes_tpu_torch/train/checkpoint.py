"""Checkpoints in the JAX package's format (``train/checkpoint.py``), without
JAX: one ``.npz`` of leaves ``leaf_0 .. leaf_{n-1}`` in JAX's flatten order
(dict keys sorted, lists by index) plus a ``.json`` sidecar with each leaf's
key path (``['decoder']/['ode']/['dyn_hidden']/['W']``, ``[0]`` for a list
item), the tree structure as JAX prints it, and metadata.

A checkpoint written by either package restores in the other. Trees here are
in the JAX layout (nested dicts and lists of numpy arrays or tensors);
``interop.py`` converts them to and from the port's parameters. A Python int
leaf (an Adam step count, a seed, a step) is stored as an int64 array and
restored as an int where ``like`` holds an int.

:func:`host_rng_tree` and :func:`apply_host_rng_tree` snapshot numpy's
MT19937 state as arrays, so that a resumed run shuffles as the uninterrupted
one would. The JAX package's orbax variant (``save_orbax``,
``restore_orbax``) has no counterpart: this format is the only one.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np

from structured_latent_odes_tpu_torch.utils.tree import tree_unflatten


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
        return out
    return [(prefix, tree)]


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _to_numpy(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, dtype=np.int64)
    return np.asarray(x)


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **{f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)})
    side = {
        "paths": [p for p, _ in flat],
        "treedef": f"PyTreeDef({_structure(tree)})",
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (leaves need only a shape).

    Checked structurally as the JAX package checks it: the stored key paths
    are compared with ``like``'s and the first differing path is named in the
    error; then shapes leaf by leaf. Returns numpy leaves, and Python ints
    where ``like`` holds ints.
    """
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    ref = _flatten(like)
    ref_paths = [p for p, _ in ref]
    try:
        with open(path + ".json") as f:
            stored_paths = json.load(f).get("paths")
    except FileNotFoundError:
        stored_paths = None
    if stored_paths is not None:
        for i, (sp, rp) in enumerate(zip(stored_paths, ref_paths)):
            if sp != rp:
                raise ValueError(
                    f"checkpoint structure mismatch at leaf {i}: stored path "
                    f"{sp!r} != expected {rp!r}"
                )
        if len(stored_paths) > len(ref_paths):
            raise ValueError(
                f"checkpoint has {len(stored_paths)} leaves, expected "
                f"{len(ref_paths)}; first unexpected stored path: "
                f"{stored_paths[len(ref_paths)]!r}"
            )
        if len(stored_paths) < len(ref_paths):
            raise ValueError(
                f"checkpoint has {len(stored_paths)} leaves, expected "
                f"{len(ref_paths)}; first missing path: "
                f"{ref_paths[len(stored_paths)]!r}"
            )
    if len(leaves) != len(ref):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(ref)}")
    for i, (a, (p, b)) in enumerate(zip(leaves, ref)):
        if tuple(a.shape) != tuple(np.shape(b)):
            raise ValueError(f"leaf {i} ({p}) shape {a.shape} != expected {tuple(np.shape(b))}")
    return tree_unflatten(like, [int(a) if isinstance(b, int) else a for a, (_, b) in zip(leaves, ref)])


def host_rng_tree(rng: np.random.RandomState) -> dict:
    """A numpy RandomState's state as plain arrays (checkpointable)."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    if kind != "MT19937":
        raise ValueError(f"cannot snapshot a {kind} generator")
    return {
        "mt_keys": np.asarray(keys, dtype=np.uint32),
        "pos": np.asarray(pos, dtype=np.int64),
        "has_gauss": np.asarray(has_gauss, dtype=np.int64),
        "cached_gaussian": np.asarray(cached, dtype=np.float64),
    }


def apply_host_rng_tree(rng: np.random.RandomState, tree: dict) -> None:
    rng.set_state((
        "MT19937",
        np.asarray(tree["mt_keys"], dtype=np.uint32),
        int(tree["pos"]),
        int(tree["has_gauss"]),
        float(tree["cached_gaussian"]),
    ))


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f).get("metadata", {})
